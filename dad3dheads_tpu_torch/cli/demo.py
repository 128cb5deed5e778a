"""Demo CLI: one image -> one of 10 output types. Mirrors
``dad3dheads_tpu/cli/demo.py``.

  python -m dad3dheads_tpu_torch.cli.demo --input images/head.jpg \\
      --out outputs --type pncc [--device cuda]
"""

from __future__ import annotations

import argparse
import functools
import os
from typing import Any, Callable, NamedTuple, Optional

from ..api.demo_utils import (
    ImageSaver,
    JsonSaver,
    MeshSaver,
    draw_3d_landmarks,
    draw_landmarks,
    draw_mesh,
    draw_pose,
    get_flame_params,
    get_mesh,
    get_output_path,
    get_pncc,
    get_uv_texture,
)


class DemoFuncs(NamedTuple):
    processor: Callable
    saver: Any


demo_funcs = {
    "68_landmarks": DemoFuncs(draw_landmarks, ImageSaver),
    "191_landmarks": DemoFuncs(functools.partial(draw_3d_landmarks, subset="191"), ImageSaver),
    "445_landmarks": DemoFuncs(functools.partial(draw_3d_landmarks, subset="445"), ImageSaver),
    "head_mesh": DemoFuncs(functools.partial(draw_mesh, subset="head"), ImageSaver),
    "face_mesh": DemoFuncs(functools.partial(draw_mesh, subset="face"), ImageSaver),
    "pose": DemoFuncs(draw_pose, ImageSaver),
    "uv_texture": DemoFuncs(get_uv_texture, ImageSaver),
    "pncc": DemoFuncs(get_pncc, ImageSaver),
    "3d_mesh": DemoFuncs(get_mesh, MeshSaver),
    "flame_params": DemoFuncs(get_flame_params, JsonSaver),
}
_RENDERED = ("uv_texture", "pncc")  # processors that rasterize on the device


def demo(
    input_image_path: str,
    outputs_folder: str = "outputs",
    type_of_output: str = "68_landmarks",
    checkpoint_path: Optional[str] = None,
    allow_random_weights: bool = False,
    device: str = "cuda",
) -> str:
    if type_of_output not in demo_funcs:
        raise KeyError(f"unknown output type {type_of_output!r}; options: {sorted(demo_funcs)}")
    os.makedirs(outputs_folder, exist_ok=True)

    from ..api.predictor import FaceMeshPredictor
    from ..data.io import read_as_rgb

    image = read_as_rgb(input_image_path)
    predictor = FaceMeshPredictor.dad_3dnet(
        checkpoint_path=checkpoint_path, require_weights=not allow_random_weights, device=device
    )
    predictions = predictor(image)

    funcs = demo_funcs[type_of_output]
    kwargs = {"device": device} if type_of_output in _RENDERED else {}
    result = funcs.processor(predictions, image, **kwargs)
    saver = funcs.saver()
    output_path = get_output_path(input_image_path, outputs_folder, type_of_output, saver.extension)
    saver(result, output_path)
    return output_path


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--input", required=True, help="input image path")
    ap.add_argument("--out", default="outputs", help="output folder")
    ap.add_argument("--type", default="68_landmarks", choices=sorted(demo_funcs), help="output type")
    ap.add_argument("--checkpoint", default=None, help="model checkpoint (msgpack)")
    ap.add_argument(
        "--allow-random-weights",
        action="store_true",
        help="run with randomly initialized weights when no checkpoint is "
        "found (outputs will be garbage; for smoke testing only)",
    )
    ap.add_argument("--device", default="cuda", help="torch device the predictor and renderers run on")
    args = ap.parse_args(argv)
    path = demo(args.input, args.out, args.type, args.checkpoint, args.allow_random_weights, args.device)
    print(path)
    return path


if __name__ == "__main__":
    main()
