"""Bulk-inference CLI: a directory (or glob) of images -> predictions.
Mirrors ``dad3dheads_tpu/cli/predict.py``.

Images stream in chunks through ``FaceMeshPredictor.predict_images`` (cv2
resize on host threads) and the results land as

  - ``jsonl`` (default): one line per image with the 68 points and the
    413-dim 3DMM vector;
  - ``obj``: one mesh file per image (1-indexed faces);
  - ``json``: one FLAME-parameter json per image.

  python -m dad3dheads_tpu_torch.cli.predict --input imgs/ --output out/ \\
      [--format jsonl|obj|json] [--batch 32] [--workers 8] [--device cuda] \\
      [--checkpoint ck.msgpack] [--resize-mode ...] [--bboxes boxes.json] \\
      [--device-preprocess] [--quant-amax amax.npz]

With ``--bboxes`` (a json mapping image filename -> [x0, y0, x1, y1]) or
``--device-preprocess``, frames go through ``FaceMeshPredictor.predict_frames``:
crop, resize and normalize run on the device, and "points" are reported in
full-frame coordinates. ``--quant-amax`` (an amax table from
``cli.calibrate_int8``) serves the resnet50 through the int8 mirror.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import sys
import time
from typing import List

logger = logging.getLogger(__name__)

_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def list_images(spec: str) -> List[str]:
    """Expand a directory, glob, or single file into image paths."""
    if os.path.isdir(spec):
        paths = [
            os.path.join(root, f)
            for root, _, files in os.walk(spec)
            for f in files
            if f.lower().endswith(_EXTS)
        ]
    elif os.path.isfile(spec):
        # an existing file wins even if its name contains glob chars ([ ] ?)
        paths = [spec]
    elif any(ch in spec for ch in "*?["):
        paths = [p for p in glob.glob(spec, recursive=True) if p.lower().endswith(_EXTS)]
    else:
        paths = []
    return sorted(paths)


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--input", required=True, help="image dir, glob, or file")
    ap.add_argument("--output", required=True, help="output directory")
    ap.add_argument("--format", default="jsonl", choices=("jsonl", "obj", "json"))
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--workers", type=int, default=8, help="host decode threads")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument(
        "--allow-random-weights",
        action="store_true",
        help="run with randomly initialized weights when no checkpoint is "
        "found (outputs will be garbage; for smoke testing only)",
    )
    ap.add_argument("--quant-amax", default=None, help="amax .npz: int8 inference (cli.calibrate_int8 writes one)")
    ap.add_argument("--resize-mode", default="longest_max_size", choices=("longest_max_size", "resize"))
    ap.add_argument("--img-size", type=int, default=256)
    ap.add_argument("--dtype", default="bf16", help="the network trunk's dtype: bf16 or float32")
    ap.add_argument("--chunk", type=int, default=256, help="images decoded/held in host memory at once")
    ap.add_argument(
        "--bboxes", default=None,
        help="json file mapping image filename (basename or path as given) "
        "-> [x0, y0, x1, y1] face crop; implies --device-preprocess",
    )
    ap.add_argument(
        "--device-preprocess", action="store_true",
        help="crop/resize/normalize on the device (predict_frames) instead of "
        "host cv2; points are reported in full-frame coordinates",
    )
    ap.add_argument("--device", default="cuda", help="torch device the predictor runs on")
    args = ap.parse_args(argv)

    paths = list_images(args.input)
    if not paths:
        raise SystemExit(f"no images under {args.input!r}")
    os.makedirs(args.output, exist_ok=True)

    import numpy as np

    from ..api.predictor import FaceMeshPredictor
    from ..data.io import read_as_rgb

    config = {
        "img_size": args.img_size,
        "resize_mode": args.resize_mode,
        "model": {"backbone": "resnet50", "dtype": args.dtype},
    }
    if args.quant_amax:
        config["quant_amax"] = args.quant_amax
    predictor = FaceMeshPredictor(
        config,
        checkpoint_path=args.checkpoint,
        device=args.device,
        require_weights=not args.allow_random_weights,
    )

    bbox_map = None
    if args.bboxes:
        with open(args.bboxes) as f:
            bbox_map = json.load(f)
        args.device_preprocess = True

    def lookup_bbox(path, image):
        if bbox_map is not None:
            bb = bbox_map.get(path) or bbox_map.get(os.path.basename(path))
            if bb is not None:
                return [int(v) for v in bb]
        return [0, 0, image.shape[1], image.shape[0]]

    # stream in chunks: decoded images and results for at most --chunk images
    # live on the host at once, and outputs flush per chunk
    t0 = time.time()
    if args.format == "jsonl":
        out_path = os.path.join(args.output, "predictions.jsonl")
        sink = open(out_path, "w")
    else:
        out_path = args.output
        sink = None
    try:
        for lo in range(0, len(paths), args.chunk):
            part = paths[lo : lo + args.chunk]
            images = [read_as_rgb(p) for p in part]
            if args.device_preprocess:
                preds = predictor.predict_frames(
                    images,
                    bboxes=[lookup_bbox(p, im) for p, im in zip(part, images)],
                    batch_size=args.batch,
                    with_mesh=args.format != "jsonl",
                )
            else:
                preds = predictor.predict_images(
                    images, batch_size=args.batch, num_workers=args.workers,
                    with_mesh=args.format != "jsonl",  # jsonl needs no mesh
                )
            if args.format == "jsonl":
                for p, pred in zip(part, preds):
                    sink.write(
                        json.dumps(
                            {
                                "file": p,
                                "points": np.asarray(pred["points"]).tolist(),
                                "3dmm_params": np.asarray(pred["3dmm_params"][0]).tolist(),
                            }
                        )
                        + "\n"
                    )
            elif args.format == "obj":
                from ..api.demo_utils import MeshSaver, get_mesh

                saver = MeshSaver()
                for p, pred in zip(part, preds):
                    stem = os.path.splitext(os.path.basename(p))[0]
                    saver(get_mesh(pred, None), os.path.join(args.output, f"{stem}.obj"))
            else:  # json: FLAME params per image
                from ..api.demo_utils import JsonSaver, get_flame_params

                saver = JsonSaver()
                for p, pred in zip(part, preds):
                    stem = os.path.splitext(os.path.basename(p))[0]
                    saver(get_flame_params(pred, None), os.path.join(args.output, f"{stem}.json"))
    finally:
        if sink is not None:
            sink.close()
    dt = time.time() - t0

    logger.info(
        "predicted %d images in %.1fs (%.1f img/s) -> %s",
        len(paths), dt, len(paths) / max(dt, 1e-9), out_path,
    )
    print(out_path)
    return out_path


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(0 if main() else 1)
