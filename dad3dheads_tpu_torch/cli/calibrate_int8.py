"""Calibrate the int8 activation scales of the resnet50 DAD-3DNet. The port's
copy of ``tools/calibrate_int8.py``:

  python -m dad3dheads_tpu_torch.cli.calibrate_int8 --checkpoint ck.msgpack --out amax.npz \\
      [--images DAD-3DHeadsDataset/val] [--num 64] [--batch 16] [--img-size 256] [--dtype bf16] \\
      [--device cuda]

Runs ``--num`` images through the float mirror (``models/quantized.py``,
calib mode) in the model's dtype, recording the largest |activation| at every
quantization site, and writes the table as an ``.npz`` that
``FaceMeshPredictor`` takes as ``quant_amax`` (config key, ``cli.predict
--quant-amax``, ``cli.export --quant-amax``); the JAX package reads it too.
The images are the ``.png``/``.jpg`` files under ``--images`` (resized and
normalized as the predictor's ``__call__`` does), or, without it, the port's
synthetic training batches (``data/synthetic.py``). Without a checkpoint the
weights are random (with a warning), as in the predictor.
"""

from __future__ import annotations

import argparse
import glob
import os

_DTYPES = {"bf16": "bfloat16", "bfloat16": "bfloat16", "fp32": "float32", "float32": "float32"}


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--images", default=None, help="directory of calibration images")
    ap.add_argument("--num", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--img-size", type=int, default=256)
    ap.add_argument("--dtype", default="bf16", choices=sorted(_DTYPES))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..api.predictor import FaceMeshPredictor
    from ..models.quantized import calibrate, save_amax

    predictor = FaceMeshPredictor(
        {"img_size": args.img_size, "model": {"backbone": "resnet50", "dtype": _DTYPES[args.dtype]}},
        checkpoint_path=args.checkpoint,
        device=args.device,
    )
    if args.images:
        from ..data.io import read_as_rgb
        from ..ops.preprocess import preprocess_image_np

        paths = sorted(
            p for ext in ("*.png", "*.jpg", "*.jpeg")
            for p in glob.glob(os.path.join(args.images, "**", ext), recursive=True)
        )[: args.num]
        if not paths:
            raise SystemExit(f"no images under {args.images}")
        images = [preprocess_image_np(read_as_rgb(p), args.img_size)[0] for p in paths]
        batches = [np.stack(images[i : i + args.batch]) for i in range(0, len(images), args.batch)]
    else:
        from ..constants import INPUT_IMAGE_KEY
        from ..core.landmarks import LandmarkEmbedding
        from ..data.synthetic import synthetic_batch

        emb = LandmarkEmbedding.load(device=predictor.device)
        batches = [
            synthetic_batch(torch.Generator(predictor.device).manual_seed(i), predictor.flame, emb, args.batch,
                            args.img_size)[INPUT_IMAGE_KEY]
            for i in range(max(1, args.num // args.batch))
        ]
    amax = calibrate(predictor.model, batches)
    save_amax(amax, args.out)
    count = sum(len(b) for b in batches)
    print(f"calibrated {len(amax)} sites over {count} images -> {args.out}")
    return args.out


if __name__ == "__main__":
    main()
