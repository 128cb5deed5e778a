"""Export a checkpoint as the port's self-contained deployment artifact. Port
of ``tools/export_model.py``:

  python -m dad3dheads_tpu_torch.cli.export --checkpoint exp/checkpoints/dad_3dnet.msgpack \\
      --out dad_3dnet.aot.zip [--img-size 256] [--backbone resnet50] [--num-filters 256] \\
      [--dtype fp32] [--device cuda] [--devices cuda cpu] [--quant-amax amax.npz]

``--device`` is where the network is loaded and traced (the card by
default); ``--devices`` are the devices the artifact carries programs for
(the card and the CPU on a machine with a card, the CPU alone without).
Serve the file with ``dad3dheads_tpu_torch.api.ExportedFaceMeshPredictor(path,
device=...)``: no model code or FLAME assets are needed there.
``--quant-amax`` (an amax table from ``cli.calibrate_int8``) writes the int8
artifact of a resnet50 checkpoint. The artifact holds the resnet50 and
mobilenet_w1 DAD-3DNets; a swinv2_b_w16 checkpoint is refused
(:func:`check_exportable`) and served through ``FaceMeshPredictor``.
"""

from __future__ import annotations

import argparse
import os

EXPORTABLE = ("resnet50", "mobilenet_w1")


def check_exportable(backbone: str) -> None:
    """Raises for a backbone whose network the artifact does not hold."""
    if backbone not in EXPORTABLE:
        raise ValueError(f"the deployment artifact holds a resnet50 or mobilenet_w1 DAD-3DNet; its export is "
                         f"not built for {backbone!r}: serve it with FaceMeshPredictor")


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", required=True, help="JAX-package .msgpack predictor checkpoint")
    ap.add_argument("--out", required=True, help="output artifact path (suffix .aot.zip)")
    ap.add_argument("--img-size", type=int, default=256)
    ap.add_argument("--stride", type=int, default=4)
    ap.add_argument("--backbone", default="resnet50")
    ap.add_argument("--num-filters", type=int, default=256)
    ap.add_argument("--dtype", default="fp32", choices=["fp32", "bf16"])
    ap.add_argument("--resize-mode", default="longest_max_size", choices=["longest_max_size", "resize"],
                    help="resample mode of the frames program")
    ap.add_argument("--flame-path", default=None)
    ap.add_argument("--device", default="cuda", help="where to load and trace: cuda (default) or cpu")
    ap.add_argument("--devices", nargs="+", default=None,
                    help="devices the artifact carries programs for (default: cuda cpu with a card, else cpu)")
    ap.add_argument("--quant-amax", default=None, help="amax .npz: export the int8 artifact (resnet50)")
    args = ap.parse_args(argv)
    check_exportable(args.backbone)

    from ..api.export import default_devices, export_predictor
    from ..api.predictor import FaceMeshPredictor

    predictor = FaceMeshPredictor(
        {
            "img_size": args.img_size,
            "stride": args.stride,
            "model": {"backbone": args.backbone, "num_filters": args.num_filters, "num_classes": 68,
                      "dtype": args.dtype},
            "quant_amax": args.quant_amax,
        },
        checkpoint_path=args.checkpoint,
        flame_path=args.flame_path,
        device=args.device,
        require_weights=True,
    )
    devices = tuple(args.devices) if args.devices else default_devices()
    path = export_predictor(
        predictor.model, predictor.flame, args.out, img_size=args.img_size, stride=args.stride,
        constants=predictor.flame_constants, devices=devices, resize_mode=args.resize_mode,
        quant_amax=predictor.quant_amax,
    )
    print(f"exported {path} ({os.path.getsize(path) / 1e6:.1f} MB, devices={list(devices)})")
    return path


if __name__ == "__main__":
    main()
