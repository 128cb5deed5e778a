"""Seconds per epoch of ``cli.train --synthetic`` on the card, as the
trainer logs them ("epoch N done in ...": the train steps, the validation
and the logging of one epoch, before its checkpoint is saved), unrounded.

    python tools/epoch_time.py [--root DIR] [--steps 16] [--epochs 3]

``--root`` is the checkout whose ``dad3dheads_tpu_torch`` runs (default: the
one holding this script), so that two commits can be timed on one card one
after the other: unpack the other into a directory and run parent, change,
change, parent. The model is ``configs/train.yaml``'s (resnet50 at 256x256,
batch 64); the first epoch carries the warm-up. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import tempfile


class _Epochs(logging.Handler):
    """The seconds of each "epoch %d done in %.1fs" record, from its
    arguments (the float before it is formatted)."""

    def __init__(self):
        super().__init__()
        self.seconds: list = []

    def emit(self, record: logging.LogRecord) -> None:
        if str(record.msg).startswith("epoch %d done in"):
            self.seconds.append(float(record.args[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--steps", type=int, default=16, help="train steps per epoch")
    ap.add_argument("--epochs", type=int, default=3)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from dad3dheads_tpu_torch.cli.train import main as train_main

    if not torch.cuda.is_available():
        raise SystemExit("epoch_time: no CUDA device")
    epochs = _Epochs()
    loop = logging.getLogger("dad3dheads_tpu_torch.train.loop")
    loop.setLevel(logging.INFO)
    loop.addHandler(epochs)
    with tempfile.TemporaryDirectory() as tmp:
        train_main(["--config", os.path.join(root, "configs", "train.yaml"), "--synthetic", str(args.steps),
                    "--device", "cuda", f"max_epochs={args.epochs}", f"experiment_dir={os.path.join(tmp, 'exp')}"])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()
    print(json.dumps({"root": root, "steps_per_epoch": args.steps, "seconds_per_epoch": epochs.seconds,
                      "card": card[0] if card else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
