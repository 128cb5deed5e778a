"""Readings that the SwinV2 serving cells' limits are set from, as
``portbench/calibrate.py`` takes them for the CNN cells: the program's
numbers on many seeds and the control's. Not part of a run.

    python -m portbench.calibrate_swin --workload <cell> --seeds 1 2 ... [--control-seeds 1 2 3] [--calls 4]

For each seed, in one process: set-up as a run makes it, ``--calls`` calls
of the window, then the cell's numbers against the SwinV2 reference (the
lower readings); on the control seeds also the control (the reference in
the program's place, its trunk's convolution and matrix-product operands in
fp8 and its FLAME decode's products in TF32). One JSON line per seed and
reading on standard output (and in ``--out``)."""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

from .drivers.predict_batch_swin import control
from .run import driver_class, load_spec


def readings(spec, seed: int, calls: int, with_control: bool, device: str = "cuda") -> list:
    with tempfile.TemporaryDirectory(prefix="portbench-") as workdir:
        t = time.perf_counter()
        drv = driver_class(spec["traffic"])(spec["config"], spec["traffic"], seed, device, workdir)
        for i in range(calls):
            drv.call(i)
        drv.sync()
        setup = time.perf_counter() - t
        samples = list(drv.samples)
        out = [{"seed": seed, "reading": "program", **drv.check(), "seconds": setup}]
        if with_control:
            drv.samples = samples
            out.append({"seed": seed, "reading": "control", **control(drv)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--calls", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    spec = load_spec(args.workload)
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            for r in readings(spec, seed, args.calls, seed in args.control_seeds):
                line = json.dumps({"workload": args.workload, **r})
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
