"""Readings that the cells' limits are set from: the program's numbers on
many seeds, the control's, and the planted faults'. Not part of a run.

    python -m portbench.calibrate --workload <cell> --seeds 1 2 ... [--control-seeds 1 2 3] [--calls 4]

For each seed, in one process: set-up as a run makes it, ``--calls`` calls
of the window at the cell's load, then the cell's numbers against the
reference (the lower readings). On the control seeds also the control (the
reference put in the program's place, its trunk's convolutions in fp8 and
its FLAME decode's products in TF32: one step below the bf16 trunk and the
fp32 decode the configuration states) and, for a train cell, the planted
fault of half the batch left out (the reference on the first half of each
batch, its mean over those rows). ``--witness-seeds`` adds, for a train
cell, the second witnesses of :func:`witness`. One JSON line per seed and
reading on standard output (and in ``--out``)."""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import torch

from . import compare, seeded
from .drivers.predict_batch import reference_outputs, reference_readings
from .reference import precision
from .run import driver_class, load_spec


def control_serve(drv) -> dict:
    """The control's numbers on the serving cell's sampled calls: the
    reference in fp8 and TF32 run on the same pool batches."""
    dev = drv.device
    P = seeded.weights(drv.config["model"], drv.seed, dev, random_bn=True)
    flame = seeded.flame(drv.seed, dev)
    samples = []
    with torch.no_grad():
        for k, _ in drv.samples:
            out = reference_outputs(P, flame, torch.from_numpy(drv.pool[k]).to(dev), drv.config["model"]["backbone"],
                                    drv.size, quant=precision.fp8, matmul=precision.tf32_matmul)
            samples.append((k, out))
    del P, flame
    return compare.worst(reference_readings(drv, samples))


def readings(spec, seed: int, calls: int, control: bool, device: str = "cuda") -> list:
    out = []
    with tempfile.TemporaryDirectory(prefix="portbench-") as workdir:
        t = time.perf_counter()
        drv = driver_class(spec["traffic"])(spec["config"], spec["traffic"], seed, device, workdir)
        for i in range(calls):
            drv.call(i)
        drv.sync()
        setup = time.perf_counter() - t
        if spec["traffic"]["driver"] == "train_step":
            ref = drv.reference()
            out.append({"seed": seed, "reading": "program", **compare.train_numbers(drv.program, ref),
                        "losses": drv.program["losses"], "ref_losses": ref["losses"], "seconds": setup})
            if control:
                ctl = drv.reference(quant=precision.fp8, matmul=precision.tf32_matmul)
                out.append({"seed": seed, "reading": "control", **compare.train_numbers(ctl, ref)})
                half = drv.reference(rows=slice(0, drv.batch // 2))
                out.append({"seed": seed, "reading": "fault: half the batch", **compare.train_numbers(half, ref)})
        else:
            samples = list(drv.samples)
            out.append({"seed": seed, "reading": "program", **drv.check(), "seconds": setup})
            if control:
                drv.samples = samples
                out.append({"seed": seed, "reading": "control", **control_serve(drv)})
    return out


def witness(spec, seed: int, device: str = "cuda") -> list:
    """A train cell's second witnesses: the program with its trunk in fp32
    (the same path at the reference's precision), and the reference itself
    with its trunk's convolutions rounded to bf16 (the configuration's
    precision without the program), each against the fp32 reference."""
    traffic = {**spec["traffic"], "dtype": "float32"}
    with tempfile.TemporaryDirectory(prefix="portbench-") as workdir:
        drv = driver_class(traffic)(spec["config"], traffic, seed, device, workdir)
        ref = drv.reference()
        out = [{"seed": seed, "reading": "witness: the program in fp32", **compare.train_numbers(drv.program, ref)}]
        ref_bf16 = drv.reference(quant=precision.bf16)
        out.append({"seed": seed, "reading": "witness: the reference in bf16", **compare.train_numbers(ref_bf16, ref)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--calls", type=int, default=4)
    ap.add_argument("--witness-seeds", type=int, nargs="*", default=[], help="train cells: second witnesses")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    spec = load_spec(args.workload)
    sink = open(args.out, "a") if args.out else None
    try:
        runs = [(s, readings, (args.calls, s in args.control_seeds)) for s in args.seeds]
        runs += [(s, witness, ()) for s in args.witness_seeds]
        for seed, fn, extra in runs:
            for r in fn(spec, seed, *extra):
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
