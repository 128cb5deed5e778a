"""Benchmark CLI: score a submission against generated ground truth, or
generate the ground-truth json. Port of ``dad3dheads_tpu/cli/benchmark.py``;
``--device`` says where the evaluator computes Chamfer and Z_n.

  python -m dad3dheads_tpu_torch.cli.benchmark evaluate \\
      --submission data/sub.json --gt data/ground_truth_val.json [--device cpu]
  python -m dad3dheads_tpu_torch.cli.benchmark generate-gt \\
      --base-path dataset --subset val
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    ev = sub.add_parser("evaluate")
    ev.add_argument("--submission", required=True)
    ev.add_argument("--gt", required=True)
    ev.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    gg = sub.add_parser("generate-gt")
    gg.add_argument("--base-path", required=True)
    gg.add_argument("--subset", default="val")
    gg.add_argument("--with-attributes", action="store_true")
    gg.add_argument("--output-dir", default="data")
    args = ap.parse_args(argv)

    if args.cmd == "evaluate":
        from ..benchmark_harness import evaluate

        evaluate(args.submission, args.gt, device=args.device)
    else:
        from ..benchmark_harness import generate_gt

        print(generate_gt(args.base_path, args.subset, args.with_attributes, args.output_dir))


if __name__ == "__main__":
    main()
