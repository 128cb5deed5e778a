"""Run one cell of the benchmark and print its result as the last line of
standard output.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``configs[].file``), a traffic mix (``portbench/traffic/<traffic>.json``,
whose ``driver`` names the entry driver ``portbench/drivers/<driver>.py``)
and its limits (``portbench/workloads/<cell>.json``). Set-up builds the
program from the seed and warms up the cell's own shapes; the window then
calls the entry back to back for ``--seconds``. ``--trace 1`` profiles
``trace_calls`` calls of the window and reports the cell's per-layer
metrics (``portbench/metrics/<metric>.py``); ``--trace 0`` its end-to-end
metrics. After the window the program's state is freed and the reference
judges the outputs (``correct``). Needs as many CUDA cards as the cell
names: without them it prints no result and exits with 2."""

import time

T0 = time.perf_counter()  # set-up is timed from the start of the process's Python

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dad3dheads_tpu")  # top-level module names
TRACE_AFTER = 2  # window calls before the traced ones
CACHE_DIR = ROOT / ".portbench_cache"  # every kernel cache of the run, at a fixed path inside the checkout


def load_spec(name: str, root: Path = ROOT) -> dict:
    """A cell with everything its files give: ``cell``, ``config``,
    ``traffic``, ``limits``, ``end_to_end`` and ``per_layer`` (the metric
    entries of BENCHMARK.json that apply to it), and the ``root``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    here = root / "portbench"

    def applies(metric):
        return name in metric.get("workloads", [name])

    return dict(
        cell=cell,
        config=json.loads((root / config["file"]).read_text()),
        traffic=json.loads((here / "traffic" / f"{cell['traffic']}.json").read_text()),
        limits=json.loads((here / "workloads" / f"{name}.json").read_text())["limits"],
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)],
        root=str(root),
    )


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``portbench/metrics/<metric>.py``."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver_class(traffic: dict):
    return importlib.import_module(f"portbench.drivers.{traffic['driver']}").Driver


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def window(drv, seconds: float, trace: bool, trace_calls: int):
    """Calls the entry back to back for ``seconds``; a traced run profiles
    ``trace_calls`` calls after the first ``TRACE_AFTER``, in full whatever
    the length. Returns (host seconds of each call, window seconds, the
    profiler or None, the launch counters over the traced calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from .trace import CALL_SPAN, WINDOW_SPAN

    call_s, prof, counters = [], None, {}

    def call(traced: bool = False) -> None:
        t = time.perf_counter()
        if traced:
            with record_function(CALL_SPAN):
                drv.call(len(call_s))
        else:
            drv.call(len(call_s))
        call_s.append(time.perf_counter() - t)

    drv.sync()
    t0 = time.perf_counter()
    if trace:
        while len(call_s) < TRACE_AFTER:
            call()
        drv.sync()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        with profile(activities=activities) as prof:
            before = drv.counters()
            with record_function(WINDOW_SPAN):
                for _ in range(trace_calls):
                    call(traced=True)
                drv.sync()
            counters = {k: v - before[k] for k, v in drv.counters().items()}
    while time.perf_counter() - t0 < seconds:
        call()
    drv.sync()
    return call_s, time.perf_counter() - t0, prof, counters


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run(spec: dict, seed: int, seconds: float, trace: bool, device: str = "cuda", t0: float = T0):
    """One run of a cell: returns (result line as a dict, lines for standard
    error). ``device`` "cpu" serves the CPU tests of the harness."""
    import torch

    from . import compare
    from .readers import Reading
    from .trace import breakdown, reduce

    traffic = spec["traffic"]
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        drv = driver_class(traffic)(spec["config"], traffic, seed, device, workdir)
        setup_s = time.perf_counter() - t0
        trace_calls = int(traffic["trace_calls"])
        call_s, window_s, prof, counters = window(drv, seconds, trace, trace_calls)
        memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        metrics, extra = {}, {}
        if trace:
            t = reduce(prof)
            del prof
            reading = Reading(trace=t, calls=trace_calls, counters=counters, kernel_bounds=drv.kernel_bounds(),
                              model_flops=drv.model_flops(), host_call_s=call_s)
            for m in spec["per_layer"]:
                value = reader(m["name"], Path(spec["root"]))(reading)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            extra = {"busy_s": t.busy_s, "window_s": t.window_s}
        else:
            e2e = {**drv.end_to_end(call_s, window_s), "setup_s": setup_s}
            metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in spec["end_to_end"]}
        numbers = drv.check()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    checks = compare.judged(numbers, spec["limits"])
    attempted = drv.images(len(call_s))
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
                   "count": int(spec["cell"]["chips"]), "memory_peak_bytes": int(memory_peak), **extra}
    result = {"correct": compare.passes(checks), "attempted": attempted, "failed": 0, "metrics": metrics,
              "device": device_info}
    if trace:
        result["breakdown"] = breakdown(t)
    result["checks"] = checks
    lines = [f"card: {power_limit() if device == 'cuda' else device}",
             "set-up: " + ", ".join(f"{label} {s:.3f} s" for label, s in drv.setup_marks),
             f"window: {len(call_s)} calls in {window_s:.3f} s, set-up {setup_s:.3f} s"]
    lines.append("numbers: " + ", ".join(f"{k} {v!r}" for k, v in numbers.items()))
    lines += [f"check {k}: {c['value']!r} against the limit {c['limit']!r}" for k, c in checks.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec(args.workload)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE_DIR / sub)

    import torch

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    result, lines = run(spec, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result, allow_nan=False, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
