"""A cell, a configuration, a traffic mix and a per-layer metric are added as
new files and ``BENCHMARK.json`` entries alone, in a copy of the benchmark:
the harness finds and runs them, and no file that was there changes. A run
that finds no card fails and prints no result."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


def digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture()
def copy(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    return root


def add_dummy_cell(root: Path) -> None:
    here = root / "portbench"
    config = json.loads((here / "configs" / "dad3dnet-resnet50.json").read_text())
    (here / "configs" / "dummy.json").write_text(json.dumps({**config, "img_size": 64}))
    (here / "traffic" / "dummy-mix.json").write_text(json.dumps(
        {"driver": "predict_batch", "batch": 2, "pool": 2, "dtype": "float32", "warm_calls": 1, "sample_calls": 1,
         "trace_calls": 2}))
    (here / "workloads" / "dummy-cell.json").write_text(json.dumps(
        {"limits": {"mm3d_rel": 1e-4, "points_px": 0.01, "vertices_rel": 1e-5, "projected_px": 1e-3}}))
    (here / "metrics" / "dummy_metric.serve.py").write_text("def read(r):\n    return 42.0 if r.calls else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy", "source": "https://arxiv.org/abs/2204.03688",
                             "file": "portbench/configs/dummy.json", "reduced": ["img_size"], "why": "a test"})
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy", "traffic": "dummy-mix", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("images_per_s", "batch_p95_ms"):
            m["workloads"].append("dummy-cell")
    bench["per_layer"].append({"name": "dummy_metric.serve", "unit": "%", "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "images_per_s", "workloads": ["dummy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_new_files_alone_add_a_cell(copy):
    before = digest(copy)
    add_dummy_cell(copy)
    after = digest(copy)
    changed = {p for p in before if before[p] != after.get(p)}
    assert changed == {"BENCHMARK.json"}
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(copy), str(REPO)])}
    code = """
import json, time
from portbench import run, readers
spec = run.load_spec("dummy-cell")
assert run.__file__.startswith(%r)
result, lines = run.run(spec, 3000000019, 0.5, False, device="cpu", t0=time.perf_counter())
reading = readers.Reading(trace=None, calls=2, counters={}, kernel_bounds={}, model_flops=0.0, host_call_s=[])
print(json.dumps({"result": result, "per_layer": [m["name"] for m in spec["per_layer"]],
                  "dummy": run.reader("dummy_metric.serve")(reading)}))
""" % str(copy)
    out = subprocess.run([sys.executable, "-c", code], cwd=copy, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["result"]["correct"] is True
    assert set(got["result"]["metrics"]) == {"images_per_s", "batch_p95_ms", "setup_s"}
    assert got["per_layer"] == ["dummy_metric.serve"]
    assert got["dummy"] == 42.0


def test_a_run_without_a_card_fails_and_prints_no_result(copy):
    env = {**os.environ, "PYTHONPATH": str(copy)}
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "resnet50-bulk-bf16-b256", "--seed",
                          "3000000021", "--seconds", "1", "--trace", "0"], cwd=copy, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert not any(line.lstrip().startswith("{") for line in out.stdout.splitlines())
    assert "CUDA" in out.stderr
