"""The port's stage spans (``dad3dheads_tpu_torch.tracing``): recorded only
under a profiler, one tree per call with the predictor's and the train
step's stages, counts of the bytes they move, every span a profiler event
of the same name, nothing in an exported program; and the benchmark's
readers of them (``portbench/metrics/*``) on a hand-built log. Imports no
JAX, so that its ``cuda`` test runs on the card."""

import collections
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dad3dheads_tpu_torch import tracing
from dad3dheads_tpu_torch.models import quant

REPO = Path(__file__).resolve().parents[1]
IMG = 64
SERVE_STAGES = ("dad3d.serve.upload", "dad3d.serve.normalize", "dad3d.serve.network", "dad3d.serve.decode",
                "dad3d.serve.readback")
TRAIN_STAGES = ("dad3d.train.targets", "dad3d.train.forward", "dad3d.train.loss", "dad3d.train.backward",
                "dad3d.train.optimizer", "dad3d.train.panel")


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tests run beside other test processes: two torch threads each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _empty_log():
    tracing.clear()
    yield
    tracing.clear()


@pytest.fixture(scope="module")
def predictor():
    from dad3dheads_tpu_torch.api import FaceMeshPredictor

    return FaceMeshPredictor({"img_size": IMG}, device="cpu", seed=3)


def _images(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, IMG, IMG, 3), dtype=np.uint8)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _children(log, rec):
    return [x for x in log if x.parent == rec.id]


def _tree(log, root):
    """The root and every span under it (a parent enters before its children)."""
    ids, out = {root.id}, [root]
    for x in log:
        if x.parent in ids and x.id not in ids:
            ids.add(x.id)
            out.append(x)
    return out


def _assert_profiler_has_every_span(log, prof):
    names = {e.name for e in prof.events()}
    assert {x.name for x in log} <= names


def test_span_is_the_shared_no_op_without_a_profiler(predictor):
    assert not torch.autograd._profiler_enabled()
    off = tracing.span("dad3d.a", bytes=1)
    assert off is tracing.OFF and tracing.span("dad3d.b") is off
    with off as inside:
        assert inside is off
    predictor.predict_batch(_images(2))
    assert tracing.records() == []


def test_spans_nest_share_a_call_and_stand_in_the_profiler():
    def run():
        for _ in range(2):
            with tracing.span("dad3d.root", images=2):
                with tracing.span("dad3d.child", bytes=5, copies=1):
                    with tracing.span("dad3d.leaf"):
                        torch.ones(8).sum()
                with tracing.span("dad3d.child"):
                    pass

    _, prof = _profiled(run)
    log = tracing.records()
    assert [x.name for x in log] == ["dad3d.root", "dad3d.child", "dad3d.leaf", "dad3d.child"] * 2
    roots = [x for x in log if x.parent is None]
    assert [r.counts for r in roots] == [{"images": 2}] * 2
    for root in roots:
        mine = _tree(log, root)
        assert len(mine) == 4
        first, second = _children(log, root)
        assert first.counts == {"bytes": 5, "copies": 1} and second.counts == {}
        (leaf,) = _children(log, first)
        assert root.start_ns <= first.start_ns <= leaf.start_ns <= leaf.end_ns <= first.end_ns <= second.start_ns
        assert second.end_ns <= root.end_ns and root.host_ms >= first.host_ms + second.host_ms
        assert all(x.device_ms is None for x in mine)
    _assert_profiler_has_every_span(log, prof)
    tracing.clear()
    assert tracing.records() == []


def test_the_log_keeps_the_newest_spans(monkeypatch):
    monkeypatch.setattr(tracing, "_log", collections.deque(maxlen=4))

    def run():
        for _ in range(7):
            with tracing.span("dad3d.x"):
                pass

    _profiled(run)
    log = tracing.records()
    assert len(log) == 4 and [x.id - log[0].id for x in log] == [0, 1, 2, 3]
    assert tracing.LOG_SIZE == 65536


def test_predict_batch_spans_its_stages_with_their_bytes(predictor):
    images = _images(2)
    outs, prof = _profiled(lambda: [predictor.predict_batch(images) for _ in range(2)])
    log = tracing.records()
    roots = [x for x in log if x.parent is None]
    assert [r.name for r in roots] == ["dad3d.predict_batch"] * 2
    assert [r.counts for r in roots] == [{}] * 2
    for root, out in zip(roots, outs):
        mine = _tree(log, root)
        stages = _children(log, root)
        assert [x.name for x in stages] == list(SERVE_STAGES)
        upload, readback = stages[0], stages[-1]
        # on the CPU predictor the batch stays where it is: the bytes handed
        # over, and no copy
        assert upload.counts == {"bytes": images.nbytes, "copies": 0}
        assert readback.counts == {"bytes": sum(a.nbytes for a in out.values()), "copies": 0}
        (wait,) = _children(log, readback)
        assert wait.name == "dad3d.serve.wait" and wait.end_ns <= readback.end_ns
        assert len(mine) == len(log) // 2 == 1 + len(SERVE_STAGES) + 1
        assert all(x.end_ns is not None and x.device_ms is None for x in mine)
    _assert_profiler_has_every_span(log, prof)


def test_predict_frames_and_images_span_the_same_stages(predictor):
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 256, (90, 120, 3), dtype=np.uint8) for _ in range(3)]
    _, prof = _profiled(lambda: (predictor.predict_frames(frames, batch_size=2),
                                 predictor.predict_images(torch.from_numpy(_images(3)), batch_size=2),
                                 predictor(_images(1)[0])))
    log = tracing.records()
    roots = [x for x in log if x.parent is None]
    assert [r.name for r in roots] == ["dad3d.predict_frames", "dad3d.predict_images", "dad3d.predict"]
    for root in roots:
        mine = _tree(log, root)
        names = {x.name for x in mine}
        assert set(SERVE_STAGES) <= names
        assert names <= set(SERVE_STAGES) | {root.name, "dad3d.serve.wait", "dad3d.serve.readback_queue"}
        # a synchronous readback's wait is its child; the batches queued for
        # an asynchronous copy back read under another name
        for rec in mine:
            if rec.name == "dad3d.serve.readback":
                assert [x.name for x in _children(log, rec)] == ["dad3d.serve.wait"]
    frames_batches = [x for x in _tree(log, roots[0]) if x.name == "dad3d.serve.readback_queue"]
    assert [x.counts["copies"] for x in frames_batches] == [0, 0]  # two batches, on the CPU: no copy
    assert sum(x.name == "dad3d.serve.wait" for x in log) == sum(x.name == "dad3d.serve.readback" for x in log)
    _assert_profiler_has_every_span(log, prof)


def test_train_and_eval_steps_span_their_stages():
    from dad3dheads_tpu_torch.core import FlameModel, LandmarkEmbedding
    from dad3dheads_tpu_torch.data.synthetic import synthetic_batch
    from dad3dheads_tpu_torch.train import build_eval_step, build_train_step, init_train_state

    flame, emb = FlameModel.load(), LandmarkEmbedding.load()
    batch = synthetic_batch(torch.Generator().manual_seed(0), flame, emb, 2, IMG)
    state = init_train_state({"backbone": "mobilenet_w1"}, {"name": "adam", "lr": 1e-4},
                             torch.Generator().manual_seed(0), "cpu", 5.0)
    train_step, eval_step = build_train_step(img_size=IMG), build_eval_step(img_size=IMG)
    _, prof = _profiled(lambda: (train_step(state, flame, batch), eval_step(state, flame, batch)))
    log = tracing.records()
    train, evaluation = [x for x in log if x.parent is None]
    assert (train.name, evaluation.name) == ("dad3d.train_step", "dad3d.eval_step")
    assert [x.name for x in _children(log, train)] == list(TRAIN_STAGES)
    assert [x.name for x in _children(log, evaluation)] == ["dad3d.train.targets", "dad3d.train.forward",
                                                              "dad3d.train.loss", "dad3d.train.panel"]
    assert len(_tree(log, train)) == 1 + len(TRAIN_STAGES)
    assert all(x.device_ms is None for x in log)  # no span of the step asks for device time
    stages = sum(x.host_ms for x in _children(log, train))
    assert stages <= train.host_ms
    _assert_profiler_has_every_span(log, prof)


def test_int8_stages_are_spanned():
    g = torch.Generator().manual_seed(0)
    x = quant.quantize(torch.randn(2, 6, 6, 8, generator=g), torch.tensor(0.05))
    kq, wscale = quant.quantize_weights_per_channel(torch.randn(16, 8, 3, 3, generator=g))
    weight = quant.gemm_weight(kq)

    def run():
        y = quant.conv_int8(x, weight, 3, wscale, torch.zeros(16), 1, 1, out_scale=torch.tensor(0.1))
        z = quant.add_relu_requant(y, y, torch.tensor(0.2))
        return quant.dequantize(z)

    _, prof = _profiled(run)
    log = tracing.records()
    assert [x.name for x in log] == ["dad3d.int8.im2col", "dad3d.int8.int_mm", "dad3d.int8.epilogue",
                                     "dad3d.int8.quantize", "dad3d.int8.residual", "dad3d.int8.quantize",
                                     "dad3d.int8.dequantize"]
    assert all(x.parent is None for x in log)  # leaves, none inside another
    _assert_profiler_has_every_span(log, prof)


class _Int8Conv(torch.nn.Module):
    def __init__(self):
        super().__init__()
        kq, self.wscale = quant.quantize_weights_per_channel(torch.randn(16, 8, 3, 3,
                                                                         generator=torch.Generator().manual_seed(1)))
        self.weight = quant.gemm_weight(kq)

    def forward(self, x):
        y = quant.conv_int8(quant.quantize(x, torch.tensor(0.05)), self.weight, 3, self.wscale, torch.zeros(16), 1,
                            1, out_scale=torch.tensor(0.1))
        return quant.dequantize(quant.add_relu_requant(y, y, torch.tensor(0.2)))


def test_an_exported_program_holds_no_span():
    """Exported under a profiler, the int8 conv's program is the one exported
    without: the spans stay off while torch.export traces."""
    x = torch.randn(2, 6, 6, 8, generator=torch.Generator().manual_seed(2))
    plain = torch.export.export(_Int8Conv(), (x,), strict=False)
    traced, _ = _profiled(lambda: torch.export.export(_Int8Conv(), (x,), strict=False))
    code = traced.graph_module.code
    assert code == plain.graph_module.code
    assert "profiler" not in code and "record_function" not in code
    assert tracing.records() == []
    torch.testing.assert_close(traced.module()(x), _Int8Conv()(x), rtol=0, atol=0)


def test_profile_trace_carries_the_spans(tmp_path):
    from dad3dheads_tpu_torch import utils

    with utils.profile_trace(str(tmp_path / "trace")):
        with tracing.span("dad3d.stage", bytes=7):
            torch.ones(8, 8).matmul(torch.ones(8, 8))
    (name,) = (tmp_path / "trace").iterdir()
    events = json.loads(name.read_text())["traceEvents"]
    assert any(e.get("name") == "dad3d.stage" for e in events)
    (rec,) = tracing.records()
    assert rec.counts == {"bytes": 7}


# -- the benchmark's readers of the spans ----------------------------------

def _record(i, name, parent, start_ms, end_ms, device_ms=None, **counts):
    return types.SimpleNamespace(id=i, name=name, parent=parent, start_ns=int(start_ms * 1e6),
                                 end_ns=int(end_ms * 1e6), host_ms=end_ms - start_ms, counts=counts,
                                 device_ms=device_ms)


def _hand_built_log():
    """Two serving calls and two train steps: host ms 0.5 apart per call,
    device ms set where the stage is read on the device, the copies counted
    on the upload and the readback (and on one queued readback)."""
    log = []
    for call in range(2):
        b = 1000 * call
        log += [_record(b, "dad3d.predict_batch", None, b, b + 100),
                _record(b + 1, "dad3d.serve.upload", b, b, b + 8 + call, bytes=40_000_000, copies=1),
                _record(b + 2, "dad3d.serve.normalize", b, b + 10, b + 11),
                _record(b + 3, "dad3d.serve.network", b, b + 11, b + 20, device_ms=60.0 + call),
                _record(b + 4, "dad3d.serve.decode", b, b + 20, b + 22, device_ms=9.0 + call),
                _record(b + 5, "dad3d.serve.readback", b, b + 30, b + 90, bytes=25_000_000, copies=4),
                _record(b + 6, "dad3d.serve.wait", b + 5, b + 30, b + 84)]
        t = b + 500
        log.append(_record(t, "dad3d.train_step", None, t, t + 130))
        for j, (stage, ms) in enumerate(zip(TRAIN_STAGES, (2, 40, 8, 60, 7, 5))):
            log.append(_record(t + 1 + j, stage, t, t, t + ms + call))
    log.append(_record(9998, "dad3d.serve.readback_queue", None, 0, 1, bytes=2_000_000, copies=1))
    log.append(_record(9999, "dad3d.serve.wait", None, 0, 50))  # no readback parent
    return log


EXPECTED = {
    "upload_host_ms.serve": 8.5,
    "readback_host_ms.serve": 60.0 - 54.0,
    "network_ms.serve": 60.5,
    "decode_ms.serve": 9.5,
    "copies.serve": (2 * (1 + 4) + 1) / 2,
    "copy_mb.serve": (2 * (40 + 25) + 2) / 2,
    "targets_host_ms.train": 2.5,
    "forward_host_ms.train": 40.5,
    "loss_host_ms.train": 8.5,
    "backward_host_ms.train": 60.5,
    "optimizer_host_ms.train": 7.5,
    "panel_host_ms.train": 5.5,
}


def _reading(calls: int = 2):
    from portbench.readers import Reading

    return Reading(trace=None, calls=calls, counters={}, kernel_bounds={}, model_flops=0.0, host_call_s=[])


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_span_readers_on_a_hand_built_log(metric, monkeypatch):
    from portbench.run import reader

    read = reader(metric, REPO)
    monkeypatch.setattr(tracing, "records", _hand_built_log)
    assert read(_reading()) == pytest.approx(EXPECTED[metric], rel=1e-12)
    assert read(_reading(calls=0)) is None
    monkeypatch.setattr(tracing, "records", lambda: [x for x in _hand_built_log() if not x.name.startswith(
        ("dad3d.serve.upload", "dad3d.serve.readback", "dad3d.serve.network", "dad3d.serve.decode", "dad3d.train."))])
    assert read(_reading()) is None


def test_span_readers_read_nothing_from_a_program_without_spans(monkeypatch):
    """The parent of the spans has no tracing module: every reader returns
    None, and none raises."""
    from portbench.run import reader

    monkeypatch.setitem(sys.modules, "dad3dheads_tpu_torch.tracing", None)
    for metric in EXPECTED:
        assert reader(metric, REPO)(_reading()) is None


def test_the_span_metrics_are_in_the_benchmark():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    for metric in EXPECTED:
        entry = entries[metric]
        assert (REPO / "portbench" / "metrics" / f"{metric}.py").is_file()
        kind = "bulk" if metric.endswith(".serve") else "train"
        assert entry["workloads"] and all(kind in cells[c]["traffic"] for c in entry["workloads"])
        assert entry["moves"] == ("images_per_s" if kind == "bulk" else "train_images_per_s")
        assert entry["source"] == ("program_counter" if metric.startswith("cop") else "program_span")


@pytest.mark.cuda
def test_card_spans_read_device_time_and_stay_out_of_the_device_ops():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from dad3dheads_tpu_torch.api import FaceMeshPredictor
    from portbench.trace import device_events

    pred = FaceMeshPredictor({"img_size": IMG, "model": {"dtype": "bfloat16"}}, device="cuda", seed=3)
    images = _images(8)
    pred.predict_batch(images)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = pred.predict_batch(images)
        torch.cuda.synchronize()
    log = tracing.records()
    by_name = {x.name: x for x in log}
    assert by_name["dad3d.serve.upload"].counts == {"bytes": images.nbytes, "copies": 1}
    assert by_name["dad3d.serve.readback"].counts == {"bytes": sum(a.nbytes for a in out.values()), "copies": 4}
    timed = ("dad3d.serve.network", "dad3d.serve.decode")
    assert all(by_name[name].device_ms > 0 for name in timed)
    assert sum(by_name[name].device_ms for name in timed) <= by_name["dad3d.predict_batch"].host_ms
    assert all(x.device_ms is None for x in log if x.name not in timed)
    assert not [n for n, _, _ in device_events(prof) if "dad3d." in n]
    _assert_profiler_has_every_span(log, prof)
