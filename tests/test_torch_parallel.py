"""``dad3dheads_tpu_torch.parallel`` on the CPU: the mesh helpers on the
cases of ``tests/test_multihost_data.py``; two gloo ranks
(``tests/torch_parallel_worker.py``, started once for the module) for the
global-batch BatchNorm and head tensor parallelism; the predictor's
``mesh=``; and ``cli.train distributed=true`` as torchrun would start it.
This file imports no JAX (the data-parallel step against the JAX package is
``test_torch_parallel_step.py``), so that its ``cuda`` tests run on the card
with ``--noconftest``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dad3dheads_tpu_torch.api import FaceMeshPredictor
from dad3dheads_tpu_torch.core import FlameModel, LandmarkEmbedding
from dad3dheads_tpu_torch.data.synthetic import synthetic_batch
from dad3dheads_tpu_torch.models import create_model
from dad3dheads_tpu_torch.models.resnet import BatchNorm2d
from dad3dheads_tpu_torch.parallel import (
    device_prefetch,
    local_data_row_count,
    make_mesh,
    pad_batch_to_devices,
    put_global_batch,
    replicate,
    shard_batch,
)

from .torch_parallel_worker import BN_C, World, bn_inputs, bn_run, free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 64
TP_MODEL = {"backbone": "mobilenet_w1", "dropout": 0.0}
HEADS = [f"{h}.logit_image.{i}.weight" for h in ("shape", "pose", "landmarks") for i in (0, 3)]
CPU = torch.device("cpu")


def _cli_env(rank: int, world: int, port: int) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "DAD3D_PLATFORM"}
    env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="localhost",
               MASTER_PORT=str(port), OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    return env


class _Worlds:
    """Both multi-process runs, started together before the predictor's
    test, so that they run beside it: the worker's ``bn`` and
    ``tp`` tasks (mobilenet_w1 at 64x64, B = 8, SGD lr 1e-2 with
    ``gradient_clip_val`` 1, so that the step clips by the sharded norm) and
    two ranks of ``cli.train --device cpu distributed=true``."""

    def __init__(self, work):
        torch.save(create_model(TP_MODEL, torch.Generator().manual_seed(0)).state_dict(), work / "state.pt")
        torch.save(synthetic_batch(torch.Generator().manual_seed(1), FlameModel.load(), LandmarkEmbedding.load(), 8,
                                   IMG), work / "batch.pt")
        spec = {"model": TP_MODEL, "optimizer": {"name": "sgd", "lr": 1e-2}, "clip": 1.0, "warmup": 0,
                "img_size": IMG}
        self.world = World("bn,tp", str(work), spec=spec)
        self.exp = work / "exp"
        port = free_port()
        cmd = [sys.executable, "-m", "dad3dheads_tpu_torch.cli.train",
               "--config", os.path.join(REPO, "configs", "train.yaml"), "--synthetic", "2", "--device", "cpu", f"img_size={IMG}", "batch_size=2", "max_epochs=1",
               "model.backbone=mobilenet_w1", f"experiment_dir={self.exp}", "distributed=true"]
        self.cli = [subprocess.Popen(cmd, cwd=REPO, env=_cli_env(r, 2, port), stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True) for r in range(2)]
        self._results = None

    def results(self) -> dict:
        if self._results is None:
            try:
                logs = [p.communicate(timeout=300)[0] for p in self.cli]
            finally:
                self._stop_cli()
            self._results = {"ranks": self.world.results(timeout=300), "cli": (self.cli, logs, self.exp)}
        return self._results

    def _stop_cli(self) -> None:
        for p in self.cli:
            if p.poll() is None:
                p.kill()
                p.communicate()

    def stop(self) -> None:
        """Kill whatever is still running (a run whose results no test
        read) and reap it."""
        self._stop_cli()
        self.world.stop()


@pytest.fixture(scope="module")
def _started(tmp_path_factory):
    runs = _Worlds(tmp_path_factory.mktemp("world"))
    yield runs
    runs.stop()


@pytest.fixture(scope="module")
def worlds(_started):
    return _started.results()


# -- (i) the mesh helpers ---------------------------------------------------


def test_make_mesh_shapes_and_checks():
    """Defaults to every device on the data axis; model columns split it;
    the JAX package's divisibility checks; a card that is not there
    raises."""
    mesh = make_mesh([CPU] * 8)
    assert mesh.shape == {"data": 8, "model": 1} and not mesh.distributed
    assert make_mesh([CPU] * 8, model=2).shape == {"data": 4, "model": 2}
    assert make_mesh([CPU] * 8, data=2, model=4).devices.shape == (2, 4)
    with pytest.raises(ValueError):
        make_mesh([CPU] * 3, model=2)
    with pytest.raises(ValueError):
        make_mesh([CPU] * 8, data=2, model=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(["cuda:0", "cuda:0"])


def test_pad_batch_and_local_data_rows():
    """pad_batch_to_devices rounds up to the data rows; with a model axis
    the rows, not the devices, count; a process that owns none counts 1."""
    mesh = make_mesh([CPU] * 8, model=2)
    assert [pad_batch_to_devices(b, mesh) for b in (1, 4, 5, 8)] == [4, 4, 8, 8]
    assert local_data_row_count(mesh) == 4
    assert local_data_row_count(mesh, rank=10**6) == 1
    assert local_data_row_count(make_mesh([CPU] * 8)) == 8


def test_put_global_batch_splits_the_data_axis():
    """One chunk per data row in order, each on its row's device; per-sample
    lists cut with the rows; an uneven batch raises the JAX package's
    error."""
    mesh = make_mesh([CPU] * 8)
    x = np.arange(16 * 5, dtype=np.float32).reshape(16, 5)
    names = [f"img{i}.png" for i in range(16)]
    chunks = put_global_batch({"x": x, "name": names}, mesh)
    assert len(chunks) == 8 and all(c["x"].shape == (2, 5) and c["x"].device == CPU for c in chunks)
    np.testing.assert_array_equal(torch.cat([c["x"] for c in chunks]).numpy(), x)
    assert sum((c["name"] for c in chunks), []) == names
    with pytest.raises(ValueError, match=r"batch axis of x \(12\) must be divisible by 8"):
        put_global_batch({"x": x[:12]}, mesh)
    a, b = shard_batch((torch.arange(6), torch.ones(6, 2)), make_mesh([CPU] * 3))[1]
    assert a.tolist() == [2, 3] and b.shape == (2, 2)


def test_device_prefetch_keeps_batches_in_order():
    """Every batch, in order, on this process's one data row; a mesh with
    several local rows is refused (``put_global_batch`` splits those)."""
    mesh = make_mesh([CPU])
    batches = [{"x": np.full((2, 3), i, np.float32), "name": [f"n{i}", "m"]} for i in range(5)]
    seen = [(float(b["x"][0, 0]), b["name"][0], type(b["x"])) for b in device_prefetch(iter(batches), mesh)]
    assert seen == [(float(i), f"n{i}", torch.Tensor) for i in range(5)]
    with pytest.raises(ValueError, match="one data row per process"):
        next(device_prefetch(iter(batches), make_mesh([CPU] * 2)))


def test_replicate_gives_one_copy_per_device():
    """A repeated device holds one copy: the module itself where it is."""
    model = torch.nn.Linear(3, 2)
    copies = replicate({"model": model, "t": torch.ones(2)}, make_mesh([CPU, CPU]))
    assert list(copies) == [CPU] and copies[CPU]["model"] is model


# -- (v) the predictor's mesh= ------------------------------------------------


def test_predictor_mesh_matches_unsharded(_started):
    """``FaceMeshPredictor(mesh=make_mesh([cpu, cpu]))`` at 64x64 on B = 5
    (padded to 6, three rows a device) against the unsharded predictor, on
    predict_batch, predict_images and predict_frames: atol 1e-5. (The
    module's multi-process runs start before it and run beside it.)"""
    torch.set_num_threads(2)
    config = {"img_size": IMG}
    ref = FaceMeshPredictor(config, device="cpu", seed=3)
    mesh = FaceMeshPredictor(config, seed=3, mesh=make_mesh([CPU, CPU]))
    assert mesh.device == CPU
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (5, IMG, IMG, 3), dtype=np.uint8)
    a, b = ref.predict_batch(images), mesh.predict_batch(images)
    for k in a:
        assert a[k].shape[0] == 5
        np.testing.assert_allclose(b[k], a[k], atol=1e-5, err_msg=k)
    odd = [rng.integers(0, 256, (80, 70, 3), dtype=np.uint8) for _ in range(5)]
    frames = [rng.integers(0, 256, (90, 120, 3), dtype=np.uint8) for _ in range(5)]
    boxes = [[5, 5, 60, 70]] * 5
    for got, want in ((mesh.predict_images(odd, batch_size=4), ref.predict_images(odd, batch_size=4)),
                      (mesh.predict_frames(frames, boxes, batch_size=4), ref.predict_frames(frames, boxes,
                                                                                          batch_size=4))):
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_allclose(g[k], w[k], atol=1e-5, err_msg=k)


# -- (ii) the global-batch BatchNorm -----------------------------------------


def test_global_batch_bn_matches_one_process(worlds):
    """Two ranks, each with half of a B = 8 batch at 64x64 whose channel
    means reach 60 times their spreads, against the plain ``BatchNorm2d``
    on the whole batch in float64: outputs, input gradients, the weight and
    bias gradients summed over the ranks, and the running statistics after
    two forwards agree to 1e-6 of each tensor's largest value. (The plain
    fp32 ``BatchNorm2d`` on the whole batch is itself 4.8e-6 off on the
    outputs here; E[x^2] - E[x]^2 in fp32 would be far outside.)"""
    x, probe = bn_inputs()
    ref = bn_run(BatchNorm2d(BN_C).double(), x.astype(np.float64), probe.astype(np.float64), CPU)
    ranks = [r["bn"] for r in worlds["ranks"]]
    got = {"y": torch.cat([r["y"] for r in ranks]), "dx": torch.cat([r["dx"] for r in ranks]),
           "dweight": sum(r["dweight"] for r in ranks), "dbias": sum(r["dbias"] for r in ranks)}
    for k in ("running_mean", "running_var"):
        assert torch.equal(ranks[0][k], ranks[1][k]), k
        got[k] = ranks[0][k]
    plain = bn_run(BatchNorm2d(BN_C), x, probe, CPU)
    for k, v in got.items():
        scale = float(ref[k].abs().max())
        gap = float((v.double() - ref[k]).abs().max()) / scale
        print(f"{k}: two ranks {gap:.2e}, plain fp32 {float((plain[k].double() - ref[k]).abs().max()) / scale:.2e}")
        assert gap <= 1e-6, k
    # the inputs do cancel in the one-pass formula
    xd = torch.from_numpy(x)
    naive = (xd * xd).mean((0, 2, 3)) - xd.mean((0, 2, 3)) ** 2
    true = torch.from_numpy(x.astype(np.float64).var((0, 2, 3)))
    assert float(((naive.double() - true) / true).abs().max()) > 1e-5


def test_bn_group_of_one_is_the_plain_batch_norm(worlds):
    """Under a group of one rank, set_sync_bn keeps the local batch norm:
    the running variance is the plain ``BatchNorm2d``'s, bit for bit."""
    for r in worlds["ranks"]:
        assert r["bn"]["single_rank_group_is_local"] and r["bn"]["single_rank_running_var_equal"]


# -- (iv) head tensor parallelism -------------------------------------------


def test_head_tp_matches_replicated(worlds):
    """The three heads split over two ranks against the replicated step
    from the same weights and batch: logs at rtol 2e-4, the updated head
    weights (gathered) at atol 1e-5, as tests/test_model_axis_tp.py holds
    the JAX package; the heads moved; both ranks gather the same weights."""
    r0, r1 = (r["tp"] for r in worlds["ranks"])
    rep, split = r0["replicated_logs"], r0["split_logs"]
    assert set(rep) == set(split) and rep["grad_norm"] > 1.0  # clipped
    for k in rep:
        np.testing.assert_allclose(split[k], rep[k], rtol=2e-4, err_msg=k)
    start = create_model(TP_MODEL, torch.Generator().manual_seed(0)).state_dict()
    for k in HEADS:
        np.testing.assert_allclose(r0["split_heads"][k], r0["replicated_heads"][k], atol=1e-5, err_msg=k)
        assert torch.equal(r0["split_heads"][k], r1["split_heads"][k]), k
        assert float((r0["replicated_heads"][k] - start[k]).abs().max()) > 1e-7, k


def test_head_tp_shards_and_gathers_the_layout(worlds):
    """Each rank holds half of each head Linear (the first's output rows,
    the second's input columns); the gathered state dict has the replicated
    layout's keys and shapes."""
    r0 = worlds["ranks"][0]["tp"]
    assert r0["shard_shapes"]["shape.logit_image.0.weight"] == (256, 1024)
    assert r0["shard_shapes"]["landmarks.logit_image.3.weight"] == (136, 256)
    assert r0["split_layout"] == r0["replicated_layout"]


# -- (vi) cli.train distributed=true ---------------------------------------


def test_cli_train_distributed_writes_on_rank_zero(worlds):
    """Two gloo ranks of ``cli.train --synthetic 2 --device cpu
    distributed=true`` (global batch 2, one row a rank): both exit 0 and
    log their rank; the shared experiment dir holds one writer's
    ``metrics.jsonl`` (the epoch and the best-checkpoint lines, once each),
    a ``last.pt`` that loads, and the inference export."""
    procs, logs, exp = worlds["cli"]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, log[-4000:]
        assert f"rank {r} of 2 on cpu" in log, log[-2000:]
    with open(exp / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert len(lines) == 2 and "train/loss" in lines[0] and "best/loss" in lines[1], lines
    assert all(np.isfinite(v) for line in lines for v in line.values())
    last = torch.load(exp / "checkpoints" / "last.pt", weights_only=True)
    assert last["step"] == 2
    assert os.path.isfile(exp / "checkpoints" / "dad_3dnet.msgpack")


def test_cli_train_distributed_without_torchrun_fails(tmp_path, monkeypatch):
    """``distributed=true`` without torchrun's environment raises before
    anything trains: the run never goes on as one process."""
    from dad3dheads_tpu_torch.cli.train import main

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun's environment"):
        main(["--config", os.path.join(REPO, "configs", "train.yaml"), "--synthetic", "1", "--device", "cpu",
              f"experiment_dir={tmp_path / 'exp'}", "distributed=true"])
    assert not (tmp_path / "exp").exists()


# -- on the card -------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_predictor_mesh_on_the_card(cuda):
    """``mesh=make_mesh([cuda:0, cuda:0])`` against the unsharded predictor
    on the card, predict_batch on B = 5 at 64x64: 3DMM and vertices atol
    1e-3, points 0.5 px (chip_smoke.py phase 4's tolerances)."""
    config = {"img_size": IMG}
    ref = FaceMeshPredictor(config, device=cuda, seed=3)
    mesh = FaceMeshPredictor(config, seed=3, mesh=make_mesh([cuda, cuda]))
    images = np.random.default_rng(0).integers(0, 256, (5, IMG, IMG, 3), dtype=np.uint8)
    a, b = ref.predict_batch(images), mesh.predict_batch(images)
    for k, tol in (("3dmm_params", 1e-3), ("3d_vertices", 1e-3), ("points", 0.5), ("projected_vertices", 0.5)):
        np.testing.assert_allclose(b[k], a[k], atol=tol, err_msg=k)


@pytest.mark.cuda
def test_device_prefetch_on_the_card_behind_a_busy_stream(cuda):
    """Batches whose tensors are written on the card behind a queue of
    matmuls on the current stream, beside host arrays: the card's tensors
    come through as the same objects, the host arrays arrive copied, and
    every value is exact when the step reads it."""
    busy = torch.randn(2048, 2048, device=cuda)
    made = []

    def batches():
        for i in range(6):
            for _ in range(20):
                busy.copy_(torch.tanh(busy @ busy))  # keeps the current stream busy
            on_card = torch.empty(16, 3, 256, 256, device=cuda).fill_(float(i))  # queued behind the matmuls
            made.append(on_card)
            yield {"card": on_card, "host": np.full((16, 1000), i, np.float32), "name": [f"n{i}"]}

    for i, b in enumerate(device_prefetch(batches(), make_mesh([cuda]))):
        assert b["card"] is made[i] and b["host"].device == cuda and b["name"] == [f"n{i}"]
        assert bool((b["card"] == i).all()) and bool((b["host"] == i).all()), i
    assert i == 5


@pytest.mark.cuda
def test_global_batch_bn_on_the_card_with_gloo(cuda, tmp_path):
    """The ``bn`` task on two gloo ranks sharing ``cuda:0`` (NCCL refuses
    two ranks on one card) against the float64 plain ``BatchNorm2d`` on the
    CPU: 1e-6 of each tensor's largest value, as on the CPU."""
    ranks = [r["bn"] for r in World("bn", str(tmp_path), device="cuda:0").results(timeout=300)]
    x, probe = bn_inputs()
    ref = bn_run(BatchNorm2d(BN_C).double(), x.astype(np.float64), probe.astype(np.float64), CPU)
    got = {"y": torch.cat([r["y"] for r in ranks]), "dx": torch.cat([r["dx"] for r in ranks]),
           "dweight": sum(r["dweight"] for r in ranks), "dbias": sum(r["dbias"] for r in ranks),
           "running_mean": ranks[0]["running_mean"], "running_var": ranks[0]["running_var"]}
    for k, v in got.items():
        assert float((v.double() - ref[k]).abs().max()) <= 1e-6 * float(ref[k].abs().max()), k
