"""The port's training loop pieces on the CPU: the checkpoint manager (top-k,
last, held snapshots, restore, the msgpack export), the metric accumulator,
and ``Trainer.fit``'s mid-epoch validation, held checkpoints between
intervals, early stopping and the features it refuses."""

import json
import os
import shutil
import signal

import numpy as np
import pytest
import torch

from dad3dheads_tpu_torch import weights
from dad3dheads_tpu_torch.core import FlameModel, LandmarkEmbedding
from dad3dheads_tpu_torch.data.synthetic import synthetic_batch
from dad3dheads_tpu_torch.train import ReduceLROnPlateau, TrainState, get_optimizer, init_train_state
from dad3dheads_tpu_torch.train.checkpoint import CheckpointManager
from dad3dheads_tpu_torch.train.loop import MetricAccumulator, Trainer

IMG = 64
MONITOR = "valid/metrics/reproject_nme_2d"


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """A checkpoint of the full-width model with its Adam state is ~0.4 GB:
    each test's directory goes when the test ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def state():
    return init_train_state({}, {"name": "adam", "lr": 1e-3}, torch.Generator().manual_seed(0), "cpu", 5.0)


def _bump(state: TrainState, value: float) -> None:
    with torch.no_grad():
        state.model.head["heatmap"].bias.fill_(value)


def _bias(path: str) -> float:
    return float(torch.load(path, weights_only=True)["model"]["head.heatmap.bias"][0])


@pytest.mark.parametrize("mode", ["min", "max"])
def test_checkpoint_top_k_last_and_restore(tmp_path, state, mode):
    """Top-k keeps the k best by the monitored value (files evicted), last
    holds the newest full state, a weights-only restore keeps the
    optimizer/step, the registry survives a new manager."""
    ck = CheckpointManager(str(tmp_path), monitor=MONITOR, mode=mode, save_top_k=2)
    values = [3.0, 1.0, 2.0, 0.5]
    for epoch, v in enumerate(values):
        _bump(state, float(epoch))
        state.step, state.epoch = 10 * epoch, epoch
        ck.save(state, epoch, {MONITOR: v})
    ck.save(state, 9, {})  # no monitored value: last only
    order = sorted(values) if mode == "min" else sorted(values, reverse=True)
    assert [e["value"] for e in ck._registry] == order[:2]
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["last.pt", "registry.json"] + [os.path.basename(e["path"]) for e in ck._registry])
    best_epoch = values.index(order[0])
    assert ck.best["epoch"] == best_epoch and _bias(ck.best["path"]) == best_epoch

    last = torch.load(ck.last_path, weights_only=True)
    assert (last["step"], last["epoch"]) == (30, 3) and "optimizer" in last
    _bump(state, -1.0)
    ck.restore(state)  # the best, weights only
    assert state.model.head["heatmap"].bias[0].item() == best_epoch and state.step == 30
    state.step = 0
    ck.restore_last(state)
    assert state.model.head["heatmap"].bias[0].item() == 3.0 and (state.step, state.epoch) == (30, 3)
    assert CheckpointManager(str(tmp_path), monitor=MONITOR, mode=mode).best_value() == order[0]


def test_checkpoint_hold_and_flush(tmp_path, state):
    """Held snapshots are copies (later training does not change them),
    keep the best k, and reach the top-k at flush without touching last."""
    ck = CheckpointManager(str(tmp_path), monitor=MONITOR, save_top_k=2)
    for epoch, v in enumerate([5.0, 4.0, 6.0, 3.0]):
        _bump(state, float(epoch))
        ck.hold(state, epoch, {MONITOR: v})
    ck.hold(state, 7, {})  # nothing to rank by: ignored
    _bump(state, 100.0)
    assert not os.path.exists(ck.last_path) and ck.best is None
    ck.flush_held()
    assert [e["epoch"] for e in ck._registry] == [3, 1]
    assert [_bias(e["path"]) for e in ck._registry] == [3.0, 1.0]
    assert not os.path.exists(ck.last_path)


def test_export_is_flax_msgpack(tmp_path, state):
    """The export reads back (without flax) as the model's flax variables."""
    ck = CheckpointManager(str(tmp_path))
    path = ck.export_inference(state)
    back = weights._flatten(weights.load_flax_msgpack(path))
    ref = weights._flatten(weights.flax_from_state_dict(state.model.state_dict()))
    assert set(back) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)


def test_metric_accumulator_means():
    acc = MetricAccumulator()
    assert acc.means() == {}
    for i in range(4):
        acc.add({"a": torch.tensor(float(i)), "b": torch.tensor(2.0 * i)})
    assert acc.means() == {"a": 1.5, "b": 3.0}


class _Loader:
    def __init__(self, steps: int, seed: int):
        self.flame, self.emb = FlameModel.load(), LandmarkEmbedding.load()
        self.steps, self.seed = steps, seed

    def __iter__(self):
        gen = torch.Generator().manual_seed(self.seed)
        for _ in range(self.steps):
            yield synthetic_batch(gen, self.flame, self.emb, 2, IMG)


def _config(tmp_path, **kw):
    return {"img_size": IMG, "experiment_dir": str(tmp_path / "exp"), "seed": 3, "max_epochs": 3,
            "optimizer": {"name": "adam", "lr": 1e-4}, "gradient_clip_val": 5.0,
            "scheduler": {"name": "plateau", "patience": 0, "factor": 0.5, "warmup_steps": 2},
            "sanity_val_steps": 1, **kw}


def test_fit_mid_epoch_validation_holds_and_early_stopping(tmp_path):
    """val_check_interval=1 validates after every step; checkpoints every 2
    epochs hold the improving epochs between; early stopping with patience
    1 ends the run; the plateau halves the LR; the export and the best
    evaluation happen."""
    config = _config(tmp_path, val_check_interval=1, checkpoint_every_n_epochs=2, early_stopping=1,
                     max_epochs=4)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))  # the tests run beside other test processes
    try:
        state = Trainer(config, _Loader(2, 0), _Loader(1, 1), device="cpu").fit()
    finally:
        torch.set_num_threads(threads)
    lines = [json.loads(s) for s in open(os.path.join(config["experiment_dir"], "metrics.jsonl"))]
    mid = [m for m in lines if "train/loss" not in m and MONITOR in m]
    epochs = [m for m in lines if "train/loss" in m]
    assert len(mid) == 2 * len(epochs)  # one validation per train step
    assert state.step == 2 * len(epochs)
    values = [m[MONITOR] for m in epochs]
    # early stopping (patience 1) ends the run at the first epoch that does not improve
    stopped = len(epochs) < 4
    assert all(b < a for a, b in zip(values, values[1:-1] if stopped else values[1:]))
    assert not stopped or values[-1] >= min(values[:-1])
    # the logged LR follows the plateau scheduler (patience 0) over the monitored values
    plateau, mult = ReduceLROnPlateau("min", 0.5, 0), 1.0
    for m in epochs:
        assert m["train/learning_rate"] == pytest.approx(1e-4 * mult)
        mult = plateau.step(m[MONITOR], 1e-4 * mult)
    ck = os.path.join(config["experiment_dir"], "checkpoints")
    registry = json.load(open(os.path.join(ck, "registry.json")))
    assert registry and all(os.path.isfile(e["path"]) for e in registry)
    assert os.path.isfile(os.path.join(ck, "last.pt")) and os.path.isfile(os.path.join(ck, "dad_3dnet.msgpack"))
    assert any("best/loss" in m for m in lines)


@pytest.mark.parametrize("key,value,error", [
    ("val_check_interval", 1.5, ValueError),
    ("check_val_every_n_epoch", 0, ValueError),
])
def test_trainer_refuses(tmp_path, key, value, error):
    with pytest.raises(error):
        Trainer(_config(tmp_path, **{key: value}), flame=FlameModel.load(), device="cpu")


def test_optimizer_state_round_trips_through_train_state(state):
    """TrainState.state_dict / load_state_dict carry the Adam moments."""
    opt = get_optimizer({"name": "adam", "lr": 1e-3}, state.model.parameters())
    for p in state.model.parameters():
        p.grad = torch.ones_like(p)
    opt.step(1.0)
    other = TrainState(state.model, get_optimizer({"name": "adam", "lr": 1e-3}, state.model.parameters()))
    other.load_state_dict(TrainState(state.model, opt, 5, 2).state_dict())
    assert (other.step, other.epoch) == (5, 2)
    a, b = opt.state_dict()["state"], other.optimizer.state_dict()["state"]
    assert all(torch.equal(a[i]["exp_avg"], b[i]["exp_avg"]) for i in a)


class _SignallingLoader(_Loader):
    """Sends this process SIGTERM after its first batch."""

    def __iter__(self):
        for i, batch in enumerate(super().__iter__()):
            yield batch
            if i == 0:
                os.kill(os.getpid(), signal.SIGTERM)


def test_fit_saves_last_on_sigterm(tmp_path):
    """SIGTERM during an epoch: the step in flight finishes, last is saved,
    fit returns, and the previous handler is back."""
    before = signal.getsignal(signal.SIGTERM)
    config = _config(tmp_path, sanity_val_steps=0)
    state = Trainer(config, _SignallingLoader(3, 0), None, device="cpu").fit()
    assert signal.getsignal(signal.SIGTERM) is before
    last = torch.load(os.path.join(config["experiment_dir"], "checkpoints", "last.pt"), weights_only=True)
    # the signal arrives while the prefetcher fetches the second batch, one
    # ahead of the first step: that step finishes, then the epoch ends early
    # (3 batches offered)
    assert state.step == last["step"] == 1 and last["epoch"] == 0
