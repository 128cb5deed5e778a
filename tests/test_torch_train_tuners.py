"""The port's ``auto_lr`` and ``auto_bs`` against the JAX package's
``Trainer.tune_lr`` and ``tune_batch_size``, with no network run on either
side: both trainers are built on the tiny parts and their ``_fresh_state``
and ``train_step`` are stubbed with scripted losses and a scripted
out-of-memory limit. Then a tiny port ``fit`` with both tuners and
``check_val_every_n_epoch=2`` (as the JAX package's ``test_trainer_auto_knobs``
runs it), whose TensorBoard scalars read back as ``metrics.jsonl`` has
them."""

import json
import math
import os

import numpy as np
import pytest
import torch

from dad3dheads_tpu_torch.core import FlameModel, LandmarkEmbedding
from dad3dheads_tpu_torch.data.synthetic import synthetic_batch
from dad3dheads_tpu_torch.train.loop import Trainer

B0 = 8  # divides the JAX package's 8-device CPU mesh: its probes need no padding

LOSSES = {
    "diverges": [5.0, 4.0, 3.2, 2.6, 2.3, 2.2, 2.4, 3.5, 9.0, 40.0, 400.0, 4e3],
    "nan": [5.0, 4.5, 3.9, 3.0, 2.7, 2.5, math.nan, 1.0, 1.0, 1.0, 1.0, 1.0],
    "too_few": [5.0, 4.0, math.nan] + [1.0] * 9,
    "flat": [3.0, 2.0, 1.5, 1.2, 1.1, 1.05, 1.0, 0.99, 0.98, 0.97, 0.96, 0.95],
}


class _Loader:
    """Host batches: one array whose leading axis is the batch and, with
    ``names``, a list of names, as the port's disk loader's batches carry
    (the JAX package's device placement takes arrays only)."""

    def __init__(self, names: bool, batch: int = B0, steps: int = 3):
        self.names, self.batch, self.steps = names, batch, steps

    def __iter__(self):
        for i in range(self.steps):
            batch = {"x": np.full((self.batch, 3), i, np.float32)}
            if self.names:
                batch["names"] = [f"item{j}" for j in range(self.batch)]
            yield batch


def _config(tmp_path, warmup: int):
    return {"img_size": 64, "max_epochs": 1, "experiment_dir": str(tmp_path / "exp"),
            "optimizer": {"name": "adam", "lr": 1e-4}, "scheduler": {"warmup_steps": warmup}}


@pytest.fixture(scope="module")
def jax_parts():
    import jax  # noqa: F401 -- tests/conftest.py has put JAX on the CPU
    from dad3dheads_tpu.core.flame import FlameModel as JaxFlame
    from dad3dheads_tpu.models import create_model

    return create_model({"backbone": "resnet50"}), JaxFlame.load()


@pytest.fixture(scope="module")
def flame():
    return FlameModel.load()


def _trainers(tmp_path, jax_parts, flame, warmup: int):
    from dad3dheads_tpu.train.loop import Trainer as JaxTrainer

    model, jflame = jax_parts
    config = _config(tmp_path, warmup)
    jt = JaxTrainer(model, {**config, "experiment_dir": str(tmp_path / "jax")}, _Loader(False), None, flame=jflame)
    pt = Trainer(config, _Loader(True), None, flame=flame, device="cpu")
    jt._fresh_state = pt._fresh_state = lambda seed=17: "throwaway"
    return jt, pt


@pytest.mark.parametrize("warmup", [0, 400])
@pytest.mark.parametrize("script", sorted(LOSSES))
def test_tune_lr_matches_jax(tmp_path, jax_parts, flame, script, warmup):
    """The same learning-rate factor at every step (warmup cancelled; the
    JAX step reads it as float32), the same stop and the same suggestion."""
    import jax.numpy as jnp

    jt, pt = _trainers(tmp_path, jax_parts, flame, warmup)
    seen = {"jax": [], "port": []}

    def jax_step(state, flame, batch, rng, factor):
        seen["jax"].append(float(factor))
        return state, {"loss": jnp.asarray(LOSSES[script][len(seen["jax"]) - 1], jnp.float32)}

    def port_step(state, flame, batch, lr_mult):
        assert state == "throwaway" and batch["x"].shape == (B0, 3)
        seen["port"].append(float(np.float32(lr_mult)))
        return {"loss": torch.tensor(LOSSES[script][len(seen["port"]) - 1], dtype=torch.float32)}

    jt.train_step, pt.train_step = jax_step, port_step
    kw = dict(num_steps=len(LOSSES[script]), min_lr=1e-6, max_lr=1.0)
    ref, out = jt.tune_lr(**kw), pt.tune_lr(**kw)
    assert seen["port"] == seen["jax"] and len(seen["port"]) >= 3
    assert out == ref
    if script == "too_few":
        assert out == pt.base_lr == 1e-4
    assert pt.base_lr == 1e-4  # the trainer itself is untouched


class _OutOfMemory:
    """A step that runs out of memory above ``limit`` rows, as each package
    reports it; records the batches probed."""

    def __init__(self, limit: int):
        self.limit, self.probed = limit, []

    def check(self, n: int) -> None:
        self.probed.append(n)
        if n > self.limit:
            raise RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to allocate")


@pytest.mark.parametrize("limit,max_trials,cap", [(16, 6, 8192), (10**6, 6, 32), (10**6, 2, 8192), (4, 6, 8192)])
def test_tune_batch_size_matches_jax(tmp_path, jax_parts, flame, limit, max_trials, cap):
    """The batches probed and the result equal the JAX package's: doubling
    from the loader's batch, stopping at the first out-of-memory step, at
    the cap or after ``max_trials``. The port's probes tile the array and
    repeat the list of names."""
    import jax.numpy as jnp

    jt, pt = _trainers(tmp_path, jax_parts, flame, 0)
    jax_oom, port_oom = _OutOfMemory(limit), _OutOfMemory(limit)

    def jax_step(state, flame, batch, rng, factor):
        jax_oom.check(int(batch["x"].shape[0]))
        return state, {"loss": jnp.zeros(())}

    def port_step(state, flame, batch, lr_mult):
        n = int(batch["x"].shape[0])
        assert batch["names"] == [f"item{j % B0}" for j in range(n)]
        if n > limit:
            port_oom.probed.append(n)
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        port_oom.check(n)
        return {"loss": torch.zeros(())}

    jt.train_step, pt.train_step = jax_step, port_step
    ref = jt.tune_batch_size(max_trials=max_trials, max_batch_size=cap)
    out = pt.tune_batch_size(max_trials=max_trials, max_batch_size=cap)
    assert port_oom.probed == jax_oom.probed and out == ref
    assert out == (B0 if limit < B0 else min(limit, cap, B0 * 2 ** (max_trials - 1)))


def test_tune_batch_size_raises_other_errors(tmp_path, jax_parts, flame):
    """An error that is not running out of memory propagates from both."""
    jt, pt = _trainers(tmp_path, jax_parts, flame, 0)

    def broken(*args):
        raise ValueError("the step is broken")

    jt.train_step = pt.train_step = broken
    for trainer in (jt, pt):
        with pytest.raises(ValueError, match="broken"):
            trainer.tune_batch_size()


class _Synthetic:
    def __init__(self, batch: int, steps: int, seed: int, flame, emb):
        self.batch, self.steps, self.seed, self.flame, self.emb = batch, steps, seed, flame, emb
        self.sizes = []

    def set_batch_size(self, batch: int) -> None:
        self.sizes.append(batch)
        self.batch = batch

    def __iter__(self):
        gen = torch.Generator().manual_seed(self.seed)
        for _ in range(self.steps):
            yield synthetic_batch(gen, self.flame, self.emb, self.batch, 64)


def test_fit_with_both_tuners_and_tensorboard(tmp_path, flame):
    """auto_bs (one doubling from 2), auto_lr (6 steps) on throwaway states,
    then 2 epochs of 2 steps with validation every second epoch; the loaders
    take the tuned batch; TensorBoard holds the scalars of metrics.jsonl,
    with its steps."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    emb = LandmarkEmbedding.load()
    train, val = _Synthetic(2, 2, 0, flame, emb), _Synthetic(2, 1, 9, flame, emb)
    config = {"img_size": 64, "max_epochs": 2, "optimizer": {"name": "adam", "lr": 1e-4},
              "experiment_dir": str(tmp_path / "exp"), "sanity_val_steps": 0, "auto_lr": True,
              "auto_lr_steps": 6, "auto_bs": True, "auto_bs_max_trials": 2, "auto_bs_max": 4,
              "check_val_every_n_epoch": 2, "eval_best": False}
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))  # the tests run beside other test processes
    try:
        trainer = Trainer(config, train, val, flame=flame, device="cpu")
        state = trainer.fit()
    finally:
        torch.set_num_threads(threads)
    assert trainer.tuned_batch_size == 4 and train.sizes == val.sizes == [4]
    assert trainer.tuned_lr is not None and 1e-6 <= trainer.tuned_lr <= 1.0
    assert state.step == 4  # the tuners' steps ran on throwaway states
    with open(tmp_path / "exp" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    epochs = [r for r in rows if "train/loss" in r]
    assert len(epochs) == 2 and "valid/loss" not in epochs[0] and "valid/loss" in epochs[1]
    assert epochs[0]["train/learning_rate"] == pytest.approx(trainer.tuned_lr)

    acc = EventAccumulator(os.path.join(config["experiment_dir"], "tb"))
    acc.Reload()
    logged = {}
    for tag in acc.Tags()["scalars"]:
        logged[tag] = [(e.step, e.value) for e in acc.Scalars(tag)]
    expected = {}
    for r in rows:
        for k, v in r.items():
            if k != "step":
                expected.setdefault(k, []).append((r["step"], float(np.float32(v))))
    assert set(logged) == set(expected)
    for tag, points in expected.items():
        assert [s for s, _ in logged[tag]] == [s for s, _ in points], tag
        np.testing.assert_array_equal([v for _, v in logged[tag]], [v for _, v in points], err_msg=tag)
