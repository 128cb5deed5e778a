"""The port's optimizers, clipping and schedules against the JAX package's
optax chains and host schedulers, on the same numpy gradients and metric
sequences."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from dad3dheads_tpu.train import optimizers as joptim
from dad3dheads_tpu.train import schedulers as jsched
from dad3dheads_tpu_torch.train import optimizers as toptim
from dad3dheads_tpu_torch.train import schedulers as tsched

SHAPES = ((3, 4), (5,), (2, 3, 2), (4,))
ZERO_LEAF = 3  # starts at zeros: lamb's trust ratio takes its zero branch


def _grads(seed: int, steps: int):
    rng = np.random.default_rng(seed)
    return [[(rng.normal(size=s) * rng.uniform(0.1, 3.0)).astype(np.float32) for s in SHAPES] for _ in range(steps)]


OPTIMIZERS = [
    {"name": "adam", "lr": 1e-2},
    {"name": "adam", "lr": 1e-2, "weight_decay": 1e-2},
    {"name": "adamw", "lr": 1e-2, "weight_decay": 1e-2},
    {"name": "sgd", "lr": 1e-2},
    {"name": "sgd", "lr": 1e-2, "nesterov": True, "weight_decay": 1e-3},
    {"name": "sgd", "lr": 1e-2, "momentum": 0.0},
    {"name": "radam", "lr": 1e-2},
    {"name": "lamb", "lr": 1e-2},
    {"name": "lamb", "lr": 1e-2, "weight_decay": 1e-2},
]


@pytest.mark.parametrize("clip", [0.0, 2.0])
@pytest.mark.parametrize("config", OPTIMIZERS, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_optimizer_matches_optax(config, clip):
    """Eight steps on the same gradients with a per-step update scale (the
    train step's warmup x LR multiplier; lr 1e-2, so a step moves a weight
    by ~1e-2): parameters within 1e-6 absolute (fp32 rounding of eight
    updates; radam 1e-5: torch adds eps to sqrt(nu) before the bias
    correction, optax after it), the pre-clip global norm at 1e-6
    relative. One parameter starts at zeros (lamb's trust ratio is 1 where
    a norm is 0)."""
    rng = np.random.default_rng(40)
    init = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    init[ZERO_LEAF] = np.zeros_like(init[ZERO_LEAF])
    scales = [0.25, 0.5, 0.75, 1.0, 1.0, 0.5, 1.0, 1.0]
    grads = _grads(41, len(scales))

    tx = joptim.get_optimizer(dict(config), gradient_clip_val=clip)
    jparams = [jnp.asarray(p) for p in init]
    state = tx.init(jparams)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    opt = toptim.get_optimizer(dict(config), params, gradient_clip_val=clip)
    for g, s in zip(grads, scales):
        jg = [jnp.asarray(x) for x in g]
        updates, state = tx.update(jg, state, jparams)
        jparams = optax.apply_updates(jparams, jax.tree_util.tree_map(lambda u: u * s, updates))
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x.copy())
        norm = opt.step(s)
        assert float(norm) == pytest.approx(float(optax.global_norm(jg)), rel=1e-6)
    atol = 1e-5 if config["name"] == "radam" else 1e-6
    for p, j in zip(params, jparams):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), rtol=0, atol=atol)


def test_clip_by_global_norm_matches_optax():
    """Above the bound: g / norm * max_norm (1e-6 relative); below it the
    gradients are untouched, bit for bit."""
    for seed, max_norm in ((42, 1.0), (43, 1e3)):
        g = _grads(seed, 1)[0]
        ref, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(x) for x in g], optax.EmptyState())
        got = [torch.from_numpy(x.copy()) for x in g]
        norm = toptim.clip_by_global_norm_(got, max_norm)
        assert float(norm) == pytest.approx(float(optax.global_norm([jnp.asarray(x) for x in g])), rel=1e-6)
        for a, b, x in zip(got, ref, g):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
            if max_norm > float(norm):
                np.testing.assert_array_equal(a.numpy(), x)


def test_lamb_and_unknown_optimizers_refused():
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(KeyError):
        toptim.get_optimizer({"name": "adagrad"}, p)


SCHEDULES = [
    {"name": "multi_step", "milestones": [2, 5], "gamma": 0.3},
    {"name": "exponential", "gamma": 0.9},
    {"name": "cosine", "T_max": 7, "eta_min": 0.01},
    {"name": "cyclic", "base_lr": 0.01, "max_lr": 0.1, "step_size_up": 3},
    {"name": "flat_cosine", "T_max": 9, "T_flat": 3, "eta_min": 0.001, "warmup_steps": 400},
]


@pytest.mark.parametrize("steps_per_epoch", [1, 4])
@pytest.mark.parametrize("config", SCHEDULES, ids=lambda c: c["name"])
def test_schedule_matches_jax(config, steps_per_epoch):
    """Every step over past the schedule's end: 1e-6 relative."""
    ref = jsched.get_schedule(dict(config), 0.1, steps_per_epoch)
    out = tsched.get_schedule(dict(config), 0.1, steps_per_epoch)
    for step in range(0, 12 * steps_per_epoch):
        assert out(step) == pytest.approx(float(ref(step)), rel=1e-6, abs=1e-9), step


def test_no_schedule_for_plateau_or_none():
    assert tsched.get_schedule(None, 1.0) is None
    assert tsched.get_schedule({"name": "plateau", "patience": 3}, 1.0) is None
    with pytest.raises(KeyError):
        tsched.get_schedule({"name": "nope"}, 1.0)


def test_warmup_factor_matches_jax():
    for warmup in (0, 1, 400):
        for step in (0, 1, 5, 399, 400, 1000):
            assert tsched.warmup_factor(step, warmup) == pytest.approx(float(jsched.warmup_factor(step, warmup)))


METRICS = [5.0, 4.0, 4.0, 4.1, 3.9996, 4.2, 4.0, 3.0, 3.5, 3.6, 3.7, 3.8, 3.9, 4.0, 2.0]


@pytest.mark.parametrize("mode", ["min", "max"])
def test_plateau_and_early_stopping_match_jax(mode):
    """The same multiplier and stop decision after every epoch of a scripted
    metric sequence."""
    seq = METRICS if mode == "min" else [-m for m in METRICS]
    jp = jsched.ReduceLROnPlateau(mode=mode, factor=0.5, patience=2, min_lr=1e-3)
    tp = tsched.ReduceLROnPlateau(mode=mode, factor=0.5, patience=2, min_lr=1e-3)
    je, te = jsched.EarlyStopping(patience=3, mode=mode, min_delta=0.01), tsched.EarlyStopping(3, mode, 0.01)
    lr = 0.01
    for value in seq:
        jm, tm = jp.step(value, lr), tp.step(value, lr)
        assert tm == jm
        lr = 0.01 * tm
        assert te.step(value) == je.step(value)
    assert tp.multiplier < 1.0
