"""Three train steps of the port against the JAX package's
``build_train_step`` on the CPU: one flax ``init`` carried across by
``dad3dheads_tpu_torch.weights``, one JAX-generated synthetic batch (64x64,
B = 8, its noise images replaced by seeded smooth ones), dropout 0, fp32,
Adam at lr 1e-4 with ``gradient_clip_val`` 5 and a warmup of 2 steps.

Each port step starts from the JAX state of the step before it (params,
batch_stats and the Adam mu/nu/count, through the state bridge). The two
trajectories cannot be compared free-running: this randomly initialised
network in train mode amplifies rounding (the JAX package parts its own
updates by up to 9.5% of their norm under a 1e-6 relative change of its
input images), and Adam's first steps are sign-like, so fp32 rounding alone
parts the JAX package from itself within three steps. Started from one
state, a step's losses, gradient norm, updated parameters, BN statistics and
optimizer state are held to the tolerances each test states.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax

from dad3dheads_tpu.constants import INPUT_IMAGE_KEY
from dad3dheads_tpu.core.flame import FlameModel as JaxFlame
from dad3dheads_tpu.core.landmarks import LandmarkEmbedding as JaxEmb
from dad3dheads_tpu.data import synthetic_batch as jax_synthetic_batch
from dad3dheads_tpu.models import create_model as jax_create_model
from dad3dheads_tpu.train import build_train_step as jax_build_train_step
from dad3dheads_tpu.train import get_optimizer as jax_get_optimizer
from dad3dheads_tpu.train import init_train_state as jax_init_train_state
from dad3dheads_tpu_torch import weights
from dad3dheads_tpu_torch.core import FlameModel
from dad3dheads_tpu_torch.models import create_model
from dad3dheads_tpu_torch.train import TrainState, build_train_step, get_optimizer

IMG, B, STEPS, LR, CLIP, WARMUP = 64, 8, 3, 1e-4, 5.0, 2
LOSS_KEYS = ("loss", "heatmap_loss", "vertices3d_loss", "reprojection_loss", "landmarks_loss")


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def _adam_state(opt_state):
    (adam,) = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
               if isinstance(s, optax.ScaleByAdamState)]
    return {"mu": _np(adam.mu), "nu": _np(adam.nu), "count": int(adam.count)}


def _variables(state):
    return {"params": _np(state.params), "batch_stats": _np(state.batch_stats)}


def _port_state(variables, adam, step):
    model = create_model({"dropout": 0.0})
    opt = get_optimizer({"name": "adam", "lr": LR}, model.parameters(), gradient_clip_val=CLIP)
    weights.train_state_from_flax(variables, adam, model, opt.optimizer)
    return TrainState(model, opt, step=step)


def _smooth_images(seed: int) -> np.ndarray:
    """Per-sample smooth fields with their own contrast and colour, plus
    noise: features that differ across the batch, as faces do."""
    rng = np.random.default_rng(seed)
    low = torch.from_numpy(rng.normal(size=(B, 3, 4, 4)).astype(np.float32))
    x = F.interpolate(low, size=(IMG, IMG), mode="bilinear", align_corners=False).permute(0, 2, 3, 1).numpy()
    x = x * rng.uniform(0.5, 2.0, size=(B, 1, 1, 1)) + rng.normal(size=(B, 1, 1, 3)) + 0.3 * rng.normal(size=x.shape)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def runs():
    """Per step: the JAX state before it, JAX's logs and state after it, and
    the port's logs and state after the same step from the same state."""
    jmodel = jax_create_model({"dropout": 0.0})
    tx = jax_get_optimizer({"name": "adam", "lr": LR}, gradient_clip_val=CLIP)
    state = jax_init_train_state(jmodel, tx, jax.random.PRNGKey(0), (1, IMG, IMG, 3))
    flame = JaxFlame.load()
    batch = dict(jax.jit(lambda r: jax_synthetic_batch(r, flame, JaxEmb.load(), B, IMG))(jax.random.PRNGKey(1)))
    batch[INPUT_IMAGE_KEY] = jnp.asarray(_smooth_images(3))
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}

    step = jax_build_train_step(jmodel, tx, img_size=IMG, warmup_steps=WARMUP)
    tstep = build_train_step(img_size=IMG, warmup_steps=WARMUP)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))  # the tests run beside other test processes
    try:
        return _steps(state, step, tstep, flame, FlameModel.load(), batch, tbatch)
    finally:
        torch.set_num_threads(threads)


def _steps(state, step, tstep, flame, tflame, batch, tbatch):
    nudged = {**batch, INPUT_IMAGE_KEY: batch[INPUT_IMAGE_KEY] * (1.0 + 1e-6)}
    out = []
    for i in range(STEPS):
        before = (_variables(state), _adam_state(state.opt_state))
        port = _port_state(*before, step=i)
        tlogs = {k: float(v) for k, v in tstep(port, tflame, tbatch).items()}
        copy = jax.tree_util.tree_map(jnp.copy, state)  # the step donates its state
        self_state, self_logs = step(copy, flame, nudged, jax.random.PRNGKey(2), jnp.ones((), jnp.float32))
        state, logs = step(state, flame, batch, jax.random.PRNGKey(2), jnp.ones((), jnp.float32))
        out.append({
            "before": before,
            "jax": ({k: float(v) for k, v in logs.items()}, _variables(state), _adam_state(state.opt_state)),
            "jax_nudged": ({k: float(v) for k, v in self_logs.items()}, _variables(self_state), _adam_state(self_state.opt_state)),
            "port": (tlogs, weights.flax_from_state_dict(port.model.state_dict()),
                     weights.flax_adam_state_from_port(port.optimizer.state_dict()["state"], port.model)),
        })
    return out


@pytest.mark.parametrize("key", LOSS_KEYS)
def test_losses_match_per_step(runs, key):
    """The total and each weighted loss, every step, from the same state:
    1e-4 relative (fp32 convolutions and reductions in another order)."""
    for i, r in enumerate(runs):
        t, j = r["port"][0][key], r["jax"][0][key]
        assert t == pytest.approx(j, rel=1e-4), (i, key, t, j)


def test_grad_norm_and_metrics_match_per_step(runs):
    """grad_norm (before clipping; above 5 here, so every step clips) at
    1e-2 relative: the gradient carries the train-mode network's
    amplification of rounding (the JAX package's own grad_norm moves by
    1.8e-4 to 6.0e-4 under the 1e-6 input nudge; the port reads 5.9e-5 to
    2.4e-3). The metric panel at 1e-3 relative."""
    for r in runs:
        t, j = r["port"][0], r["jax"][0]
        n = r["jax_nudged"][0]["grad_norm"]
        print(f"grad_norm rel gap port {t['grad_norm'] / j['grad_norm'] - 1:.2e}, JAX nudged {n / j['grad_norm'] - 1:.2e}")
        assert set(t) == set(j)
        assert j["grad_norm"] > CLIP
        assert t["grad_norm"] == pytest.approx(j["grad_norm"], rel=1e-2)
        for k in j:
            if k.startswith("metrics/"):
                assert t[k] == pytest.approx(j[k], rel=1e-3, abs=1e-6), k


def _update_gap(r, other):
    """L2 gap between ``other``'s update of the params and JAX's, and the
    L2 norm of JAX's update."""
    p0 = weights._flatten(r["before"][0]["params"])
    pj = weights._flatten(r["jax"][1]["params"])
    po = weights._flatten(r[other][1]["params"])
    assert set(p0) == set(pj) == set(po)
    gap = np.sqrt(sum(float(np.sum((po[k] - pj[k]) ** 2)) for k in p0))
    norm = np.sqrt(sum(float(np.sum((pj[k] - p0[k]) ** 2)) for k in p0))
    return gap, norm


def _state_gap(r, other, name):
    """Relative L2 gap of ``other``'s Adam ``name`` (mu or nu) to JAX's."""
    a, b = weights._flatten(r[other][2][name]), weights._flatten(r["jax"][2][name])
    gap = np.sqrt(sum(float(np.sum((a[k] - b[k]) ** 2)) for k in b))
    return gap / np.sqrt(sum(float(np.sum(b[k] ** 2)) for k in b))


def test_param_updates_match_per_step(runs):
    """The step's update of all parameters: the updates' L2 gap under 25% of
    JAX's update norm (a wrong warmup factor or clip is 100% or more), and
    the updates actually move the weights. The JAX package against itself,
    its input images moved by 1e-6 relative (``jax_nudged``), parts its
    updates by 9.5%, 2.9% and 0.8% of their norm over the three steps
    (Adam's first steps are sign-like, so an element whose gradient is at
    the rounding level flips); the port reads 14.9%, 3.8% and 2.3%."""
    for i, r in enumerate(runs):
        gap, norm = _update_gap(r, "port")
        self_gap, _ = _update_gap(r, "jax_nudged")
        print(f"step {i}: update gap port {gap / norm:.3%}, JAX nudged {self_gap / norm:.3%}")
        assert norm > 1e-3, (i, norm)
        assert gap <= 0.25 * norm, (i, gap, norm)


def test_batch_stats_match_per_step(runs):
    """BN running statistics after each train-mode forward (flax's momenta:
    0.9 in the ResNet, 0.0003 in the BiFPN; biased variance): 1e-3 of each
    tensor's largest value."""
    for i, r in enumerate(runs):
        ref = weights._flatten(r["jax"][1]["batch_stats"])
        got = weights._flatten(r["port"][1]["batch_stats"])
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], atol=1e-3 * np.abs(ref[k]).max(), err_msg=(i, k))


def test_adam_state_matches_per_step(runs):
    """count equal; mu (the running mean of the clipped gradient) within 10%
    of its L2 norm per step, nu within 20%. The JAX package's own Adam state
    moves by 1.1-1.6% (mu) and 1.1-1.9% (nu) of its norm when its input
    images move by 1e-6 relative (``jax_nudged``): the train-mode network's
    amplification of rounding at this size. The port reads 2.0-2.8% and
    1.9-3.7%."""
    for i, r in enumerate(runs):
        ref, got = r["jax"][2], r["port"][2]
        assert got["count"] == ref["count"] == i + 1
        for name, tol in (("mu", 0.1), ("nu", 0.2)):
            gap = _state_gap(r, "port", name)
            print(f"step {i}: {name} gap port {gap:.3%}, JAX nudged {_state_gap(r, 'jax_nudged', name):.3%}")
            assert gap <= tol, (i, name, gap)


def test_train_state_bridge_round_trip(runs):
    """The JAX train state after three steps -> the port's model and Adam ->
    back: every leaf identical, and torch's Adam reads the state."""
    final = runs[-1]["jax"]
    variables, adam = final[1], final[2]
    port = _port_state(variables, adam, STEPS)
    back_vars = weights._flatten(weights.flax_from_state_dict(port.model.state_dict()))
    for k, v in weights._flatten(variables).items():
        np.testing.assert_array_equal(back_vars[k], v, err_msg=k)
    state = port.optimizer.state_dict()["state"]
    assert len(state) == len(list(port.model.parameters()))
    assert all(float(s["step"]) == STEPS for s in state.values())
    back = weights.flax_adam_state_from_port(state, port.model)
    assert back["count"] == adam["count"]
    for name in ("mu", "nu"):
        ref, out = weights._flatten(adam[name]), weights._flatten(back[name])
        assert set(ref) == set(out)
        for k in ref:
            np.testing.assert_array_equal(out[k], ref[k], err_msg=(name, k))
