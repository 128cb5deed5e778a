"""Two train steps of the port's mobilenet_w1 DAD-3DNet against the JAX
package's ``build_train_step`` on the CPU, as ``test_torch_train_step.py``
holds the resnet50 network: one flax ``init`` (``model.backbone =
mobilenet_w1``) carried across by ``dad3dheads_tpu_torch.weights``, one
JAX-generated synthetic batch (64x64, B = 8, smooth seeded images), dropout
0, fp32, Adam at lr 1e-4 with ``gradient_clip_val`` 5 and a warmup of 2
steps.

Each port step starts from the JAX state of the step before it (params,
batch_stats and the Adam mu/nu/count, through the state bridge), and its
losses, gradient norm, parameter updates, BN statistics and Adam state are
held to that file's tolerances. The JAX package's own step on images nudged
by 1e-6 relative is printed beside each gap: the random-init network in
train mode amplifies rounding.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

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

from .test_torch_train_step import (
    B,
    CLIP,
    IMG,
    LOSS_KEYS,
    LR,
    WARMUP,
    _adam_state,
    _smooth_images,
    _state_gap,
    _update_gap,
    _variables,
)

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "train.yaml")
STEPS = 2
MODEL = {"backbone": "mobilenet_w1", "dropout": 0.0}


def _port_state(variables, adam, step):
    model = create_model(MODEL)
    opt = get_optimizer({"name": "adam", "lr": LR}, model.parameters(), gradient_clip_val=CLIP)
    weights.train_state_from_flax(variables, adam, model, opt.optimizer)
    return TrainState(model, opt, step=step)


@pytest.fixture(scope="module")
def runs():
    """Per step: the JAX state before it, JAX's logs and state after it (and
    after the same step on nudged images), and the port's logs and state
    after the same step from the same state."""
    jmodel = jax_create_model(MODEL)
    tx = jax_get_optimizer({"name": "adam", "lr": LR}, gradient_clip_val=CLIP)
    state = jax_init_train_state(jmodel, tx, jax.random.PRNGKey(0), (1, IMG, IMG, 3))
    flame = JaxFlame.load()
    batch = dict(jax.jit(lambda r: jax_synthetic_batch(r, flame, JaxEmb.load(), B, IMG))(jax.random.PRNGKey(1)))
    batch[INPUT_IMAGE_KEY] = jnp.asarray(_smooth_images(3))
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    nudged = {**batch, INPUT_IMAGE_KEY: batch[INPUT_IMAGE_KEY] * (1.0 + 1e-6)}

    step = jax_build_train_step(jmodel, tx, img_size=IMG, warmup_steps=WARMUP)
    tstep = build_train_step(img_size=IMG, warmup_steps=WARMUP)
    tflame = FlameModel.load()
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))  # the tests run beside other test processes
    out = []
    try:
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
                "jax_nudged": ({k: float(v) for k, v in self_logs.items()}, _variables(self_state),
                               _adam_state(self_state.opt_state)),
                "port": (tlogs, weights.flax_from_state_dict(port.model.state_dict()),
                         weights.flax_adam_state_from_port(port.optimizer.state_dict()["state"], port.model)),
            })
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.mark.parametrize("key", LOSS_KEYS)
def test_losses_match_per_step(runs, key):
    """The total and each weighted loss, every step, from the same state:
    1e-4 relative."""
    for i, r in enumerate(runs):
        t, j = r["port"][0][key], r["jax"][0][key]
        assert t == pytest.approx(j, rel=1e-4), (i, key, t, j)


def test_grad_norm_and_metrics_match_per_step(runs):
    """grad_norm (before clipping) at 1e-2 relative, the metric panel at
    1e-3 relative."""
    for r in runs:
        t, j = r["port"][0], r["jax"][0]
        n = r["jax_nudged"][0]["grad_norm"]
        print(f"grad_norm rel gap port {t['grad_norm'] / j['grad_norm'] - 1:.2e}, JAX nudged {n / j['grad_norm'] - 1:.2e}")
        assert set(t) == set(j)
        assert t["grad_norm"] == pytest.approx(j["grad_norm"], rel=1e-2)
        for k in j:
            if k.startswith("metrics/"):
                assert t[k] == pytest.approx(j[k], rel=1e-3, abs=1e-6), k


def test_param_updates_match_per_step(runs):
    """The step's update of all parameters: the updates' L2 gap under 25% of
    JAX's update norm, and the updates move the weights."""
    for i, r in enumerate(runs):
        gap, norm = _update_gap(r, "port")
        self_gap, _ = _update_gap(r, "jax_nudged")
        print(f"step {i}: update gap port {gap / norm:.3%}, JAX nudged {self_gap / norm:.3%}")
        assert norm > 1e-3, (i, norm)
        assert gap <= 0.25 * norm, (i, gap, norm)


def test_batch_stats_match_per_step(runs):
    """BN running statistics after each train-mode forward (flax's momenta:
    0.9 in the 27 BNs of the MobileNet, 0.0003 in the BiFPN; biased
    variance): 1e-3 of each tensor's largest value."""
    for i, r in enumerate(runs):
        ref = weights._flatten(r["jax"][1]["batch_stats"])
        got = weights._flatten(r["port"][1]["batch_stats"])
        assert set(got) == set(ref)
        assert sum(k.startswith("encoder/") and k.endswith("/mean") for k in ref) == 27
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], atol=1e-3 * np.abs(ref[k]).max(), err_msg=(i, k))


def test_adam_state_matches_per_step(runs):
    """count equal; mu within 10% of its L2 norm per step, nu within 20%."""
    for i, r in enumerate(runs):
        ref, got = r["jax"][2], r["port"][2]
        assert got["count"] == ref["count"] == i + 1
        for name, tol in (("mu", 0.1), ("nu", 0.2)):
            gap = _state_gap(r, "port", name)
            print(f"step {i}: {name} gap port {gap:.3%}, JAX nudged {_state_gap(r, 'jax_nudged', name):.3%}")
            assert gap <= tol, (i, name, gap)


def test_train_state_bridge_round_trip(runs):
    """The JAX mobilenet train state after two steps -> the port's model and
    Adam -> back: every leaf identical; a resnet50 model refuses it."""
    final = runs[-1]["jax"]
    variables, adam = final[1], final[2]
    port = _port_state(variables, adam, STEPS)
    back_vars = weights._flatten(weights.flax_from_state_dict(port.model.state_dict()))
    for k, v in weights._flatten(variables).items():
        np.testing.assert_array_equal(back_vars[k], v, err_msg=k)
    back = weights.flax_adam_state_from_port(port.optimizer.state_dict()["state"], port.model)
    assert back["count"] == adam["count"]
    for name in ("mu", "nu"):
        ref, out = weights._flatten(adam[name]), weights._flatten(back[name])
        assert set(ref) == set(out)
        for k in ref:
            np.testing.assert_array_equal(out[k], ref[k], err_msg=(name, k))
    resnet = create_model({"dropout": 0.0})
    opt = get_optimizer({"name": "adam", "lr": LR}, resnet.parameters(), gradient_clip_val=CLIP)
    with pytest.raises(ValueError, match="mobilenet_w1.*resnet50"):
        weights.train_state_from_flax(variables, adam, resnet, opt.optimizer)


def test_cli_trains_mobilenet_to_an_export_its_predictor_loads(tmp_path):
    """``cli.train --synthetic 2 --device cpu model.backbone=mobilenet_w1``
    at 64x64: the export holds the mobilenet tree, the mobilenet predictor
    loads it and serves finite outputs, and a resnet50 predictor refuses it
    with the backbone-mismatch error."""
    from dad3dheads_tpu_torch.api import FaceMeshPredictor
    from dad3dheads_tpu_torch.cli.train import main

    exp = tmp_path / "exp"
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        main(["--config", CONFIG, "--synthetic", "2", "--device", "cpu", f"img_size={IMG}",
              "batch_size=2", "max_epochs=1", "model.backbone=mobilenet_w1", f"experiment_dir={exp}"])
        path = str(exp / "checkpoints" / "dad_3dnet.msgpack")
        tree = weights.load_flax_msgpack(path)
        assert weights.flax_backbone(tree) == "mobilenet_w1"
        assert set(weights._flatten(tree)) == set(weights.name_map("mobilenet_w1"))
        pred = FaceMeshPredictor({"img_size": IMG, "model": {"backbone": "mobilenet_w1"}}, checkpoint_path=path,
                                 device="cpu", require_weights=True)
        out = pred.predict_batch(np.random.default_rng(4).integers(0, 256, (2, IMG, IMG, 3), dtype=np.uint8))
        assert out["3dmm_params"].shape == (2, 413) and all(np.isfinite(v).all() for v in out.values())
        with pytest.raises(ValueError, match="mobilenet_w1.*resnet50"):
            FaceMeshPredictor({"img_size": IMG}, checkpoint_path=path, device="cpu")
    finally:
        torch.set_num_threads(threads)
