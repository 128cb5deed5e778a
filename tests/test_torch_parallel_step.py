"""The port's data-parallel train step on two gloo ranks against the JAX
package's ``build_train_step`` on a ``make_mesh(data=2)`` mesh of two of the
virtual CPU devices, where XLA shards the batch and inserts the gradient
all-reduce and the global-batch BN statistics.

One seeded mobilenet_w1 (dropout 0: JAX draws one mask for the global
batch from one key, each port rank would draw its own), made into the JAX
train state through ``dad3dheads_tpu_torch.weights`` (a flax ``init`` would
take 15 s here); one synthetic batch (64x64, global B = 4, smooth seeded
images), each port rank taking two rows; Adam at lr 1e-4 with
``gradient_clip_val`` 5 and a warmup of 2 steps. One step from the same
state: its losses, gradient norm, metrics, parameter update, BN statistics
and Adam state are held to the tolerances of
``test_torch_train_mobilenet.py``, and the step-0 loss to 1e-5.

Also the predictor's ``mesh=`` on two CPU devices against the JAX
predictor's on the same ``data=2`` mesh, from one checkpoint.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dad3dheads_tpu.api import predictor as jpred
from dad3dheads_tpu.constants import INPUT_IMAGE_KEY
from dad3dheads_tpu.core.flame import FlameModel as JaxFlame
from dad3dheads_tpu.models import create_model as jax_create_model
from dad3dheads_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dad3dheads_tpu.parallel.mesh import replicate as jax_replicate
from dad3dheads_tpu.parallel.mesh import shard_batch as jax_shard_batch
from dad3dheads_tpu.train import build_train_step as jax_build_train_step
from dad3dheads_tpu.train import get_optimizer as jax_get_optimizer
from dad3dheads_tpu.train.state import TrainState as JaxTrainState
from dad3dheads_tpu_torch import weights
from dad3dheads_tpu_torch.api import FaceMeshPredictor
from dad3dheads_tpu_torch.core import FlameModel, LandmarkEmbedding
from dad3dheads_tpu_torch.data.synthetic import synthetic_batch
from dad3dheads_tpu_torch.models import create_model
from dad3dheads_tpu_torch.parallel import make_mesh

from .test_torch_frames import assert_predictions_close, frame_list
from .test_torch_mobilenet import _seeded_variables
from .test_torch_train_step import CLIP, IMG, LOSS_KEYS, LR, WARMUP, _adam_state, _smooth_images, _state_gap
from .test_torch_train_step import _update_gap, _variables
from .torch_parallel_worker import World

GLOBAL_B = 4
MODEL = {"backbone": "mobilenet_w1", "dropout": 0.0}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX state before the step, JAX's logs and state after it on the
    data=2 mesh, and the two port ranks' (rank 0's state; the logs are
    the global batch's on both)."""
    work = tmp_path_factory.mktemp("dp_step")
    start = create_model(MODEL, torch.Generator().manual_seed(0)).state_dict()
    torch.save(start, work / "state.pt")
    tbatch = synthetic_batch(torch.Generator().manual_seed(1), FlameModel.load(), LandmarkEmbedding.load(), GLOBAL_B,
                             IMG)
    tbatch[INPUT_IMAGE_KEY] = torch.from_numpy(_smooth_images(3)[:GLOBAL_B])
    torch.save(tbatch, work / "batch.pt")

    spec = {"model": MODEL, "optimizer": {"name": "adam", "lr": LR}, "clip": CLIP, "warmup": WARMUP,
            "img_size": IMG}
    ranks = World("step", str(work), spec=spec)  # runs while JAX compiles its step

    jmodel = jax_create_model(MODEL)
    tx = jax_get_optimizer({"name": "adam", "lr": LR}, gradient_clip_val=CLIP)
    variables = jax.tree_util.tree_map(jnp.asarray, weights.flax_from_state_dict(start))
    state = JaxTrainState.create(variables["params"], variables["batch_stats"], tx)
    before = (_variables(state), _adam_state(state.opt_state))
    flame = JaxFlame.load()
    batch = {k: jnp.asarray(v.numpy()) for k, v in tbatch.items()}
    mesh = jax_make_mesh(jax.devices()[:2], data=2)
    step = jax_build_train_step(jmodel, tx, img_size=IMG, warmup_steps=WARMUP)
    new, logs = step(jax_replicate(state, mesh), jax_replicate(flame, mesh), jax_shard_batch(batch, mesh),
                     jax.random.PRNGKey(2), jnp.ones((), jnp.float32))
    ranks = ranks.results(timeout=240)
    out = ranks[0]["step"]
    model = create_model(MODEL)
    return {
        "before": before,
        "jax": ({k: float(v) for k, v in logs.items()}, _variables(new), _adam_state(new.opt_state)),
        "port": (out["logs"][0], weights.flax_from_state_dict(out["state_dict"]),
                 weights.flax_adam_state_from_port(out["optimizer"]["state"], model)),
        "rank1_logs": ranks[1]["step"]["logs"][0],
    }


def test_step0_loss_matches_the_jax_data_parallel_step(run):
    """The global batch's loss: 1e-5 relative (the batch-mean loss is
    invariant to the split; collectives reorder sums at ~1e-7). Both ranks
    log the same global means."""
    t, j = run["port"][0]["loss"], run["jax"][0]["loss"]
    print(f"step-0 loss port {t:.8f} JAX {j:.8f} rel {abs(t - j) / abs(j):.2e}")
    assert t == pytest.approx(j, rel=1e-5)
    assert run["rank1_logs"] == run["port"][0]


@pytest.mark.parametrize("key", LOSS_KEYS)
def test_losses_match(run, key):
    """The total and each weighted loss: 1e-4 relative."""
    assert run["port"][0][key] == pytest.approx(run["jax"][0][key], rel=1e-4), key


def test_grad_norm_and_metrics_match(run):
    """grad_norm of the all-reduced gradient (before clipping) at 1e-2
    relative, the metric panel at 1e-3 relative."""
    t, j = run["port"][0], run["jax"][0]
    assert set(t) == set(j)
    assert t["grad_norm"] == pytest.approx(j["grad_norm"], rel=1e-2)
    for k in j:
        if k.startswith("metrics/"):
            assert t[k] == pytest.approx(j[k], rel=1e-3, abs=1e-6), k


def test_param_update_matches(run):
    """The update of all parameters: L2 gap under 25% of JAX's update norm,
    and the update moves the weights."""
    gap, norm = _update_gap(run, "port")
    print(f"update gap {gap / norm:.3%}")
    assert norm > 1e-3 and gap <= 0.25 * norm, (gap, norm)


def test_global_batch_stats_match(run):
    """BN running statistics after the global-batch forward (flax's momenta,
    biased variance over the global count): 1e-3 of each tensor's largest
    value."""
    ref = weights._flatten(run["jax"][1]["batch_stats"])
    got = weights._flatten(run["port"][1]["batch_stats"])
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-3 * np.abs(ref[k]).max(), err_msg=k)


def test_adam_state_matches(run):
    """count equal; mu within 10% of its L2 norm, nu within 20%."""
    assert run["port"][2]["count"] == run["jax"][2]["count"] == 1
    for name, tol in (("mu", 0.1), ("nu", 0.2)):
        gap = _state_gap(run, "port", name)
        print(f"{name} gap {gap:.3%}")
        assert gap <= tol, (name, gap)


def test_predictor_mesh_matches_the_jax_mesh_predictor(tmp_path):
    """``FaceMeshPredictor(mesh=make_mesh([cpu, cpu]))`` against the JAX
    predictor on a ``data=2`` mesh of two virtual CPU devices, from one
    seeded mobilenet_w1 checkpoint at 64x64. predict_batch on B = 5 (both
    pad to 6, split, and drop the pad): 3DMM and 3D vertices atol 1e-4,
    points and projected vertices 1e-2 px (``test_torch_mobilenet.py``'s
    bounds). predict_frames on five frames in batches of four: 3DMM and
    vertices 1e-4, projected 1e-2 px, points within 1 px
    (``test_torch_frames.py``'s)."""
    path = str(tmp_path / "dad_3dnet.msgpack")
    jpred.save_predictor_checkpoint(_seeded_variables(2), path)
    config = {"img_size": IMG, "model": {"backbone": "mobilenet_w1"}}
    jp = jpred.FaceMeshPredictor(config=config, checkpoint_path=path, mesh=jax_make_mesh(jax.devices()[:2], data=2))
    tp = FaceMeshPredictor(config, checkpoint_path=path, mesh=make_mesh(["cpu", "cpu"]))
    images = np.random.default_rng(3).integers(0, 256, size=(5, IMG, IMG, 3), dtype=np.uint8)
    ref, out = jp.predict_batch(images), tp.predict_batch(images)
    assert set(out) == set(ref)
    for key, atol in (("3dmm_params", 1e-4), ("3d_vertices", 1e-4), ("points", 1e-2), ("projected_vertices", 1e-2)):
        assert out[key].shape == ref[key].shape and out[key].shape[0] == 5, key
        np.testing.assert_allclose(out[key], ref[key], atol=atol, err_msg=key)
    frames = frame_list(4)
    assert_predictions_close(tp.predict_frames(frames, batch_size=4), jp.predict_frames(frames, batch_size=4))
