"""BatchNorm running statistics of the port's DAD-3DNet after one
train-mode forward, against flax's ``apply(..., train=True,
mutable=["batch_stats"])`` from the same ``model.init`` weights and images
(64x64, B = 8). Two faults of the inference port show here: the BiFPN's
momentum (flax 0.0003 is torch 0.9997, not torch's default 0.1) and the
running variance (flax folds in the biased batch variance, torch's
BatchNorm2d the unbiased one). Eval-mode outputs stay as they were
(``tests/test_torch_model.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dad3dheads_tpu.models import create_model as jax_create_model
from dad3dheads_tpu_torch import weights
from dad3dheads_tpu_torch.models import create_model


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tests run beside other test processes: two torch threads each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


IMG, B = 64, 8


@pytest.fixture(scope="module")
def stats():
    """(initial, flax's, port's) batch_stats, flattened."""
    jmodel = jax_create_model({"dropout": 0.0})
    variables = jax.jit(lambda r: jmodel.init(r, jnp.zeros((1, IMG, IMG, 3)), train=False))(jax.random.PRNGKey(4))
    variables = jax.tree_util.tree_map(np.array, variables)
    rng = np.random.default_rng(5)
    # per-sample contrast and colour: batch statistics away from degenerate
    x = rng.normal(size=(B, IMG, IMG, 3)) * rng.uniform(0.5, 2.0, size=(B, 1, 1, 1)) + rng.normal(size=(B, 1, 1, 3))
    x = x.astype(np.float32)
    _, mutated = jax.jit(lambda v, x: jmodel.apply(v, x, train=True, mutable=["batch_stats"]))(variables, x)
    model = create_model({"dropout": 0.0})
    model.load_state_dict(weights.state_dict_from_flax(variables))
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(x))
    port = weights.flax_from_state_dict(model.state_dict())["batch_stats"]
    flat = lambda t: weights._flatten({"batch_stats": t})  # noqa: E731
    return flat(variables["batch_stats"]), flat(jax.tree_util.tree_map(np.array, mutated["batch_stats"])), flat(port)


def _check(stats, select, tol):
    initial, ref, got = stats
    keys = [k for k in ref if select(k)]
    assert keys
    for k in keys:
        assert not np.allclose(ref[k], initial[k]), k  # the forward moved it
        np.testing.assert_allclose(got[k], ref[k], rtol=tol, atol=tol * np.abs(ref[k]).max(), err_msg=k)


def test_bifpn_bn_momentum_matches_flax(stats):
    """Every BiFPN BN running mean and variance at 1e-3 relative: with
    torch's default momentum they keep 90% of their initial values, with
    flax's 0.0003 (torch 0.9997) almost none."""
    _check(stats, lambda k: k.startswith("batch_stats/bifpn/"), 1e-3)


def test_resnet_running_var_is_biased_as_in_flax(stats):
    """Every ResNet BN running variance at 1e-4 relative. Its momentum was
    right before; the unbiased variance put the 2x2 stage-4 units
    (n = 32 values per channel) 0.3% too high."""
    _check(stats, lambda k: k.startswith("batch_stats/encoder/") and k.endswith("/var"), 1e-4)


def test_resnet_running_mean_matches_flax(stats):
    """Every ResNet BN running mean at 1e-3 relative."""
    _check(stats, lambda k: k.startswith("batch_stats/encoder/") and k.endswith("/mean"), 1e-3)
