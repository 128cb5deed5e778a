"""The port's DAD-3DNet and weight bridge against the flax model.

Weights come from ``model.init`` at 64x64 (with randomized BN statistics, so
that a mean/var mix-up would show) and cross through
``dad3dheads_tpu_torch.weights``; the same numpy inputs go through both
forwards.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from dad3dheads_tpu.constants import OUTPUT_2D_LANDMARKS, OUTPUT_3DMM_PARAMS, OUTPUT_LANDMARKS_HEATMAP
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


TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
IMG = 64
KEYS = (OUTPUT_LANDMARKS_HEATMAP, OUTPUT_3DMM_PARAMS, OUTPUT_2D_LANDMARKS)


def flax_variables(seed: int, img: int = IMG):
    """Seeded ``model.init`` variables as numpy, BN statistics randomized."""
    model = jax_create_model({})
    v = jax.jit(lambda r: model.init(r, jnp.zeros((1, img, img, 3)), train=False))(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def randomize(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['mean']"):
            return (rng.normal(size=leaf.shape) * 0.1).astype(np.float32)
        if name.endswith("['var']"):
            return (rng.uniform(size=leaf.shape) * 0.5 + 0.75).astype(np.float32)
        return np.asarray(leaf)

    return jax.tree_util.tree_map_with_path(randomize, v)


@pytest.fixture(scope="module")
def variables():
    return flax_variables(0)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(1).normal(size=(2, IMG, IMG, 3)).astype(np.float32)


def _outputs(variables, images, dtype):
    jmodel = jax_create_model({"dtype": dtype})
    jout = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, jnp.asarray(images))
    tmodel = create_model({"dtype": dtype})
    tmodel.load_state_dict(weights.state_dict_from_flax(variables))
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(images))
    return {k: np.asarray(jout[k], np.float32) for k in KEYS}, {k: tout[k].numpy() for k in KEYS}


@pytest.fixture(scope="module")
def fp32_outputs(variables, images):
    return _outputs(variables, images, "float32")


def test_name_map_equals_the_tools_map():
    sys.path.insert(0, TOOLS)
    try:
        from port_torch_weights import dad3dnet_resnet50_name_map
    finally:
        sys.path.remove(TOOLS)
    assert weights.name_map() == dad3dnet_resnet50_name_map()


def test_bridge_covers_every_leaf(variables):
    flat = weights._flatten(variables)
    assert set(flat) == set(weights.name_map())
    sd = weights.state_dict_from_flax(variables)
    assert set(sd) == set(create_model({}).state_dict())


def test_flax_torch_flax_is_identity(variables):
    back = weights._flatten(weights.flax_from_state_dict(weights.state_dict_from_flax(variables)))
    flat = weights._flatten(variables)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


def test_torch_flax_torch_is_identity():
    sd = create_model({}, torch.Generator().manual_seed(3)).state_dict()
    back = weights.state_dict_from_flax(weights.flax_from_state_dict(sd))
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


@pytest.mark.parametrize("key", KEYS)
def test_fp32_forward_matches_flax(fp32_outputs, key):
    """rtol 1e-4 / atol 1e-4: fp32 convolutions summed in another order
    (measured gap below 1e-5)."""
    jout, tout = fp32_outputs
    assert tout[key].shape == jout[key].shape
    np.testing.assert_allclose(tout[key], jout[key], rtol=1e-4, atol=1e-4)


def test_bf16_forward_matches_flax(variables, images, fp32_outputs):
    """bf16 trunk against flax's bf16 trunk.

    Heatmap and 2D landmarks: atol 3e-2. The 3DMM's tanh(x)*3 head amplifies
    one-ulp bf16 rounding differences of the trunk, and there even flax's own
    bf16 output lies ~4e-2 from its fp32 output at these weights; so the 3DMM
    is held to 1.5x that measured band, and the port's bf16 must really be
    bf16 (off its own fp32 output)."""
    jb, tb = _outputs(variables, images, "bfloat16")
    jf, tf = fp32_outputs
    for key in (OUTPUT_LANDMARKS_HEATMAP, OUTPUT_2D_LANDMARKS):
        np.testing.assert_allclose(tb[key], jb[key], atol=3e-2)
    band = np.abs(jb[OUTPUT_3DMM_PARAMS] - jf[OUTPUT_3DMM_PARAMS]).max()
    gap = np.abs(tb[OUTPUT_3DMM_PARAMS] - jb[OUTPUT_3DMM_PARAMS]).max()
    assert gap <= 1.5 * band, (gap, band)
    assert np.abs(tb[OUTPUT_LANDMARKS_HEATMAP] - tf[OUTPUT_LANDMARKS_HEATMAP]).max() > 1e-3


def test_reference_state_dict_loads_as_is():
    """A state dict with the reference's torch keys (the mirror in tools/)
    loads strictly, and both torch modules compute the same function."""
    sys.path.insert(0, TOOLS)
    try:
        from torch_dad3dnet import TorchDAD3DNet, randomize_bn_stats
    finally:
        sys.path.remove(TOOLS)
    torch.manual_seed(5)
    mirror = TorchDAD3DNet().eval()
    randomize_bn_stats(mirror, seed=6)
    port = create_model({})
    port.load_state_dict(mirror.state_dict(), strict=True)
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(2, IMG, IMG, 3)).astype(np.float32))
    with torch.no_grad():
        ref = mirror(x.permute(0, 3, 1, 2).contiguous())
        out = port(x)
    torch.testing.assert_close(out[OUTPUT_LANDMARKS_HEATMAP], ref["heatmap"].permute(0, 2, 3, 1), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out[OUTPUT_3DMM_PARAMS], ref["params_3dmm"], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out[OUTPUT_2D_LANDMARKS], ref["landmarks"], rtol=1e-4, atol=1e-4)


def test_msgpack_reader_matches_flax(tmp_path, variables):
    path = tmp_path / "ck.msgpack"
    path.write_bytes(serialization.to_bytes(variables))
    got = weights._flatten(weights.load_flax_msgpack(str(path)))
    want = weights._flatten(variables)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_msgpack_reader_decodes_bf16_and_scalars(tmp_path):
    tree = {"a": jnp.asarray([1.5, -2.25, 3.0], jnp.bfloat16), "s": np.float32(0.5), "i": np.arange(4, dtype=np.int32)}
    path = tmp_path / "small.msgpack"
    path.write_bytes(serialization.to_bytes(tree))
    got = weights.load_flax_msgpack(str(path))
    np.testing.assert_array_equal(got["a"], np.asarray([1.5, -2.25, 3.0], np.float32))
    assert got["s"] == np.float32(0.5)
    np.testing.assert_array_equal(got["i"], np.arange(4, dtype=np.int32))
