"""The port's layer zoo (``dad3dheads_tpu_torch/models/layers.py``) against
the flax modules of ``dad3dheads_tpu/models/layers.py`` on the CPU.

Each module's flax variables come from ``init`` on a small NHWC input, with
BN statistics and affine terms randomized (fresh BN is the identity, which
would hide a mean/var swap), and cross through
``weights.layer_state_dict_from_flax``; the same numpy input goes through
both forwards (the port's as the NCHW view of the NHWC array, channels_last).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dad3dheads_tpu.models import layers as jl
from dad3dheads_tpu_torch import weights
from dad3dheads_tpu_torch.models import layers as tl


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tests run beside other test processes: two torch threads each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


B, H, W = 2, 12, 10


def _randomized(variables, seed):
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith(("['mean']", "['bias']")):
            return (rng.normal(size=leaf.shape) * 0.1).astype(np.float32)
        if name.endswith(("['var']", "['scale']")):
            return rng.uniform(0.75, 1.25, size=leaf.shape).astype(np.float32)
        return np.asarray(leaf)

    return jax.tree_util.tree_map_with_path(draw, variables)


def _pair(jmodule, tmodule, in_c, seed=0):
    """(flax variables, the input as numpy NHWC) with ``tmodule`` loaded."""
    x = np.random.default_rng(seed).normal(size=(B, H, W, in_c)).astype(np.float32)
    v = jax.jit(lambda r: jmodule.init(r, jnp.asarray(x), train=False))(jax.random.PRNGKey(seed))
    v = _randomized(v, seed + 1)
    tmodule.load_state_dict(weights.layer_state_dict_from_flax(tmodule, v), strict=True)
    return v, x


def _torch(tmodule, x):
    with torch.no_grad():
        return tmodule(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()


MODULES = {
    "conv": (lambda: jl.ConvBlock(16), lambda: tl.ConvBlock(6, 16), 6),
    "conv 5x5 stride 2": (lambda: jl.ConvBlock(8, kernel=5, stride=2), lambda: tl.ConvBlock(6, 8, 5, 2), 6),
    "sep_conv": (lambda: jl.SepConv(24), lambda: tl.SepConv(12, 24), 12),
    "sep_conv stride 2": (lambda: jl.SepConv(24, stride=2), lambda: tl.SepConv(12, 24, stride=2), 12),
    "sep_conv 5x5": (lambda: jl.SepConv(8, kernel=5), lambda: tl.SepConv(12, 8, 5), 12),
    # 14 channels over 3 kernels: 4, 4 and the remainder 6
    "mix_sep_conv": (lambda: jl.MixSepConv(16), lambda: tl.MixSepConv(14, 16), 14),
    "mix_sep_conv (3, 5)": (lambda: jl.MixSepConv(8, kernels=(3, 5)), lambda: tl.MixSepConv(9, 8, (3, 5)), 9),
    "pixel_shuffle_upsample": (lambda: jl.PixelShuffleUpsample(3), lambda: tl.PixelShuffleUpsample(8, 3), 8),
    "pixel_shuffle_upsample x3": (lambda: jl.PixelShuffleUpsample(2, upscale=3),
                                  lambda: tl.PixelShuffleUpsample(8, 2, 3), 8),
    "mask head, sep_conv": (lambda: jl.MaskPredictionHead(num_classes=5, num_filters=16),
                            lambda: tl.MaskPredictionHead(8, 5, 16), 8),
    "mask head, conv x3": (lambda: jl.MaskPredictionHead(num_classes=5, num_filters=16, num_blocks=3, block="conv"),
                           lambda: tl.MaskPredictionHead(8, 5, 16, 3, "conv"), 8),
    "mask head, mix_sep_conv": (
        lambda: jl.MaskPredictionHead(num_classes=5, num_filters=15, block="mix_sep_conv"),
        lambda: tl.MaskPredictionHead(8, 5, 15, block="mix_sep_conv"), 8),
}


@pytest.mark.parametrize("name", MODULES)
def test_module_matches_flax(name):
    """Eval mode, fp32: rtol/atol 1e-5 (sums in another order)."""
    make_j, make_t, in_c = MODULES[name]
    jmodule, tmodule = make_j(), make_t().eval()
    v, x = _pair(jmodule, tmodule, in_c)
    ref = np.asarray(jax.jit(lambda v, x: jmodule.apply(v, x, train=False))(v, jnp.asarray(x)))
    out = _torch(tmodule, x)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["conv", "sep_conv stride 2", "mix_sep_conv", "mask head, sep_conv"])
def test_train_mode_matches_flax(name):
    """Train mode: the output (batch statistics) at 1e-5 and each updated
    running statistic (flax momentum 0.9, biased variance) at 1e-5."""
    make_j, make_t, in_c = MODULES[name]
    jmodule, tmodule = make_j(), make_t().train()
    v, x = _pair(jmodule, tmodule, in_c, seed=3)
    ref, updated = jax.jit(lambda v, x: jmodule.apply(v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
    out = _torch(tmodule, x)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5, atol=1e-5)
    back = weights._flatten(updated)
    sd = tmodule.state_dict()
    stats = {p: k for p, (k, _) in weights.layer_name_map(tmodule).items() if p.startswith("batch_stats/")}
    assert stats and set(stats) == set(back)
    for path, key in stats.items():
        np.testing.assert_allclose(sd[key].numpy(), np.asarray(back[path]), rtol=1e-5, atol=1e-6, err_msg=path)


@pytest.mark.parametrize("channels,r", [(12, 2), (18, 3), (4, 2), (8, 2)])
def test_pixel_shuffle_is_exact(channels, r):
    """Bit for bit the JAX function, in its channel order; with C' > 1 it
    is not ``F.pixel_shuffle``'s."""
    x = np.random.default_rng(channels).normal(size=(2, 5, 4, channels)).astype(np.float32)
    ref = np.asarray(jl.pixel_shuffle(jnp.asarray(x), r))
    t = tl.pixel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), r)
    assert t.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(t.permute(0, 2, 3, 1).numpy(), ref)
    torch_order = F.pixel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), r).permute(0, 2, 3, 1).numpy()
    assert np.array_equal(torch_order, ref) == (channels == r * r)


def test_pixel_shuffle_refuses_a_ragged_depth():
    with pytest.raises(ValueError):
        tl.pixel_shuffle(torch.zeros(1, 6, 2, 2), 2)


def test_registries_and_identity():
    assert tl.get_conv_block("conv") is tl.ConvBlock
    assert tl.get_conv_block("sep_conv") is tl.SepConv
    assert tl.get_conv_block("mix_sep_conv") is tl.MixSepConv
    assert set(tl.CONV_BLOCKS) == set(jl.CONV_BLOCKS)
    assert set(tl.PREDICTION_HEADS) == set(jl.PREDICTION_HEADS)
    assert tl.get_mask_prediction_layer() is tl.MaskPredictionHead
    with pytest.raises(KeyError):
        tl.get_conv_block("nope")
    x = torch.randn(2, 3, 4, 4)
    assert tl.IdentityLayer()(x) is x
    assert tl.mix_split(14, 3) == [4, 4, 6] and tl.mix_split(9, 2) == [4, 5]


def test_layer_bridge_is_total():
    """A flax leaf the map misses, or a map entry with no leaf, raises."""
    jmodule, tmodule = jl.SepConv(8), tl.SepConv(6, 8)
    v, _ = _pair(jmodule, tmodule, 6)
    flat = weights._flatten(v)
    assert set(flat) == set(weights.layer_name_map(tmodule))
    del v["params"]["Conv_1"]
    with pytest.raises(KeyError):
        weights.layer_state_dict_from_flax(tmodule, v)
