"""The port's int8 primitives (``dad3dheads_tpu_torch/models/quant.py``)
against the JAX package's (``dad3dheads_tpu/models/quant.py``) on seeded
numpy inputs: quantization and BN folding bit for bit, the int32 accumulator
of the im2col + ``torch._int_mm`` route bit for bit against JAX's int32
convolution and against a float64 convolution, the epilogue's int8 outputs
equal but for ties, and the mirror's int8 max pool and resize."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dad3dheads_tpu.models import quant as jq
from dad3dheads_tpu.models import quantized as jqd
from dad3dheads_tpu_torch.models import quant as tq
from dad3dheads_tpu_torch.models import quantized as tqd


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tests run beside other test processes: two torch threads each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def hwio(oihw: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(oihw, (2, 3, 1, 0)))


def int8_values(rng, shape) -> np.ndarray:
    return rng.integers(-127, 128, size=shape, dtype=np.int8)


def test_quantize_matches_jax_ties_included():
    """Half-to-even at exact ties (x / scale = k + 0.5), clipping at 127."""
    rng = np.random.default_rng(0)
    scale = np.float32(0.25)
    ties = (np.arange(-140, 140, dtype=np.float32) + np.float32(0.5)) * scale
    x = np.concatenate([ties, rng.normal(size=2000).astype(np.float32) * 20]).astype(np.float32)
    assert np.all(ties / scale % 1 == 0.5)
    got = tq.quantize(torch.from_numpy(x), torch.tensor(scale))
    ref = jq.quantize(jnp.asarray(x), jnp.asarray(scale))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(ref.values))
    assert got.values.dtype == torch.int8
    np.testing.assert_array_equal(tq.dequantize(got, torch.float32).numpy(),
                                  np.asarray(jq.dequantize(ref, jnp.float32)))
    for amax in (np.float32(0.0), np.float32(3.7), np.float32(1e-9)):
        assert tq._amax_scale(torch.tensor(amax)).item() == float(jq._amax_scale(jnp.asarray(amax)))


def test_fold_bn_and_weights_match_jax_bitwise():
    """BN folding and per-output-channel int8 weights, OIHW against HWIO."""
    rng = np.random.default_rng(1)
    kernel = rng.normal(size=(24, 16, 3, 3)).astype(np.float32)
    kernel[3] = 0.0  # an all-zero channel: the 1e-8 floor of its scale
    scale, bias = rng.uniform(0.5, 1.5, 24).astype(np.float32), rng.normal(size=24).astype(np.float32)
    mean, var = rng.normal(size=24).astype(np.float32), rng.uniform(0.5, 2, 24).astype(np.float32)
    t = [torch.from_numpy(a) for a in (kernel, scale, bias, mean, var)]
    k_t, b_t = tq.fold_bn(*t, 1e-5)
    k_j, b_j = jq.fold_bn(jnp.asarray(hwio(kernel)), *(jnp.asarray(a) for a in (scale, bias, mean, var)), 1e-5)
    np.testing.assert_array_equal(hwio(k_t.numpy()), np.asarray(k_j))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))
    q_t, s_t = tq.quantize_weights_per_channel(k_t)
    q_j, s_j = jq.quantize_weights_per_channel(k_j)
    np.testing.assert_array_equal(hwio(q_t.numpy()), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


# (batch, size, cin, cout, kernel, stride): the stem (K 147 -> 152), a 3x3
# stride-2 site, a 1x1 stride-2 projection, the fusion conv (K 1,348 -> 1,352),
# the heatmap head (N 68 -> 72), and maps of 1 and 4 pixels (rows padded)
CONV_CASES = [
    (2, 20, 3, 64, 7, 2),
    (2, 9, 32, 24, 3, 2),
    (3, 8, 16, 40, 1, 2),
    (1, 4, 1348, 32, 1, 1),
    (2, 8, 32, 68, 3, 1),
    (1, 2, 64, 16, 3, 2),
    (2, 2, 16, 8, 1, 1),
]


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "b{}_s{}_c{}_n{}_k{}_st{}".format(*c))
def test_int8_accumulator_matches_jax_and_float64(case):
    B, S, C, N, k, stride = case
    rng = np.random.default_rng(sum(case))
    x, kq = int8_values(rng, (B, S, S, C)), int8_values(rng, (N, C, k, k))
    pad = k // 2
    got = tq.conv_int8_accumulator(torch.from_numpy(x), tq.gemm_weight(torch.from_numpy(kq)), k, stride, pad)
    assert got.dtype == torch.int32 and got.shape[-1] % 8 == 0
    got = got[..., :N].numpy()
    dn = jax.lax.conv_dimension_numbers(x.shape, (k, k, C, N), ("NHWC", "HWIO", "NHWC"))
    ref = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(hwio(kq)), (stride, stride), [(pad, pad)] * 2,
                                       dimension_numbers=dn, preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got, np.asarray(ref))
    plain = tq.conv_int8_accumulator_reference(torch.from_numpy(x), torch.from_numpy(kq), stride, pad)
    np.testing.assert_array_equal(got, plain.numpy())


def test_int8_accumulator_exact_past_fp32():
    """Stage 4's 3x3 depth (4,608 products of 127 * 127): sums past 2**24,
    where an fp32 product would round, are exact."""
    x = np.full((1, 8, 8, 512), 127, np.int8)
    kq = np.full((8, 512, 3, 3), 127, np.int8)
    kq[1] = -127
    got = tq.conv_int8_accumulator(torch.from_numpy(x), tq.gemm_weight(torch.from_numpy(kq)), 3, 1, 1)
    assert got[0, 4, 4, 0].item() == 4608 * 127 * 127 > 2**24
    np.testing.assert_array_equal(got.numpy(), tq.conv_int8_accumulator_reference(
        torch.from_numpy(x), torch.from_numpy(kq), 1, 1).numpy())


def assert_int8_equal_but_ties(got, ref, y_pre: np.ndarray, scale: float):
    """Where the int8 outputs differ, by one at most, the value before
    rounding lies within a few ulps of a rounding tie."""
    got, ref = np.asarray(got, np.int32), np.asarray(ref, np.int32)
    diff = got != ref
    assert np.all(np.abs(got - ref) <= 1)
    r = y_pre[diff] / scale
    assert np.all(np.abs(np.abs(r - np.floor(r)) - 0.5) <= 8 * np.spacing(np.abs(r) + 1)), r


@pytest.mark.parametrize("relu", [True, False])
def test_conv_int8_epilogue_matches_jax(relu):
    """The jitted JAX epilogue against the port's separate fp32 operations:
    int8 outputs equal but for ties, dense outputs within an ulp or two."""
    rng = np.random.default_rng(7 + relu)
    B, S, C, N, k, stride = 2, 12, 24, 40, 3, 2
    x, kq = int8_values(rng, (B, S, S, C)), int8_values(rng, (N, C, k, k))
    x_scale, out_scale = np.float32(0.031), np.float32(0.7)
    w_scale = rng.uniform(1e-3, 2e-3, N).astype(np.float32)
    bias = rng.normal(size=N).astype(np.float32)
    args_t = (tq.QTensor(torch.from_numpy(x), torch.tensor(x_scale)), tq.gemm_weight(torch.from_numpy(kq)), k,
              torch.from_numpy(w_scale), torch.from_numpy(bias), stride, 1)
    args_j = (jq.QTensor(jnp.asarray(x), jnp.asarray(x_scale)), jnp.asarray(hwio(kq)), jnp.asarray(w_scale),
              jnp.asarray(bias), stride, [(1, 1), (1, 1)])
    q_t = tq.conv_int8(*args_t, out_scale=torch.tensor(out_scale), relu=relu)
    q_j = jax.jit(lambda *a: jq.conv_int8(*a[:4], stride, [(1, 1), (1, 1)], out_scale=a[4], relu=relu))(
        *args_j[:4], jnp.asarray(out_scale))
    dense = tq.conv_int8(*args_t, relu=relu, out_dtype=torch.float32).numpy()
    assert_int8_equal_but_ties(q_t.values.numpy(), q_j.values, dense, out_scale)
    d_j = np.asarray(jq.conv_int8(*args_j, relu=relu, out_dtype=jnp.float32))
    np.testing.assert_allclose(dense, d_j, rtol=2e-7, atol=1e-6)


def test_add_relu_requant_matches_jax():
    rng = np.random.default_rng(11)
    a, b = int8_values(rng, (4, 6, 6, 32)), int8_values(rng, (4, 6, 6, 32))
    sa, sb, so = np.float32(0.02), np.float32(0.013), np.float32(0.05)
    got = tq.add_relu_requant(tq.QTensor(torch.from_numpy(a), torch.tensor(sa)),
                              tq.QTensor(torch.from_numpy(b), torch.tensor(sb)), torch.tensor(so))
    ref = jax.jit(jq.add_relu_requant)(jq.QTensor(jnp.asarray(a), jnp.asarray(sa)),
                                       jq.QTensor(jnp.asarray(b), jnp.asarray(sb)), jnp.asarray(so))
    y = np.maximum(a.astype(np.float32) * sa + b.astype(np.float32) * sb, 0)
    assert_int8_equal_but_ties(got.values.numpy(), ref.values, y, so)


@pytest.mark.parametrize("relu", [True, False])
def test_conv_fp_bf16_adds_the_bias_before_rounding(relu):
    """The calib/fp mode's float conv in bf16: bf16 operands summed in fp32,
    the fp32 bias added, then one rounding to bf16, as the JAX mirror's
    ``preferred_element_type=float32`` conv does. The two sums run in other
    orders, so a value may land one bf16 step apart (no value did on these
    inputs); rounding before the bias parts on about a third of them."""
    rng = np.random.default_rng(13 + relu)
    x = rng.normal(size=(2, 10, 10, 48)).astype(np.float32)
    kernel = (rng.normal(size=(40, 48, 3, 3)) * 0.05).astype(np.float32)
    bias = rng.normal(size=40).astype(np.float32)
    got = tqd._conv_fp(torch.from_numpy(x), torch.from_numpy(kernel), torch.from_numpy(bias), 2, 1, relu,
                       torch.bfloat16)
    ref = jqd._conv_fp(jnp.asarray(x), jnp.asarray(hwio(kernel)), jnp.asarray(bias), 2, [(1, 1), (1, 1)], relu,
                       jnp.bfloat16)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    g, r = got.float().numpy(), np.asarray(ref, np.float32)
    steps = np.abs(g - r) / np.maximum(np.abs(r) * 2.0**-8, 2.0**-133)
    assert steps.max() <= 1 and (g != r).mean() <= 1e-3


def test_int8_maxpool_and_resize_match_jax():
    """The init block's int8 max pool (padding -128 never wins) and dense
    pool, and the BiFPN's int8 resizes: down by a strided slice, up through
    bf16 (in every dtype) as the JAX mirror does."""
    rng = np.random.default_rng(5)
    v = int8_values(rng, (2, 9, 10, 8))
    scale = np.float32(0.1)
    got = tqd._maxpool_3x3s2(tq.QTensor(torch.from_numpy(v), torch.tensor(scale)))
    ref = jqd._maxpool_3x3s2(jq.QTensor(jnp.asarray(v), jnp.asarray(scale)))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(ref.values))
    assert got.values.dtype == torch.int8
    dense = rng.normal(size=(2, 9, 10, 8)).astype(np.float32)
    np.testing.assert_array_equal(tqd._maxpool_3x3s2(torch.from_numpy(dense)).numpy(),
                                  np.asarray(jqd._maxpool_3x3s2(jnp.asarray(dense))))

    v = int8_values(rng, (2, 4, 4, 8))
    q_t, q_j = tq.QTensor(torch.from_numpy(v), torch.tensor(scale)), jq.QTensor(jnp.asarray(v), jnp.asarray(scale))
    down = tqd._resize_q(q_t, (2, 2))
    assert isinstance(down, tq.QTensor)
    np.testing.assert_array_equal(down.values.numpy(), np.asarray(jqd._resize_q(q_j, (2, 2)).values))
    assert tqd._resize_q(q_t, (4, 4)) is q_t
    up_t, up_j = tqd._resize_q(q_t, (8, 8)), jqd._resize_q(q_j, (8, 8))
    assert up_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(up_t.float().numpy(), np.asarray(up_j, np.float32))
