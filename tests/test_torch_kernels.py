"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version, which is held against
the Pallas kernel in interpret mode (and the XLA path). The CUDA kernels
themselves are held against their plain versions in the ``cuda``-marked tests,
which skip without a card; JAX is imported inside the tests that need it, so
that on a machine with a card and no JAX these run with
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from dad3dheads_tpu_torch.ops.blendshapes import (
    blend_shapes_fused,
    blend_shapes_fused_backward,
    blend_shapes_fused_backward_reference,
    blend_shapes_fused_reference,
    split_k_chunk,
)
from dad3dheads_tpu_torch.ops.preprocess import normalize_images, normalize_images_reference


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tests run beside other test processes: two torch threads each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


MODES = ("imagenet", "mean", "none")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _flame_flat():
    from dad3dheads_tpu import assets

    arrays = assets.load_flame_model()
    V = arrays.v_template.shape[0]
    return arrays.shapedirs.reshape(V * 3, -1).T.copy(), arrays.v_template


def test_blendshapes_plain_matches_pallas_interpret():
    """Tolerance 1e-5: fp32 sums of 400 products in another order."""
    import jax.numpy as jnp

    from dad3dheads_tpu.ops.blendshapes import blend_shapes_fused_pallas

    rng = np.random.default_rng(11)
    B, L, V = 8, 400, 128
    betas = rng.normal(size=(B, L)).astype(np.float32)
    dirs = (rng.normal(size=(L, V * 3)) * 1e-3).astype(np.float32)
    template = rng.normal(size=(V, 3)).astype(np.float32)

    pad = (-(V * 3)) % 512  # the Pallas kernel takes 512-lane-aligned widths
    ref = blend_shapes_fused_pallas(
        jnp.asarray(betas),
        jnp.pad(jnp.asarray(dirs), ((0, 0), (0, pad))),
        jnp.pad(jnp.asarray(template).reshape(-1), (0, pad)),
        interpret=True,
    )
    ref = np.asarray(ref)[:, : V * 3].reshape(B, V, 3)
    out = blend_shapes_fused(torch.from_numpy(betas), torch.from_numpy(dirs), torch.from_numpy(template))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_blendshapes_plain_matches_xla_full_flame():
    """Full FLAME width (V = 5023, N = 15069); tolerance 1e-5 as above."""
    import jax.numpy as jnp

    from dad3dheads_tpu.ops.blendshapes import blend_shapes_fused as jax_blend

    dirs, template = _flame_flat()
    betas = np.random.default_rng(12).normal(size=(4, dirs.shape[0])).astype(np.float32)
    ref = jax_blend(jnp.asarray(betas), jnp.asarray(dirs), jnp.asarray(template), force_xla=True)
    out = blend_shapes_fused(torch.from_numpy(betas), torch.from_numpy(dirs), torch.from_numpy(template))
    assert out.shape == (4, 5023, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def _tf32x3_split(x):
    """The kernels' split of an fp32 array (csrc/tf32x3.cuh): hi rounds the
    bit pattern to nearest at 13 dropped bits (cvt.rna.tf32.f32, ties away
    from zero), lo = x - hi (exact) truncated to tf32 as the MMA reads it."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    hi = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    lo = ((x - hi).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
    return hi, lo


def _tf32x3_matmul(a, b):
    """a @ b as the kernels compute it: three tf32 products (each exact in
    fp32), small terms first, summed in fp32."""
    a_hi, a_lo = _tf32x3_split(a)
    b_hi, b_lo = _tf32x3_split(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def test_tf32x3_split_is_exact_and_tf32():
    """hi and lo carry no bits below tf32's; hi is x to nearest, and lo
    takes back all of the rest but what its truncation drops."""
    x = (np.random.default_rng(16).normal(size=4096) * 10.0 ** np.arange(-3, 5).repeat(512)).astype(np.float32)
    hi, lo = _tf32x3_split(x)
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    assert np.all(np.abs(x - hi) <= np.abs(x) * 2.0**-11)  # round to nearest: half a tf32 ulp
    assert np.all(np.abs(x - hi - lo) <= np.abs(x) * 2.0**-21)  # what truncating lo drops


@pytest.mark.parametrize("which", ["forward_B256", "backward_B64"])
def test_tf32x3_scheme_sits_far_inside_the_card_tolerances(flame_model_arrays, which):
    """The 3xTF32 arithmetic of the blendshape kernels, emulated in numpy at
    the full FLAME width on the real shapedirs, against an fp64 product.
    chip_smoke.py holds the forward to abs 1e-4 and 1e-5 of the largest
    output, the backward's d_betas to 1e-5 of its largest sum of absolute
    products; the scheme sits at a tenth of each or less (measured: forward
    6.2e-8 abs, 3.5e-7 relative, a plain fp32 product 5.6e-8; d_betas 1.8e-8
    of the scale, plain 2.1e-8). One tf32 product alone (hi * hi) misses the
    forward's relative bound (1.8e-4)."""
    V = flame_model_arrays.v_template.shape[0]
    dirs = flame_model_arrays.shapedirs.reshape(V * 3, -1).T.astype(np.float32)
    template = flame_model_arrays.v_template.reshape(-1).astype(np.float32)
    rng = np.random.default_rng(17)
    if which == "forward_B256":
        betas = rng.normal(size=(256, dirs.shape[0])).astype(np.float32)
        exact = betas.astype(np.float64) @ dirs.astype(np.float64) + template
        got = _tf32x3_matmul(betas, dirs) + template
        err = np.abs(got - exact).max()
        assert err <= 1e-5 and err / np.abs(exact).max() <= 1e-6, err
        one_tf32 = _tf32x3_split(betas)[0] @ _tf32x3_split(dirs)[0] + template
        assert np.abs(one_tf32 - exact).max() / np.abs(exact).max() > 1e-5
    else:
        g = rng.normal(size=(64, dirs.shape[1])).astype(np.float32)
        exact = g.astype(np.float64) @ dirs.T.astype(np.float64)
        scale = (np.abs(g).astype(np.float64) @ np.abs(dirs.T).astype(np.float64)).max()
        err = np.abs(_tf32x3_matmul(g, np.ascontiguousarray(dirs.T)) - exact).max()
        assert err <= 1e-6 * scale, err / scale


@pytest.mark.parametrize("B", [1, 7, 64, 128, 257])
@pytest.mark.parametrize("sms", [132, 114])
def test_backward_split_k_fills_one_wave(B, sms):
    """The split-K chunk of the d_betas kernel: a multiple of its 32-deep
    step, chunks that cover N, and a grid of at most two blocks per SM
    (one wave) that still fills most of them while there is N to split."""
    L, N = 400, 15069
    chunk = split_k_chunk(B, L, N, sms)
    chunks = -(-N // chunk)
    blocks = chunks * -(-L // 80) * -(-B // 64)
    assert chunk % 32 == 0 and (chunks - 1) * chunk < N <= chunks * chunk
    assert blocks <= 2 * sms or chunks == 1
    assert blocks >= 1.5 * sms or chunks == 1


@pytest.mark.parametrize("mode", MODES)
def test_normalize_plain_matches_pallas_interpret(mode):
    """Tolerance 1e-5: the same fp32 x*scale + bias on both sides."""
    import jax.numpy as jnp

    from dad3dheads_tpu.ops.preprocess_pallas import normalize_images_pallas

    imgs = np.random.default_rng(13).integers(0, 256, size=(2, 32, 128, 3), dtype=np.uint8)
    ref = np.asarray(normalize_images_pallas(jnp.asarray(imgs), mode, interpret=True))
    out = normalize_images(torch.from_numpy(imgs), mode)
    assert out.dtype == torch.float32 and out.shape == imgs.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_normalize_plain_bf16_equals_fp32_cast():
    """The plain bf16 output is the plain fp32 output rounded to nearest even
    by ``.to``, bit for bit, in every mode and through the wrapper."""
    imgs = torch.from_numpy(np.random.default_rng(19).integers(0, 256, (2, 9, 13, 3), dtype=np.uint8))
    for mode in MODES:
        out = normalize_images_reference(imgs, mode, torch.bfloat16)
        assert out.dtype == torch.bfloat16 and out.shape == imgs.shape
        assert torch.equal(out, normalize_images_reference(imgs, mode).to(torch.bfloat16))
        assert torch.equal(normalize_images(imgs, mode, out_dtype=torch.bfloat16), out)


@pytest.mark.parametrize("mode", MODES)
def test_normalize_plain_bf16_matches_pallas_interpret(mode):
    """Within one bf16 ulp of the Pallas kernel's fp32 output cast to bf16:
    the two fp32 values may part by an fp32 ulp (1e-5 above), which can move
    a value across a bf16 rounding boundary."""
    import jax.numpy as jnp

    from dad3dheads_tpu.ops.preprocess_pallas import normalize_images_pallas

    imgs = np.random.default_rng(20).integers(0, 256, size=(2, 32, 128, 3), dtype=np.uint8)
    ref = np.asarray(normalize_images_pallas(jnp.asarray(imgs), mode, interpret=True).astype(jnp.bfloat16))
    ref = torch.from_numpy(ref.astype(np.float32))
    out = normalize_images(torch.from_numpy(imgs), mode, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    ulp = torch.from_numpy(np.spacing(np.abs(ref.numpy()).astype(np.float32)) * 2.0**16)  # fp32 -> bf16 spacing
    assert torch.all((out.float() - ref).abs() <= ulp)


@pytest.mark.parametrize("out_dtype", [torch.float16, torch.float64, torch.uint8])
def test_normalize_refuses_other_out_dtypes(out_dtype):
    imgs = torch.zeros((1, 4, 4, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="out_dtype"):
        normalize_images(imgs, out_dtype=out_dtype)
    with pytest.raises(ValueError, match="out_dtype"):
        normalize_images_reference(imgs, out_dtype=out_dtype)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    dirs, template = _flame_flat()
    betas = torch.from_numpy(np.random.default_rng(14).normal(size=(3, 400)).astype(np.float32))
    imgs = torch.from_numpy(np.random.default_rng(15).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8))
    n_blend, n_norm = blend_shapes_fused.launches, normalize_images.launches
    dirs_t, tmpl_t = torch.from_numpy(dirs), torch.from_numpy(template)
    assert torch.equal(
        blend_shapes_fused(betas, dirs_t, tmpl_t), blend_shapes_fused_reference(betas, dirs_t, tmpl_t)
    )
    assert torch.equal(normalize_images(imgs), normalize_images_reference(imgs))
    assert (blend_shapes_fused.launches, normalize_images.launches) == (n_blend, n_norm)


def test_flame_shapedirs_rows_are_16_byte_aligned_views():
    """FlameModel keeps shapedirs as a (400, 15069) view of a buffer with rows
    of 15,072 floats, so that the kernels copy its rows 16 bytes at a time;
    the values are the asset's and the plain version reads the view as is."""
    from dad3dheads_tpu_torch.core.flame import FlameModel

    dirs, template = _flame_flat()
    flame = FlameModel.load()
    assert flame.shapedirs.shape == dirs.shape and flame.shapedirs.stride() == (15072, 1)
    assert flame.shapedirs.data_ptr() % 16 == 0
    np.testing.assert_array_equal(flame.shapedirs.numpy(), dirs)
    betas = torch.from_numpy(np.random.default_rng(18).normal(size=(2, 400)).astype(np.float32))
    np.testing.assert_allclose(
        blend_shapes_fused(betas, flame.shapedirs, flame.v_template).numpy(),
        blend_shapes_fused(betas, torch.from_numpy(dirs), torch.from_numpy(template)).numpy(),
        rtol=0, atol=1e-6,
    )


def test_kernel_argument_check_takes_padded_rows_only_where_allowed():
    """The wrappers' check before a launch: shapedirs and g may have rows
    further apart than their width (unit column stride); other layouts and
    other operands raise."""
    from dad3dheads_tpu_torch.ops.blendshapes import _check

    padded = torch.zeros((4, 8))[:, :6]
    _check((("shapedirs_flat", padded, (4, 6)),), padded.device, row_strided=("shapedirs_flat",))
    with pytest.raises(ValueError, match="contiguous"):
        _check((("betas", padded, (4, 6)),), padded.device, row_strided=("shapedirs_flat",))
    with pytest.raises(ValueError, match="unit column stride"):
        _check((("shapedirs_flat", torch.zeros((6, 4)).T, (4, 6)),), padded.device, row_strided=("shapedirs_flat",))
    with pytest.raises(ValueError, match="shape"):
        _check((("g", padded, (4, 8)),), padded.device, row_strided=("g",))


def test_wrappers_refuse_other_devices():
    with pytest.raises(ValueError, match="cpu or cuda"):
        blend_shapes_fused(
            torch.empty((2, 4), device="meta"), torch.empty((4, 6), device="meta"), torch.empty((2, 3), device="meta")
        )
    with pytest.raises(ValueError, match="cpu or cuda"):
        normalize_images(torch.empty((1, 4, 4, 3), dtype=torch.uint8, device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 256, 256, 3), (3, 250, 131, 3), (1, 37, 41, 3), (4, 250, 130, 3)])
def test_normalize_kernel_matches_plain(cuda, shape):
    """Bit for bit (torch.equal) against the plain version in every mode, fp32
    and bf16, and the bf16 output equal to the fp32 output cast: the kernel
    rounds the multiply and the add separately and the bf16 store to nearest
    even. Ragged tails (n % 16 = 14 and 7 for the middle shapes) and batch
    slices 10 (W = 131) and 12 (W = 130) bytes past 16-byte alignment, which
    take the scalar kernel."""
    x = torch.randint(0, 256, shape, generator=torch.Generator().manual_seed(0), dtype=torch.uint8).to(cuda)
    before, before_bf16 = normalize_images.launches, normalize_images.bf16_launches
    for mode in MODES:
        out32 = normalize_images(x, mode)
        out16 = normalize_images(x, mode, out_dtype=torch.bfloat16)
        assert out32.dtype == torch.float32 and out16.dtype == torch.bfloat16
        assert out32.shape == x.shape and out16.shape == x.shape
        assert torch.equal(out32, normalize_images_reference(x, mode))
        assert torch.equal(out16, normalize_images_reference(x, mode, torch.bfloat16))
        assert torch.equal(out16, out32.to(torch.bfloat16))
    assert normalize_images.launches == before + 2 * len(MODES)
    assert normalize_images.bf16_launches == before_bf16 + len(MODES)
    if shape[0] > 1:
        sliced = x[1:]  # a batch slice
        for dtype in (torch.float32, torch.bfloat16):
            assert torch.equal(normalize_images(sliced, out_dtype=dtype), normalize_images_reference(sliced, "imagenet",
                                                                                                      dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7, 64, 256, 257])
def test_blendshapes_kernel_matches_plain(cuda, B):
    """Full FLAME width, every row-tile configuration of the kernel and a
    ragged last tile (257), with shapedirs contiguous (rows copied 4 bytes at
    a time) and as FlameModel keeps it (rows padded to 16-byte alignment);
    3xTF32 against fp32 sums in another order: abs 1e-4, rel 1e-5; the same
    bits on a second launch."""
    from dad3dheads_tpu_torch.core.flame import FlameModel

    dirs, template = _flame_flat()
    dirs_t, tmpl_t = torch.from_numpy(dirs).to(cuda), torch.from_numpy(template).to(cuda)
    padded = FlameModel.load(device=cuda).shapedirs
    assert padded.stride(0) % 4 == 0 and torch.equal(padded, dirs_t)
    betas = torch.randn((B, 400), generator=torch.Generator().manual_seed(B)).to(cuda)
    for layout in (dirs_t, padded):
        before = blend_shapes_fused.launches
        out = blend_shapes_fused(betas, layout, tmpl_t)
        ref = blend_shapes_fused_reference(betas, layout, tmpl_t)
        assert blend_shapes_fused.launches == before + 1
        assert out.shape == (B, 5023, 3)
        err = (out - ref).abs().max().item()
        assert err <= 1e-4 and err / ref.abs().max().item() <= 1e-5
        assert torch.equal(blend_shapes_fused(betas, layout, tmpl_t), out)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [5, 33, 130])
def test_blendshapes_kernels_take_aligned_and_unaligned_rows(cuda, B):
    """Rows that are 16-byte aligned (N = 384) are copied 16 bytes at a time,
    betas that start 4 bytes past an aligned address one element at a time
    (FLAME's N = 15,069 takes that path for shapedirs and g): both kernels
    against their plain versions, with the tolerances of the FLAME tests."""
    gen = torch.Generator().manual_seed(B)
    L, V = 400, 128
    dirs = (torch.randn((L, V * 3), generator=gen) * 1e-2).to(cuda)
    template = torch.randn((V, 3), generator=gen).to(cuda)
    betas = torch.randn((B * L + 1,), generator=gen).to(cuda)[1:].view(B, L)
    assert betas.data_ptr() % 16 == 4 and betas.is_contiguous()
    out = blend_shapes_fused(betas, dirs, template)
    ref = blend_shapes_fused_reference(betas, dirs, template)
    err = (out - ref).abs().max().item()
    assert err <= 1e-4 and err / ref.abs().max().item() <= 1e-5
    g = torch.randn((B, V * 3), generator=gen).to(cuda)
    got = blend_shapes_fused_backward(g, betas, dirs, (True, False, True))
    want = blend_shapes_fused_backward_reference(g, betas, dirs, (True, False, True))
    assert (got[0] - want[0]).abs().max().item() <= 1e-5 * (g.abs() @ dirs.abs().T).max().item()
    assert (got[2] - want[2]).abs().max().item() <= 1e-5 * g.abs().sum(0).max().item()


@pytest.mark.cuda
def test_blendshapes_kernel_gradients_match_plain(cuda):
    """The kernel's gradients (autograd through the forward kernel into the
    backward kernel) equal the plain version's: d_betas within 1e-5 of the
    largest |g| . |dirs| sum (fp32 sums of 15,069 products in another
    order), d_template and d_shapedirs within 1e-5 of theirs."""
    dirs, template = _flame_flat()
    dirs_t, tmpl_t = torch.from_numpy(dirs).to(cuda), torch.from_numpy(template).to(cuda)
    gen = torch.Generator().manual_seed(3)
    betas = torch.randn((5, 400), generator=gen).to(cuda).requires_grad_(True)
    g = torch.randn((5, 5023, 3), generator=gen).to(cuda)
    leaves = (betas, dirs_t.clone().requires_grad_(True), tmpl_t.clone().requires_grad_(True))
    before = (blend_shapes_fused.launches, blend_shapes_fused_backward.launches)
    blend_shapes_fused(*leaves).backward(g)
    assert (blend_shapes_fused.launches, blend_shapes_fused_backward.launches) == (before[0] + 1, before[1] + 1)
    ref = blend_shapes_fused_backward_reference(g.reshape(5, -1), betas.detach(), dirs_t)
    gf = g.reshape(5, -1).abs()
    scales = ((gf @ dirs_t.abs().T).max(), (betas.detach().abs().T @ gf).max(), gf.sum(0).max())
    for leaf, r, scale in zip(leaves, ref, scales):
        assert (leaf.grad.reshape(r.shape) - r).abs().max().item() <= 1e-5 * scale.item()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7, 64, 128, 256, 257])
def test_blendshapes_backward_kernel_matches_plain(cuda, B):
    """d_betas, d_shapedirs, d_template against the plain version, each
    within 1e-5 of its sum of absolute products; the same bits on a second
    launch (no atomics); d_shapedirs only when asked for."""
    from dad3dheads_tpu_torch.core.flame import FlameModel

    dirs_t = FlameModel.load(device=cuda).shapedirs  # rows padded to 16-byte alignment, as the train step has it
    gen = torch.Generator().manual_seed(B)
    g = torch.randn((B, dirs_t.shape[1]), generator=gen).to(cuda)
    betas = torch.randn((B, 400), generator=gen).to(cuda)
    out = blend_shapes_fused_backward(g, betas, dirs_t)
    again = blend_shapes_fused_backward(g, betas, dirs_t)
    ref = blend_shapes_fused_backward_reference(g, betas, dirs_t)
    scales = ((g.abs() @ dirs_t.abs().T).max(), (betas.abs().T @ g.abs()).max(), g.abs().sum(0).max())
    for o, a, r, scale in zip(out, again, ref, scales):
        assert o.shape == r.shape and torch.equal(o, a)
        assert (o - r).abs().max().item() <= 1e-5 * scale.item()
    partial = blend_shapes_fused_backward(g, betas, dirs_t, (True, False, True))
    assert partial[1] is None and torch.equal(partial[0], out[0]) and torch.equal(partial[2], out[2])
