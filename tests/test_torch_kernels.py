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
)
from dad3dheads_tpu_torch.ops.preprocess import normalize_images, normalize_images_reference

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


def test_wrappers_refuse_other_devices():
    with pytest.raises(ValueError, match="cpu or cuda"):
        blend_shapes_fused(
            torch.empty((2, 4), device="meta"), torch.empty((4, 6), device="meta"), torch.empty((2, 3), device="meta")
        )
    with pytest.raises(ValueError, match="cpu or cuda"):
        normalize_images(torch.empty((1, 4, 4, 3), dtype=torch.uint8, device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 256, 256, 3), (3, 250, 131, 3)])
def test_normalize_kernel_matches_plain(cuda, shape):
    """The kernel rounds the multiply and the add separately, as the plain
    version does: tolerance 1e-6."""
    x = torch.randint(0, 256, shape, generator=torch.Generator().manual_seed(0), dtype=torch.uint8).to(cuda)
    before = normalize_images.launches
    for mode in MODES:
        out = normalize_images(x, mode)
        assert out.dtype == torch.float32 and out.shape == x.shape
        assert (out - normalize_images_reference(x, mode)).abs().max().item() <= 1e-6
    assert normalize_images.launches == before + len(MODES)
    unaligned = x[1:]  # a batch slice: not 16-byte aligned for odd sizes
    assert (normalize_images(unaligned) - normalize_images_reference(unaligned)).abs().max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7, 256])
def test_blendshapes_kernel_matches_plain(cuda, B):
    """Full FLAME width; fp32 sums in another order: abs 1e-4, rel 1e-5."""
    dirs, template = _flame_flat()
    dirs_t, tmpl_t = torch.from_numpy(dirs).to(cuda), torch.from_numpy(template).to(cuda)
    betas = torch.randn((B, 400), generator=torch.Generator().manual_seed(B)).to(cuda)
    before = blend_shapes_fused.launches
    out = blend_shapes_fused(betas, dirs_t, tmpl_t)
    ref = blend_shapes_fused_reference(betas, dirs_t, tmpl_t)
    assert blend_shapes_fused.launches == before + 1
    assert out.shape == (B, 5023, 3)
    err = (out - ref).abs().max().item()
    assert err <= 1e-4 and err / ref.abs().max().item() <= 1e-5


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
@pytest.mark.parametrize("B", [1, 7, 64, 128])
def test_blendshapes_backward_kernel_matches_plain(cuda, B):
    """d_betas, d_shapedirs, d_template against the plain version, each
    within 1e-5 of its sum of absolute products; the same bits on a second
    launch (no atomics); d_shapedirs only when asked for."""
    dirs, _ = _flame_flat()
    dirs_t = torch.from_numpy(dirs).to(cuda)
    gen = torch.Generator().manual_seed(B)
    g = torch.randn((B, dirs.shape[1]), generator=gen).to(cuda)
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
