"""The training path's pieces against the JAX package on the CPU: the
blendshape backward, the heatmap encoder, the losses, the metric panel and
the synthetic targets. Inputs are drawn with numpy and handed to both; each
test states its tolerance."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dad3dheads_tpu import losses as jlosses
from dad3dheads_tpu import metrics as jmetrics
from dad3dheads_tpu.constants import (
    INPUT_BBOX_KEY,
    INPUT_IMAGE_KEY,
    OUTPUT_2D_LANDMARKS,
    OUTPUT_3DMM_PARAMS,
    OUTPUT_LANDMARKS_HEATMAP,
    TARGET_2D_FULL_LANDMARKS,
    TARGET_2D_LANDMARKS,
    TARGET_2D_LANDMARKS_PRESENCE,
    TARGET_3D_MODEL_VERTICES,
    TARGET_LANDMARKS_HEATMAP,
)
from dad3dheads_tpu_torch import losses as tlosses
from dad3dheads_tpu_torch import metrics as tmetrics
from dad3dheads_tpu_torch.core import FlameModel, LandmarkEmbedding
from dad3dheads_tpu_torch.core.projection import heatmap_to_keypoints, normalize_to_cube
from dad3dheads_tpu_torch.data.synthetic import random_3dmm, synthetic_batch, synthetic_targets
from dad3dheads_tpu_torch.ops.blendshapes import (
    blend_shapes_fused,
    blend_shapes_fused_backward,
    blend_shapes_fused_backward_reference,
)
from dad3dheads_tpu_torch.ops.heatmap import decode_heatmap_uint8, encode_heatmap

IMG = 64


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def flame_flat():
    from dad3dheads_tpu import assets

    arrays = assets.load_flame_model()
    V = arrays.v_template.shape[0]
    return arrays.shapedirs.reshape(V * 3, -1).T.copy(), arrays.v_template


# -- kernel 1b: the blendshape backward ---------------------------------------


def test_backward_plain_matches_fused_flat_bwd(flame_flat):
    """Full FLAME width, B = 7; against the JAX custom VJP's backward
    (Precision.HIGHEST): atol 1e-4 on d_betas (sums of 15,069 products of
    size ~1e-2), 1e-5 on d_dirs and d_template (sums of 7)."""
    from dad3dheads_tpu.ops.blendshapes import _fused_flat_bwd

    dirs, _ = flame_flat
    rng = np.random.default_rng(21)
    betas = rng.normal(size=(7, dirs.shape[0])).astype(np.float32)
    g = rng.normal(size=(7, dirs.shape[1])).astype(np.float32)
    ref = _fused_flat_bwd((jnp.asarray(betas), jnp.asarray(dirs)), jnp.asarray(g))
    out = blend_shapes_fused_backward(t(g), t(betas), t(dirs))
    for o, r, atol in zip(out, ref, (1e-4, 1e-5, 1e-5)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=atol)


def test_backward_matches_jax_grad_through_blend_shapes_fused(flame_flat):
    """jax.grad of a loss through the JAX package's blend_shapes_fused (the
    XLA path) against torch.autograd through the port's: tolerance 1e-5
    relative to the largest gradient."""
    from dad3dheads_tpu.ops.blendshapes import blend_shapes_fused as jax_blend

    dirs, template = flame_flat
    rng = np.random.default_rng(22)
    betas = rng.normal(size=(3, dirs.shape[0])).astype(np.float32)
    w = rng.normal(size=(3, template.shape[0], 3)).astype(np.float32)

    def jloss(b, d, tm):
        return jnp.sum(jax_blend(b, d, tm, force_xla=True) * w)

    refs = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(betas), jnp.asarray(dirs), jnp.asarray(template))
    tb, td, tt = (t(a).clone().requires_grad_(True) for a in (betas, dirs, template))
    torch.sum(blend_shapes_fused(tb, td, tt) * t(w)).backward()
    for got, ref in zip((tb.grad, td.grad, tt.grad), refs):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * np.abs(ref).max())


def test_backward_gradcheck_float64():
    """The autograd Function against finite differences at tiny shapes."""
    gen = torch.Generator().manual_seed(23)
    args = [torch.randn(s, generator=gen, dtype=torch.float64, requires_grad=True) for s in ((3, 5), (5, 12), (4, 3))]
    assert torch.autograd.gradcheck(blend_shapes_fused, args)


def test_backward_respects_needs_input_grad():
    """Without a gradient for the FLAME constants, none is computed."""
    gen = torch.Generator().manual_seed(24)
    betas = torch.randn((2, 5), generator=gen, requires_grad=True)
    dirs, tmpl = torch.randn((5, 12), generator=gen), torch.randn((4, 3), generator=gen)
    out = blend_shapes_fused(betas, dirs, tmpl)
    out.sum().backward()
    assert dirs.grad is None and tmpl.grad is None
    g = torch.ones((2, 12))
    np.testing.assert_allclose(betas.grad.numpy(), blend_shapes_fused_backward_reference(g, betas, dirs)[0].numpy())
    assert blend_shapes_fused_backward_reference(g, betas, dirs, (True, False, False))[1:] == (None, None)


# -- heatmaps -----------------------------------------------------------------


@pytest.mark.parametrize("img_size,stride,radius", [(256, 4, 5), (64, 4, 5), (128, 2, 3)])
def test_encode_heatmap_bit_equal(img_size, stride, radius):
    """uint8 levels identical, including keypoints off the image, on the
    integer grid, and absent ones."""
    from dad3dheads_tpu.ops.heatmap import encode_heatmap as jax_encode

    rng = np.random.default_rng(img_size + radius)
    kp = rng.uniform(-10, img_size + 10, size=(3, 68, 2)).astype(np.float32)
    kp[0, :5] = np.floor(kp[0, :5])
    presence = rng.uniform(size=(3, 68)) > 0.2
    ref = np.asarray(jax_encode(jnp.asarray(kp), jnp.asarray(presence), img_size, stride, radius))
    out = encode_heatmap(t(kp), t(presence), img_size, stride, radius)
    assert out.dtype == torch.uint8 and out.shape == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(decode_heatmap_uint8(out).numpy(), ref.astype(np.float32) / 255.0)


# -- projection helpers -------------------------------------------------------


def test_normalize_to_cube_and_heatmap_to_keypoints_match_jax():
    """normalize_to_cube at 1e-6; the argmax decode exactly."""
    from dad3dheads_tpu.core.projection import heatmap_to_keypoints as jax_h2k
    from dad3dheads_tpu.core.projection import normalize_to_cube as jax_ntc

    rng = np.random.default_rng(25)
    v = rng.normal(size=(2, 300, 3)).astype(np.float32)
    np.testing.assert_allclose(normalize_to_cube(t(v)).numpy(), np.asarray(jax_ntc(jnp.asarray(v))), atol=1e-6)
    np.testing.assert_allclose(normalize_to_cube(t(v[0])).numpy(), np.asarray(jax_ntc(jnp.asarray(v[0]))), atol=1e-6)
    hm = rng.normal(size=(2, 16, 16, 68)).astype(np.float32)
    np.testing.assert_array_equal(heatmap_to_keypoints(t(hm), 4).numpy(), np.asarray(jax_h2k(jnp.asarray(hm), 4)))


# -- losses and metrics -------------------------------------------------------


def _loss_inputs(seed: int = 26, B: int = 3):
    """Model outputs, targets and a shared decode drawn with numpy."""
    from dad3dheads_tpu.assets import load_flame_model

    rng = np.random.default_rng(seed)
    V = load_flame_model().v_template.shape[0]
    S = IMG // 4
    outputs = {
        OUTPUT_LANDMARKS_HEATMAP: rng.normal(size=(B, S, S, 68)),
        OUTPUT_2D_LANDMARKS: rng.uniform(0, 1, size=(B, 68, 2)),
        OUTPUT_3DMM_PARAMS: rng.normal(size=(B, 413)) * 0.1,
    }
    targets = {
        TARGET_LANDMARKS_HEATMAP: rng.uniform(0, 1, size=(B, S, S, 68)),
        TARGET_2D_LANDMARKS: rng.uniform(0, 1, size=(B, 68, 2)),
        TARGET_2D_LANDMARKS_PRESENCE: (rng.uniform(size=(B, 68)) > 0.3).astype(np.float32),
        TARGET_3D_MODEL_VERTICES: rng.normal(size=(B, V, 3)) * 0.1,
        TARGET_2D_FULL_LANDMARKS: rng.uniform(0, IMG, size=(B, V, 2)),
        INPUT_BBOX_KEY: np.tile(np.array([[0.0, 0.0, IMG, IMG]]), (B, 1)),
    }
    shared = {
        "vertices_zero_rot": rng.normal(size=(B, V, 3)) * 0.1,
        "vertices_rot": rng.normal(size=(B, V, 3)) * 0.1,
        "reprojected_2d": rng.uniform(0, IMG, size=(B, V, 2)),
    }
    f32 = lambda d: {k: np.asarray(v, np.float32) for k, v in d.items()}  # noqa: E731
    return f32(outputs), f32(targets), f32(shared)


def _both(d):
    return {k: jnp.asarray(v) for k, v in d.items()}, {k: t(v) for k, v in d.items()}


@pytest.fixture(scope="module")
def loss_inputs():
    return _loss_inputs()


@pytest.mark.parametrize("name", ["l1", "l2", "smooth_l1"])
def test_criteria_match_jax(name):
    """Tolerance 1e-6 relative."""
    rng = np.random.default_rng(27)
    a, b = (rng.normal(size=(4, 50, 3)).astype(np.float32) * 2 for _ in range(2))
    ref = float(jlosses.CRITERIA[name](jnp.asarray(a), jnp.asarray(b)))
    assert float(tlosses.CRITERIA[name](t(a), t(b))) == pytest.approx(ref, rel=1e-6)


def test_individual_losses_match_jax(loss_inputs):
    """iou, landmarks with visibility, vertices 3D (normalized subsets) and
    reprojection (subsets): 1e-5 relative."""
    outputs, targets, shared = loss_inputs
    (jo, to), (jt, tt), (js, ts) = _both(outputs), _both(targets), _both(shared)
    pairs = [
        (jlosses.iou_loss(jo[OUTPUT_LANDMARKS_HEATMAP], jt[TARGET_LANDMARKS_HEATMAP]),
         tlosses.iou_loss(to[OUTPUT_LANDMARKS_HEATMAP], tt[TARGET_LANDMARKS_HEATMAP])),
        (jlosses.landmarks_loss_w_visibility(jo[OUTPUT_2D_LANDMARKS], jt[TARGET_2D_LANDMARKS_PRESENCE],
                                             jt[TARGET_2D_LANDMARKS], jt[TARGET_2D_LANDMARKS_PRESENCE]),
         tlosses.landmarks_loss_w_visibility(to[OUTPUT_2D_LANDMARKS], tt[TARGET_2D_LANDMARKS_PRESENCE],
                                             tt[TARGET_2D_LANDMARKS], tt[TARGET_2D_LANDMARKS_PRESENCE])),
        (jlosses.vertices_3d_loss(js["vertices_zero_rot"], jt[TARGET_3D_MODEL_VERTICES],
                                  jlosses.SubsetWeights.from_config(jlosses.DEFAULT_V3D_SUBSETS)),
         tlosses.vertices_3d_loss(ts["vertices_zero_rot"], tt[TARGET_3D_MODEL_VERTICES],
                                  tlosses.SubsetWeights.from_config(tlosses.DEFAULT_V3D_SUBSETS))),
        (jlosses.reprojection_loss(js["reprojected_2d"], jt[TARGET_2D_FULL_LANDMARKS],
                                   jlosses.SubsetWeights.from_config(jlosses.DEFAULT_REPROJ_SUBSETS)),
         tlosses.reprojection_loss(ts["reprojected_2d"], tt[TARGET_2D_FULL_LANDMARKS],
                                   tlosses.SubsetWeights.from_config(tlosses.DEFAULT_REPROJ_SUBSETS))),
    ]
    for ref, out in pairs:
        assert float(out) == pytest.approx(float(ref), rel=1e-5)


def _gated_config(starts):
    return [dict(c, epoch_start=s) for c, s in zip(jlosses.DEFAULT_LOSS_CONFIG, starts)]


@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
@pytest.mark.parametrize("epoch", [0, 2])
def test_loss_module_matches_jax(loss_inputs, reduction, epoch):
    """Every reduction with epoch_start gates 0/1/2/3 at epochs 0 and 2: the
    total and each weighted loss at 1e-5 relative (exactly 0 where gated)."""
    outputs, targets, shared = loss_inputs
    (jo, to), (jt, tt), (js, ts) = _both(outputs), _both(targets), _both(shared)
    config = _gated_config((0, 1, 2, 3))
    jtotal, jd = jlosses.LossModule(config, reduction)(jo, jt, jlosses.SharedFlameDecode(**js), epoch)
    ttotal, td = tlosses.LossModule(config, reduction)(to, tt, tlosses.SharedFlameDecode(**ts), epoch)
    np.testing.assert_allclose(ttotal.numpy(), np.asarray(jtotal), rtol=1e-5)
    assert list(td) == list(jd)
    for k in jd:
        np.testing.assert_allclose(float(td[k]), float(jd[k]), rtol=1e-5)
        if float(jd[k]) == 0.0:
            assert float(td[k]) == 0.0, k


def test_shared_flame_decode_matches_jax():
    """One decode for all geometry losses: 1e-5 (vertices), 1e-3 px."""
    from dad3dheads_tpu.constants import FLAME_CONSTS
    from dad3dheads_tpu.core.flame import FlameModel as JaxFlame

    p = (np.random.default_rng(28).normal(size=(2, 413)) * 0.2).astype(np.float32)
    p[:, 403:409] += np.array([1, 0, 0, 0, 1, 0], np.float32)
    ref = jlosses.shared_flame_decode_raw(JaxFlame.load(), jnp.asarray(p), FLAME_CONSTS, IMG)
    out = tlosses.shared_flame_decode_raw(FlameModel.load(), t(p), FLAME_CONSTS, IMG)
    np.testing.assert_allclose(out.vertices_zero_rot.numpy(), np.asarray(ref.vertices_zero_rot), atol=1e-5)
    np.testing.assert_allclose(out.vertices_rot.numpy(), np.asarray(ref.vertices_rot), atol=1e-5)
    np.testing.assert_allclose(out.reprojected_2d.numpy(), np.asarray(ref.reprojected_2d), atol=1e-3)


def test_step_metrics_match_jax(loss_inputs):
    """The metric panel at 1e-5 relative (failure rates exactly)."""
    outputs, targets, shared = loss_inputs
    rng = np.random.default_rng(29)
    face = rng.normal(size=(3, 40, 3)).astype(np.float32)
    args = dict(
        pred_landmarks=outputs[OUTPUT_2D_LANDMARKS] * IMG,
        target_landmarks=targets[TARGET_2D_LANDMARKS] * IMG,
        pred_heatmap_probs=1.0 / (1.0 + np.exp(-outputs[OUTPUT_LANDMARKS_HEATMAP])),
        target_heatmap=targets[TARGET_LANDMARKS_HEATMAP],
        reprojected_2d_face=shared["reprojected_2d"][:, :40],
        target_full_2d_face=shared["reprojected_2d"][:, :40] + rng.normal(size=(3, 40, 2)).astype(np.float32) * 3,
        pred_vertices_norm=face,
        target_vertices_norm=face + rng.normal(size=face.shape).astype(np.float32) * 0.1,
        bbox=targets[INPUT_BBOX_KEY],
    )
    ref = jmetrics.compute_step_metrics(**{k: jnp.asarray(v) for k, v in args.items()})
    out = tmetrics.compute_step_metrics(**{k: t(np.asarray(v, np.float32)) for k, v in args.items()})
    assert list(out) == list(ref)
    for k in ref:
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-5, err_msg=k)


# -- synthetic batches --------------------------------------------------------


@pytest.fixture(scope="module")
def synthetic_pair():
    """The JAX package's synthetic batch and the port's targets from its
    3DMM vector and image (JAX's random_3dmm patched to return ours)."""
    import dad3dheads_tpu.data.synthetic as jsyn
    from dad3dheads_tpu.core.flame import FlameModel as JaxFlame
    from dad3dheads_tpu.core.landmarks import LandmarkEmbedding as JaxEmb

    params = random_3dmm(torch.Generator().manual_seed(30), 4)
    original = jsyn.random_3dmm
    jsyn.random_3dmm = lambda rng, batch, dtype=jnp.float32: jnp.asarray(params.numpy())
    try:
        ref = jsyn.synthetic_batch(jax.random.PRNGKey(0), JaxFlame.load(), JaxEmb.load(), 4, IMG)
    finally:
        jsyn.random_3dmm = original
    ref = {k: np.asarray(v) for k, v in ref.items()}
    out = synthetic_targets(params, t(ref[INPUT_IMAGE_KEY]), FlameModel.load(), LandmarkEmbedding.load(), IMG)
    return ref, {k: v.numpy() for k, v in out.items()}


def test_synthetic_targets_match_jax(synthetic_pair):
    """Vertices 1e-5, projected 2D and landmarks 1e-3 px (1.6e-5 of the
    image once normalized), presence equal, heatmaps equal on all but a
    texel in 10^4 (a landmark on an integer pixel edge may floor the other
    way after another rounding)."""
    ref, out = synthetic_pair
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].shape == ref[k].shape and out[k].dtype == ref[k].dtype, k
    np.testing.assert_array_equal(out[INPUT_IMAGE_KEY], ref[INPUT_IMAGE_KEY])
    np.testing.assert_array_equal(out[INPUT_BBOX_KEY], ref[INPUT_BBOX_KEY])
    np.testing.assert_allclose(out[TARGET_3D_MODEL_VERTICES], ref[TARGET_3D_MODEL_VERTICES], atol=1e-5)
    np.testing.assert_allclose(out[TARGET_2D_FULL_LANDMARKS], ref[TARGET_2D_FULL_LANDMARKS], atol=1e-3)
    np.testing.assert_allclose(out[TARGET_2D_LANDMARKS], ref[TARGET_2D_LANDMARKS], atol=1e-3 / IMG)
    np.testing.assert_array_equal(out[TARGET_2D_LANDMARKS_PRESENCE], ref[TARGET_2D_LANDMARKS_PRESENCE])
    differ = (out[TARGET_LANDMARKS_HEATMAP] != ref[TARGET_LANDMARKS_HEATMAP]).mean()
    assert differ <= 1e-4, differ
    assert out[TARGET_LANDMARKS_HEATMAP].max() == 255


def test_synthetic_batch_is_seeded_and_plausible():
    """Same generator seed, same batch; scale parameter in [2.5, 6]; most
    landmarks inside the image."""
    from dad3dheads_tpu_torch.constants import flame_param_offset

    flame, emb = FlameModel.load(), LandmarkEmbedding.load()
    a = synthetic_batch(torch.Generator().manual_seed(31), flame, emb, 3, IMG)
    b = synthetic_batch(torch.Generator().manual_seed(31), flame, emb, 3, IMG)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    p = random_3dmm(torch.Generator().manual_seed(32), 64)
    sc = p[:, flame_param_offset("scale")]
    assert float(sc.min()) >= 2.5 and float(sc.max()) <= 6.0
    assert a[TARGET_2D_LANDMARKS_PRESENCE].float().mean() > 0.5
