"""The port's geometry (rotation, LBS, FLAME decode, projection, landmarks,
host preprocessing helpers) against the JAX package on the same inputs.

Tolerance 1e-5 throughout: both sides are fp32 (the reference at
Precision.HIGHEST), and the sums run in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dad3dheads_tpu import assets
from dad3dheads_tpu.core import flame as jflame
from dad3dheads_tpu.core import landmarks as jlm
from dad3dheads_tpu.core.lbs import lbs as jax_lbs
from dad3dheads_tpu.core import projection as jproj
from dad3dheads_tpu.core import rotation as jrot
from dad3dheads_tpu.ops import preprocess as jpre
from dad3dheads_tpu_torch.core import flame as tflame
from dad3dheads_tpu_torch.core import landmarks as tlm
from dad3dheads_tpu_torch.core.lbs import lbs as torch_lbs
from dad3dheads_tpu_torch.core import projection as tproj
from dad3dheads_tpu_torch.core import rotation as trot
from dad3dheads_tpu_torch.ops import preprocess as tpre


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tests run beside other test processes: two torch threads each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


ATOL = 1e-5


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _close(out, ref, atol=ATOL):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=atol)


@pytest.fixture(scope="module")
def models():
    arrays = assets.load_flame_model()
    return jflame.FlameModel.from_arrays(arrays), tflame.FlameModel.from_arrays(arrays)


def _random_3dmm(seed, B=4):
    """Shape/expression/jaw in the heads' tanh*3 range, pose near identity."""
    x = np.random.default_rng(seed).normal(size=(B, 413)).astype(np.float32)
    x[:, :403] = np.tanh(x[:, :403]) * 3.0
    x[:, 403:409] = x[:, 403:409] * 0.3 + np.asarray([1, 0, 0, 0, 1, 0], np.float32)
    x[:, 409:] *= 0.1
    return x


def test_rot_mat_from_6dof():
    v = np.random.default_rng(0).normal(size=(8, 6)).astype(np.float32)
    v[0] = 0.0  # the zero-safe norm
    _close(trot.rot_mat_from_6dof(_t(v)), jrot.rot_mat_from_6dof(jnp.asarray(v)))


def test_rodrigues():
    aa = np.random.default_rng(1).normal(size=(8, 3)).astype(np.float32)
    aa[0] = 0.0
    _close(trot.rodrigues(_t(aa)), jrot.rodrigues(jnp.asarray(aa)))


def test_rotate_vertices():
    rng = np.random.default_rng(2)
    R = rng.normal(size=(3, 3, 3)).astype(np.float32)
    v = rng.normal(size=(3, 50, 3)).astype(np.float32)
    _close(trot.rotate_vertices(_t(R), _t(v)), jrot.rotate_vertices(jnp.asarray(R), jnp.asarray(v)))


def test_from_3dmm_slices_every_group():
    x = _random_3dmm(3)
    jp = jflame.FlameParams.from_3dmm(jnp.asarray(x))
    tp = tflame.FlameParams.from_3dmm(_t(x))
    for key in ("shape", "expression", "rotation", "translation", "scale", "jaw", "eyeballs", "neck"):
        np.testing.assert_array_equal(getattr(tp, key).numpy(), np.asarray(getattr(jp, key)))


@pytest.mark.parametrize("zero_rot,zero_jaw", [(False, False), (True, True)])
def test_flame_decode_full_flame(models, zero_rot, zero_jaw):
    jm, tm = models
    x = _random_3dmm(4)
    ref = jflame.flame_decode(jm, jflame.FlameParams.from_3dmm(jnp.asarray(x)), zero_rot, zero_jaw)
    out = tflame.flame_decode(tm, tflame.FlameParams.from_3dmm(_t(x)), zero_rot, zero_jaw)
    assert out.shape == (4, 5023, 3)
    _close(out, ref)


def test_lbs_full_flame():
    arrays = assets.load_flame_model()
    rng = np.random.default_rng(5)
    betas = rng.normal(size=(2, 400)).astype(np.float32)
    pose = (rng.normal(size=(2, 15)) * 0.2).astype(np.float32)
    args = (arrays.v_template, arrays.shapedirs, arrays.posedirs, arrays.j_regressor)
    jv, jj = jax_lbs(jnp.asarray(betas), jnp.asarray(pose), *map(jnp.asarray, args),
                     list(arrays.parents), jnp.asarray(arrays.lbs_weights))
    tv, tj = torch_lbs(_t(betas), _t(pose), *map(_t, args), list(arrays.parents), _t(arrays.lbs_weights))
    _close(tv, jv)
    _close(tj, jj)


def test_weak_perspective_project():
    rng = np.random.default_rng(6)
    v = rng.normal(size=(3, 40, 3)).astype(np.float32)
    s = rng.normal(size=(3, 1)).astype(np.float32) * 0.1
    t = rng.normal(size=(3, 3)).astype(np.float32) * 0.1
    ref = jproj.weak_perspective_project(jnp.asarray(v), jnp.asarray(s), jnp.asarray(t), 256)
    _close(tproj.weak_perspective_project(_t(v), _t(s), _t(t), 256), ref, atol=1e-4)


def _yaw_pose(yaw_deg):
    """(B, 15) full pose whose global rotation is a pure yaw, neck zero."""
    pose = np.zeros((len(yaw_deg), 15), np.float32)
    pose[:, 1] = np.radians(np.asarray(yaw_deg, np.float64)).astype(np.float32)
    return pose


# exactly at the +-39 degree clamp, beyond it on both sides, and inside
YAWS = [0.0, 12.0, -12.0, 39.0, -39.0, 45.0, -45.0, 80.0, -80.0, 38.0, -38.0]


def test_dynamic_landmark_bin_at_and_beyond_the_clamp():
    pose = _yaw_pose(YAWS)
    ref = np.asarray(jlm.dynamic_landmark_bin(jnp.asarray(pose)))
    out = tlm.dynamic_landmark_bin(_t(pose)).numpy()
    np.testing.assert_array_equal(out, ref)
    # +39 yaw and everything past it share the last bin; -39 and past it bin 39
    assert out[YAWS.index(39.0)] == out[YAWS.index(45.0)] == out[YAWS.index(80.0)] == 78
    assert out[YAWS.index(-39.0)] == out[YAWS.index(-45.0)] == out[YAWS.index(-80.0)] == 39


def test_get_68_landmarks(models):
    jm, tm = models
    x = _random_3dmm(7, B=len(YAWS))
    verts_j = jflame.flame_decode(jm, jflame.FlameParams.from_3dmm(jnp.asarray(x)))
    verts = _t(np.asarray(verts_j))
    pose = _yaw_pose(YAWS)
    jemb, temb = jlm.LandmarkEmbedding.load(), tlm.LandmarkEmbedding.load()
    for full_pose in (None, pose):
        ref = jlm.get_68_landmarks(verts_j, jemb, None if full_pose is None else jnp.asarray(full_pose))
        out = tlm.get_68_landmarks(verts, temb, None if full_pose is None else _t(full_pose))
        assert out.shape == (len(YAWS), 68, 3)
        _close(out, ref)


def test_host_helpers_match():
    rng = np.random.default_rng(8)
    image = rng.integers(0, 256, size=(40, 70, 3), dtype=np.uint8)
    for mode in ("longest_max_size", "resize"):
        for normalize in ("imagenet", "none"):
            j = jpre.preprocess_image_np(image, 64, normalize=normalize, mode=mode)
            t = tpre.preprocess_image_np(image, 64, normalize=normalize, mode=mode)
            np.testing.assert_array_equal(t[0], j[0])
            np.testing.assert_array_equal(np.asarray(t[1]), np.asarray(j[1]))
            assert t[2] == j[2]
    lms = rng.uniform(0, 64, size=(68, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        tpre.readjust_landmarks_np(lms, [3, 4, 0, 0], 0.9), jpre.readjust_landmarks_np(lms, [3, 4, 0, 0], 0.9)
    )
    p = _random_3dmm(9, B=2)
    for scale in (0.9, np.asarray([0.8, 0.9], np.float32)):
        np.testing.assert_array_equal(
            tpre.readjust_3dmm_np(p, [3, 4, 5, 6], scale, 64), jpre.readjust_3dmm_np(p, [3, 4, 5, 6], scale, 64)
        )
