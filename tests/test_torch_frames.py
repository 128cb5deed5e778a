"""The frames serving path of the port against the JAX package.

``pack_frames_host`` and the scalar table against the JAX functions; the
device preprocess on CPU tensors (the resample kernel's plain version)
against the JAX XLA einsum path and the Pallas kernel in interpret mode;
``predict_frames`` and ``predict_images`` against the JAX predictor on one
``.msgpack`` checkpoint; the predict CLI end to end on the CPU.

The ``cuda``-marked tests hold the resample kernel against its plain version
on the card and skip without one. JAX is imported only inside the tests that
need it, so that on a machine with a card and no JAX they run with
``python -m pytest --noconftest -m cuda tests/test_torch_frames.py``.
"""

import gc
import json
import os

import numpy as np
import pytest
import torch

from dad3dheads_tpu_torch.ops.preprocess_device import (
    frame_scalars,
    pack_frames_host,
    preprocess_frames_device,
    round_half_even_ratio,
)
from dad3dheads_tpu_torch.ops.resample import resample_normalize, resample_normalize_reference


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tests run beside other test processes: two torch threads each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


S = 64
MODES = ("longest_max_size", "resize")
LAYOUTS = ("nhwc", "planar")


def random_frames(rng, n, hmax, wmax):
    """n frames of random sizes in a zero (n, hmax, wmax, 3) buffer, with
    whole-frame boxes on even rows and strict interior boxes on odd ones."""
    frames = np.zeros((n, hmax, wmax, 3), np.uint8)
    sizes, bboxes = [], []
    for i in range(n):
        h = int(rng.integers(24, hmax + 1))
        w = int(rng.integers(24, wmax + 1))
        frames[i, :h, :w] = (rng.uniform(size=(h, w, 3)) * 255).astype(np.uint8)
        if i % 2 == 0:
            bb = [0, 0, w, h]
        else:
            x0 = int(rng.integers(0, w // 3))
            y0 = int(rng.integers(0, h // 3))
            bb = [x0, y0, int(rng.integers(x0 + 12, w + 1)), int(rng.integers(y0 + 12, h + 1))]
        sizes.append([h, w])
        bboxes.append(bb)
    return frames, np.asarray(sizes, np.int32), np.asarray(bboxes, np.int32)


def in_layout(frames, layout):
    """(B, H, W, 3) -> the same frames in ``layout`` (planar: (B, H, 3W))."""
    if layout == "nhwc":
        return frames
    B, H, W, _ = frames.shape
    return np.ascontiguousarray(frames.transpose(0, 1, 3, 2).reshape(B, H, 3 * W))


def port(frames, sizes, bboxes, **kw):
    out = preprocess_frames_device(torch.from_numpy(frames), torch.from_numpy(sizes), torch.from_numpy(bboxes), **kw)
    return [t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy() for t in out]


def jax_preprocess(frames, sizes, bboxes, **kw):
    import jax.numpy as jnp

    from dad3dheads_tpu.ops.preprocess_device import preprocess_frames_device as jax_fn

    return [np.asarray(t, np.float32) if t.dtype == jnp.bfloat16 else np.asarray(t)
            for t in jax_fn(jnp.asarray(frames), sizes, bboxes, **kw)]


# --------------------------------------------------------------------------
# host packing and the scalar table
# --------------------------------------------------------------------------


@pytest.mark.parametrize("planar", (False, True))
@pytest.mark.parametrize("fixed_shape", (None, (160, 200)))
def test_pack_frames_host_is_byte_identical_to_jax(planar, fixed_shape):
    from dad3dheads_tpu.ops.preprocess_device import pack_frames_host as jax_pack

    rng = np.random.default_rng(20)
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in ((70, 90), (150, 61), (33, 199))]
    frames.append(rng.uniform(-20, 300, (40, 50, 3)).astype(np.float32))  # coerced to uint8
    boxes = [[0, 0, 9, 9], [1, 2, 30, 40], [5, 5, 6, 6], [-3, 0, 100, 100]]
    ref = jax_pack(frames, boxes, 6, bucket=64, planar=planar, fixed_shape=fixed_shape)
    out = pack_frames_host(frames, boxes, 6, bucket=64, planar=planar, fixed_shape=fixed_shape)
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_round_half_even_ratio_and_scalars_match_jax():
    """The banker's rounding is bit-exact, and so are the scales and paddings
    that the host readjustment inverts."""
    import jax.numpy as jnp

    from dad3dheads_tpu.ops.preprocess_device import _round_half_even_ratio

    rng = np.random.default_rng(21)
    q = rng.integers(1, 4000, 5000).astype(np.int32)
    p = (rng.integers(0, 4000, 5000) * 2 + rng.integers(0, 2, 5000)).astype(np.int32)
    p[:100] = q[:100] * 7 + q[:100] // 2  # exact halves
    ref = np.asarray(_round_half_even_ratio(jnp.asarray(p), jnp.asarray(q)))
    np.testing.assert_array_equal(round_half_even_ratio(torch.from_numpy(p), torch.from_numpy(q)).numpy(), ref)

    frames, sizes, bboxes = random_frames(rng, 8, 96, 120)
    for mode in MODES:
        _, ref_s, ref_p = jax_preprocess(frames, sizes, bboxes, img_size=S, mode=mode, impl="xla")
        _, scales, paddings = frame_scalars(torch.from_numpy(sizes), torch.from_numpy(bboxes), S, mode)
        np.testing.assert_array_equal(scales.numpy(), ref_s)
        np.testing.assert_array_equal(paddings.numpy(), ref_p)


# --------------------------------------------------------------------------
# the plain version against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("hmax", (96, 640))
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mode", MODES)
def test_preprocess_plain_matches_xla(mode, layout, hmax):
    """atol 1e-4: the same fp32 weights, contracted in another order."""
    rng = np.random.default_rng(22)
    frames, sizes, bboxes = random_frames(rng, 6, min(hmax, 600), 96 if hmax > 96 else 120)
    if hmax > frames.shape[1]:
        frames = np.concatenate([frames, frames[:, : hmax - frames.shape[1]]], axis=1)
    x = in_layout(frames, layout)
    ref = jax_preprocess(x, sizes, bboxes, img_size=S, mode=mode, layout=layout, impl="xla")
    out = port(x, sizes, bboxes, img_size=S, mode=mode, layout=layout)
    assert out[0].shape == (6, S, S, 3) and out[0].dtype == np.float32
    np.testing.assert_allclose(out[0], ref[0], atol=1e-4)
    np.testing.assert_array_equal(out[1], ref[1])
    np.testing.assert_array_equal(out[2], ref[2])


@pytest.mark.parametrize("hmax", (96, 640))
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mode", MODES)
def test_preprocess_plain_matches_pallas_interpret(mode, layout, hmax):
    """atol 1e-3, the bound of the JAX package's own Pallas-vs-XLA test (its
    kernel splits each weight into two bf16 parts). Hmax 640 takes the
    Pallas function's chunked kernel."""
    rng = np.random.default_rng(23)
    frames, sizes, bboxes = random_frames(rng, 4, min(hmax, 600), 96 if hmax > 96 else 120)
    if hmax > frames.shape[1]:
        frames = np.concatenate([frames, frames[:, : hmax - frames.shape[1]]], axis=1)
    x = in_layout(frames, layout)
    ref = jax_preprocess(x, sizes, bboxes, img_size=S, mode=mode, layout=layout, impl="pallas_interpret")
    out = port(x, sizes, bboxes, img_size=S, mode=mode, layout=layout)
    assert np.abs(out[0] - ref[0]).max() < 1e-3
    np.testing.assert_array_equal(out[1], ref[1])
    np.testing.assert_array_equal(out[2], ref[2])


def test_preprocess_identity_crop_is_exact():
    """A box already at img_size resamples with 0/1 weights: exact."""
    from dad3dheads_tpu.ops.preprocess import preprocess_image_np

    rng = np.random.default_rng(24)
    frames = (rng.uniform(size=(2, S, S, 3)) * 255).astype(np.uint8)
    sizes = np.asarray([[S, S]] * 2, np.int32)
    bboxes = np.asarray([[0, 0, S, S]] * 2, np.int32)
    out = port(frames, sizes, bboxes, img_size=S)
    ref = jax_preprocess(frames, sizes, bboxes, img_size=S, impl="xla")
    np.testing.assert_allclose(out[0], ref[0], atol=1e-6)
    np.testing.assert_allclose(out[0][0], preprocess_image_np(frames[0], S)[0], atol=1e-5)
    assert (out[1] == 1.0).all() and (out[2] == 0).all()


def test_preprocess_clamps_loose_boxes():
    """A box past the frame equals the box clamped to it."""
    rng = np.random.default_rng(25)
    frames, sizes, _ = random_frames(rng, 2, 96, 120)
    (h0, w0), (h1, w1) = sizes
    loose = np.asarray([[-20, -10, w0 + 50, h0 + 30], [0, 0, 10_000, 10_000]], np.int32)
    clamped = np.asarray([[0, 0, w0, h0], [0, 0, w1, h1]], np.int32)
    for a, b in zip(port(frames, sizes, loose, img_size=S), port(frames, sizes, clamped, img_size=S)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", MODES)
def test_preprocess_bf16_output_within_bf16_rounding(mode):
    """out_dtype bfloat16 rounds only at the store: within half a bf16 ulp
    of the fp32 result, and within the JAX bf16 path's 3e-2 of XLA."""
    rng = np.random.default_rng(26)
    frames, sizes, bboxes = random_frames(rng, 4, 96, 120)
    f32 = port(frames, sizes, bboxes, img_size=S, mode=mode)[0]
    bf16 = port(frames, sizes, bboxes, img_size=S, mode=mode, out_dtype=torch.bfloat16)[0]
    np.testing.assert_array_equal(bf16, torch.from_numpy(f32).bfloat16().float().numpy())
    ref = jax_preprocess(frames, sizes, bboxes, img_size=S, mode=mode, impl="xla")[0]
    assert np.abs(bf16 - ref).max() < 3e-2


def test_resample_wrapper_dispatch():
    """CPU tensors take the plain version and count no launch; other devices
    are refused."""
    rng = np.random.default_rng(27)
    frames, sizes, bboxes = random_frames(rng, 2, 96, 120)
    scalars, _, _ = frame_scalars(torch.from_numpy(sizes), torch.from_numpy(bboxes), S)
    before = resample_normalize.launches
    x = torch.from_numpy(frames)
    assert torch.equal(resample_normalize(x, scalars, S), resample_normalize_reference(x, scalars, S))
    assert resample_normalize.launches == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        resample_normalize(torch.empty((1, 8, 8, 3), dtype=torch.uint8, device="meta"), scalars[:1], S)


def plan_tables(rng, hmax, wmax):
    """Scalar tables of frame_scalars, both modes, on frames up to (hmax,
    wmax) with whole-frame, 2-pixel, loose, flat, thin and interior boxes."""
    sizes, boxes = [], []
    for i in range(24):
        h = hmax - 8 if i < 2 else int(rng.integers(8, hmax - 7))
        w = wmax if i < 2 else int(rng.integers(8, wmax + 1))
        x0, y0 = int(rng.integers(0, w - 2)), int(rng.integers(0, h - 2))
        boxes.append([[0, 0, w, h], [x0, y0, x0 + 2, y0 + 2], [-40, -25, w + 60, h + 35], [0, h // 3, w, h // 3 + 5],
                      [x0, 0, x0 + 3, h], [x0, y0, int(rng.integers(x0 + 1, w + 1)), int(rng.integers(y0 + 1, h + 1))]]
                     [i % 6])
        sizes.append([h, w])
    sizes, boxes = torch.tensor(sizes, dtype=torch.int32), torch.tensor(boxes, dtype=torch.int32)
    return [frame_scalars(sizes, boxes, 256, mode)[0] for mode in MODES]


def test_resample_plan_covers_every_tap():
    """The kernel sums each output row over the source columns [x0, x0 +
    win), win = min(bw + 1, Wmax - x0) (csrc/resample.cu column_window), in
    shared memory that resample_plan sizes from Wmax alone. For tables of
    frame_scalars (both modes; exact area, 2-tap area and linear taps; Hmax
    640 and 1088; a whole 1920x1080 frame at f = 7.5) every non-zero column
    tap of axis_weights lies in that window, the window fits the plan's row,
    and the bands cover the 256 output rows."""
    from dad3dheads_tpu_torch.ops.resample import axis_weights, resample_plan

    rng = np.random.default_rng(28)
    schemes = set()
    for hmax, wmax in ((640, 480), (1088, 1920)):
        band, smem = resample_plan(wmax)
        assert band >= 1 and smem == band * 3 * wmax * 4 <= 232448
        assert -(-256 // band) * band >= 256
        for s in plan_tables(rng, hmax, wmax):
            x0, bw = s[:, 4], s[:, 5]
            use_area, use_exact = s[:, 8] != 0, s[:, 9] != 0
            schemes |= {(bool(a), bool(e)) for a, e in zip(use_area, use_exact)}
            wx = axis_weights(wmax, 256, x0, bw, s[:, 6], s[:, 7], use_area, use_exact)
            win = torch.minimum(bw + 1, wmax - x0)
            assert (win <= wmax).all() and (x0 + bw <= wmax).all()
            cols = torch.arange(wmax)[None, None, :]
            inside = (cols >= x0[:, None, None]) & (cols < (x0 + win)[:, None, None])
            assert not ((wx != 0) & ~inside).any()
            assert (wx != 0).any(dim=(1, 2)).all()  # every image has taps
    assert schemes == {(True, True), (True, False), (False, False)}, schemes
    assert resample_plan(1920)[0] >= 1 and resample_plan(19370)[0] == 1
    with pytest.raises(ValueError, match="shared memory"):
        resample_plan(19371)


# --------------------------------------------------------------------------
# the predictor: predict_frames and predict_images against the JAX predictor
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def predictors(tmp_path_factory):
    from dad3dheads_tpu.api import predictor as jpred
    from dad3dheads_tpu_torch.api import predictor as tpred

    from .test_torch_predictor import seeded_variables

    path = str(tmp_path_factory.mktemp("ck") / "dad_3dnet.msgpack")
    jpred.save_predictor_checkpoint(seeded_variables(2), path)
    config = {"img_size": S}
    return (
        jpred.FaceMeshPredictor(config=config, checkpoint_path=path),
        tpred.FaceMeshPredictor(config=config, checkpoint_path=path, device="cpu"),
    )


def assert_predictions_close(out, ref, with_mesh=True):
    """3DMM and vertices atol 1e-4, projected 1e-2 px, points within 1 px
    (they are truncated to ints after the readjustment)."""
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert set(o) == set(r)
        for key in r:
            assert np.shape(o[key]) == np.shape(r[key]), key
        np.testing.assert_allclose(o["3dmm_params"], r["3dmm_params"], atol=1e-4)
        assert np.abs(np.asarray(o["points"]) - np.asarray(r["points"])).max() <= 1
        if with_mesh:
            np.testing.assert_allclose(o["3d_vertices"], r["3d_vertices"], atol=1e-4)
            np.testing.assert_allclose(o["projected_vertices"], r["projected_vertices"], atol=1e-2)


def frame_list(seed):
    rng = np.random.default_rng(seed)
    shapes = ((70, 90), (120, 64), (64, 64), (40, 150), (99, 99))
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in shapes]


@pytest.mark.parametrize("with_mesh", (True, False))
def test_predict_frames_matches_jax(predictors, with_mesh):
    """Five frames in batches of two (two in flight, a padded last batch),
    whole-frame, interior and loose boxes."""
    jp, tp = predictors
    frames = frame_list(30)
    boxes = [[0, 0, 90, 70], [5, 10, 60, 100], [-10, -10, 500, 500], [20, 3, 120, 39], [30, 30, 31, 31]]
    ref = jp.predict_frames(frames, bboxes=boxes, batch_size=2, with_mesh=with_mesh)
    out = tp.predict_frames(frames, bboxes=boxes, batch_size=2, with_mesh=with_mesh)
    assert_predictions_close(out, ref, with_mesh)
    assert all(o["points"].dtype == r["points"].dtype for o, r in zip(out, ref))


def test_predict_frames_without_boxes_matches_jax(predictors):
    jp, tp = predictors
    frames = frame_list(31)[:3]
    assert_predictions_close(tp.predict_frames(frames, batch_size=4), jp.predict_frames(frames, batch_size=4))
    assert tp.predict_frames([]) == []


def test_predict_frames_feeds_the_bf16_trunk_bf16(monkeypatch):
    """Under the bf16 trunk the resample kernel's plain version writes bf16
    (rounded once, at the store), which the trunk reads uncast, and
    predict_frames is bit-identical to the route through the fp32 resample
    and autocast's cast."""
    from dad3dheads_tpu_torch.api import predictor as tpred

    from .test_torch_predictor import trunk_input_dtypes

    pred = tpred.FaceMeshPredictor({"img_size": S, "model": {"backbone": "resnet50", "dtype": "bfloat16"}},
                                   device="cpu", seed=4)
    frames = frame_list(34)[:3]
    boxes = [[0, 0, 90, 70], [5, 10, 60, 100], [-10, -10, 500, 500]]
    seen, hook = trunk_input_dtypes(pred.model)
    out = pred.predict_frames(frames, bboxes=boxes, batch_size=2)
    assert seen == [torch.bfloat16] * 2
    fp32_resample = tpred.preprocess_frames_device
    monkeypatch.setattr(tpred, "preprocess_frames_device",
                        lambda *args, **kw: fp32_resample(*args, **{**kw, "out_dtype": torch.float32}))
    ref = pred.predict_frames(frames, bboxes=boxes, batch_size=2)
    hook.remove()
    assert seen[2:] == [torch.float32] * 2
    for o, r in zip(out, ref):
        assert set(o) == set(r)
        for key in r:
            np.testing.assert_array_equal(o[key], r[key], err_msg=key)


@pytest.mark.parametrize("num_workers", (0, 2))
def test_predict_images_matches_jax(predictors, num_workers):
    """Host cv2 resize on worker threads, fixed-shape padded batches; a float
    image is rounded and clipped to uint8 as the JAX predictor does."""
    jp, tp = predictors
    images = frame_list(32)
    images[1] = images[1].astype(np.float32) + 0.4
    ref = jp.predict_images(images, batch_size=2, num_workers=num_workers)
    out = tp.predict_images(images, batch_size=2, num_workers=num_workers)
    assert_predictions_close(out, ref)
    ref = jp.predict_images(images[:3], batch_size=2, with_mesh=False)
    out = tp.predict_images(images[:3], batch_size=2, with_mesh=False)
    assert_predictions_close(out, ref, with_mesh=False)


def test_predict_images_device_tensor_matches_jax(predictors):
    """One tensor of network-size images (N, S, S, 3), uint8 and float: the
    device branch, readjusted with the identity."""
    import jax.numpy as jnp

    jp, tp = predictors
    images = np.random.default_rng(33).integers(0, 256, (5, S, S, 3), dtype=np.uint8)
    ref = jp.predict_images(jnp.asarray(images), batch_size=2)
    out = tp.predict_images(torch.from_numpy(images), batch_size=2)
    assert_predictions_close(out, ref)
    as_float = torch.from_numpy(images).float() + 0.3
    assert_predictions_close(tp.predict_images(as_float, batch_size=4, with_mesh=False),
                             jp.predict_images(jnp.asarray(images), batch_size=4, with_mesh=False), with_mesh=False)


def test_predictor_refuses_what_is_not_ported(tmp_path, monkeypatch):
    from dad3dheads_tpu_torch.api import FaceMeshPredictor
    from dad3dheads_tpu_torch.api import predictor as tpred
    from dad3dheads_tpu_torch.parallel import make_mesh
    from dad3dheads_tpu_torch.weights import flax_from_state_dict, save_flax_msgpack

    with pytest.raises(FileNotFoundError, match="checkpoint not found"):
        FaceMeshPredictor({"img_size": S}, checkpoint_path=str(tmp_path / "missing.msgpack"), device="cpu")
    with pytest.raises(ValueError, match="resnet50"):  # int8 covers the flagship only
        FaceMeshPredictor({"img_size": S, "model": {"backbone": "mobilenet_w1"}, "quant_amax": "amax.npz"},
                          device="cpu")
    with pytest.raises(RuntimeError, match="the mesh names cuda:99"):  # no fallback hides a missing card
        FaceMeshPredictor({"img_size": S}, mesh=make_mesh(["cuda:99", "cuda:99"]))
    with pytest.raises(FileNotFoundError, match="allow-random-weights"):
        FaceMeshPredictor.dad_3dnet(device="cpu", require_weights=True)
    config = tmp_path / "predictor.yaml"
    config.write_text(f"checkpoint: {tmp_path / 'absent.msgpack'}\nimg_size: {S}\n")
    pred = FaceMeshPredictor.from_yaml(str(config), device="cpu")
    assert pred.loaded_checkpoint is None and pred._img_size == S
    # model_url: a file:// URL (never the network) into a cache dir moved to tmp_path
    cache = tmp_path / "cache"
    monkeypatch.setattr(tpred, "_CKPT_DIR", str(cache))
    published = save_flax_msgpack(flax_from_state_dict(pred.model.state_dict()), str(tmp_path / "pub.msgpack"))
    url = f"file://{published}"
    with pytest.raises(FileNotFoundError, match="checkpoint not found"):  # a given path is never replaced
        FaceMeshPredictor({"img_size": S, "model_url": url}, checkpoint_path=str(tmp_path / "typo.msgpack"),
                          device="cpu")
    assert not tpred.model_exists()
    got = FaceMeshPredictor({"img_size": S, "model_url": url}, device="cpu", seed=1)
    assert got.loaded_checkpoint == str(cache / "dad_3dnet.msgpack") and tpred.model_exists()
    with open(published, "rb") as a, open(got.loaded_checkpoint, "rb") as b:
        assert a.read() == b.read()
    ref = pred.model.state_dict()
    assert all(torch.equal(v, ref[k]) for k, v in got.model.state_dict().items())
    with pytest.raises(RuntimeError, match="failed downloading"):
        tpred.download_model(f"file://{tmp_path / 'missing.msgpack'}", retries=0, filename="other.msgpack")


# --------------------------------------------------------------------------
# the predict CLI on the CPU
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    import cv2

    d = tmp_path_factory.mktemp("imgs")
    for i, (h, w) in enumerate(((80, 100), (96, 72), (64, 64))):
        img = np.random.default_rng(40 + i).integers(0, 256, (h, w, 3), dtype=np.uint8)
        cv2.imwrite(str(d / f"img{i}.png"), img)
    return d


@pytest.mark.parametrize("fmt,extra", [("jsonl", []), ("obj", []), ("jsonl", ["--bboxes"]), ("json", ["--device-preprocess"])])
def test_predict_cli(image_dir, tmp_path, fmt, extra):
    from dad3dheads_tpu_torch.cli.predict import main

    if extra == ["--bboxes"]:
        boxes = tmp_path / "boxes.json"
        boxes.write_text(json.dumps({"img0.png": [10, 5, 90, 75], "img1.png": [-5, -5, 200, 200]}))
        extra = ["--bboxes", str(boxes)]
    out = tmp_path / "out"
    result = main(["--input", str(image_dir), "--output", str(out), "--format", fmt, "--batch", "2",
                   "--img-size", str(S), "--device", "cpu", "--allow-random-weights", "--dtype", "float32",
                   *extra])
    if fmt == "jsonl":
        lines = [json.loads(line) for line in open(result)]
        assert [os.path.basename(r["file"]) for r in lines] == ["img0.png", "img1.png", "img2.png"]
        for r in lines:
            assert np.asarray(r["points"]).shape == (68, 2) and len(r["3dmm_params"]) == 413
            assert np.isfinite(r["3dmm_params"]).all()
    elif fmt == "obj":
        text = (out / "img0.obj").read_text().splitlines()
        assert sum(line.startswith("v ") for line in text) == 5023
        assert sum(line.startswith("f ") for line in text) == 9976
    else:
        params = json.loads((out / "img2.json").read_text())
        assert len(params["shape"]) == 300 and len(params["rotation"]) == 6


def test_predict_cli_refuses_missing_weights(image_dir, tmp_path):
    from dad3dheads_tpu_torch.cli.predict import main

    with pytest.raises(FileNotFoundError):
        main(["--input", str(image_dir), "--output", str(tmp_path), "--device", "cpu",
              "--checkpoint", str(tmp_path / "none.msgpack")])
    with pytest.raises(FileNotFoundError, match="amax"):
        main(["--input", str(image_dir), "--output", str(tmp_path), "--device", "cpu",
              "--allow-random-weights", "--quant-amax", str(tmp_path / "no_amax.npz")])


# --------------------------------------------------------------------------
# the kernel on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("hmax,wmax", [(96, 120), (640, 96), (1088, 1920)])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_resample_kernel_matches_plain(cuda, hmax, wmax, layout):
    """Both modes, fp32 (atol 1e-4) and bf16 (atol 3e-2); scales and
    paddings identical; one launch per call."""
    rng = np.random.default_rng(hmax)
    frames, sizes, bboxes = random_frames(rng, 6, hmax, wmax)
    bboxes[-1] = [-7, -9, 10_000, 10_000]  # a loose box
    x = torch.from_numpy(in_layout(frames, layout)).to(cuda)
    sz, bb = torch.from_numpy(sizes).to(cuda), torch.from_numpy(bboxes).to(cuda)
    for mode in MODES:
        scalars, _, _ = frame_scalars(sz, bb, 256, mode)
        ref = resample_normalize_reference(x, scalars, 256)
        for dtype, atol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
            before = resample_normalize.launches
            out, scales, pads = preprocess_frames_device(x, sz, bb, 256, mode=mode, layout=layout, out_dtype=dtype)
            assert resample_normalize.launches == before + 1
            assert out.dtype == dtype and out.shape == (6, 256, 256, 3)
            assert (out.float() - ref).abs().max().item() <= atol, (mode, dtype)
            cpu = frame_scalars(torch.from_numpy(sizes), torch.from_numpy(bboxes), 256, mode)
            assert torch.equal(scales.cpu(), cpu[1]) and torch.equal(pads.cpu(), cpu[2])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_resample_kernel_stress_cases(cuda, layout):
    """A whole 1920x1080 frame (f = 7.5) beside a 2-pixel crop (an upscale),
    then a ragged Wmax (333: rows 999 bytes apart, the byte path): fp32
    within 1e-4 (expected: equal), bf16 within 3e-2, the same bits on a
    second launch, one launch per call, nothing allocated beyond the output."""
    rng = np.random.default_rng(51)
    for shapes, boxes, bucket in ((((1080, 1920), (1080, 1920)), [[0, 0, 1920, 1080], [700, 400, 702, 402]], 64),
                                  (((300, 333), (250, 320)), [[0, 0, 333, 300], [17, 9, 19, 11]], 1)):
        frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in shapes]
        buf, sizes, packed = pack_frames_host(frames, boxes, 2, bucket=bucket, planar=layout == "planar")
        x = torch.from_numpy(buf).to(cuda)
        for mode in MODES:
            scalars = frame_scalars(torch.from_numpy(sizes), torch.from_numpy(packed), 256, mode)[0].to(cuda)
            ref = resample_normalize_reference(x, scalars, 256)
            # a collection inside the measured call would free earlier tests' cycles of card tensors
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # bytes asked of the caching allocator (its blocks may be larger)
            before, launches = torch.cuda.memory_stats()["requested_bytes.all.current"], resample_normalize.launches
            out = resample_normalize(x, scalars, 256)
            peak = torch.cuda.memory_stats()["requested_bytes.all.peak"]
            assert peak - before == out.numel() * out.element_size()
            assert resample_normalize.launches == launches + 1
            assert torch.equal(out, resample_normalize(x, scalars, 256))
            assert (out - ref).abs().max().item() <= 1e-4, (shapes, mode)
            out16 = resample_normalize(x, scalars, 256, out_dtype=torch.bfloat16)
            assert (out16.float() - ref).abs().max().item() <= 3e-2, (shapes, mode)


@pytest.mark.cuda
def test_resample_kernel_identity_crop_exact(cuda):
    rng = np.random.default_rng(50)
    frames = rng.integers(0, 256, (3, 256, 256, 3), dtype=np.uint8)
    sizes = torch.full((3, 2), 256, dtype=torch.int32)
    boxes = torch.tensor([[0, 0, 256, 256]] * 3, dtype=torch.int32)
    for layout in LAYOUTS:
        x = torch.from_numpy(in_layout(frames, layout))
        ref = preprocess_frames_device(x, sizes, boxes, 256, layout=layout)[0]
        out = preprocess_frames_device(x.to(cuda), sizes.to(cuda), boxes.to(cuda), 256, layout=layout)[0]
        assert (out.cpu() - ref).abs().max().item() <= 1e-6
