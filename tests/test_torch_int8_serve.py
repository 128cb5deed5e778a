"""int8 serving through the port: ``FaceMeshPredictor`` with ``quant_amax``
against the JAX predictor on one ``.msgpack`` checkpoint and one amax file,
through ``predict_batch``, ``__call__``, ``predict_images`` and
``predict_frames``; ``cli.predict --quant-amax`` and ``cli.calibrate_int8``
on the CPU. The int8 artifact is in tests/test_torch_int8_export.py.

The two packages fold BatchNorm with different roundings (XLA computes
scale / sqrt(var + eps) as scale * rsqrt(var + eps)), which can put a weight
in the next int8 bin. The port's fold is held to the JAX package's bin by
bin, and the port's own int8 predictor to the JAX one at a bound set from
its reading; the entry points are then compared on the JAX predictor's own
prepared kernels (laid out as the port's GEMM operands), which isolates the
serving path: preprocessing, the int8 forward, the decode and the
readjustment."""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dad3dheads_tpu.api import predictor as jpred
from dad3dheads_tpu_torch.api import predictor as tpred
from dad3dheads_tpu_torch.models import create_model
from dad3dheads_tpu_torch.models import quantized as tqd
from dad3dheads_tpu_torch.models.quant import gemm_weight
from dad3dheads_tpu_torch.models.quantized import calibrate, load_amax, save_amax
from dad3dheads_tpu_torch.weights import load_checkpoint

from .test_torch_predictor import IMG, seeded_variables


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tests run beside other test processes: two torch threads each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A resnet50 checkpoint, the port's fp32 network on it, and the port's
    fp32 calibration."""
    d = tmp_path_factory.mktemp("int8")
    ck = jpred.save_predictor_checkpoint(seeded_variables(2), str(d / "dad_3dnet.msgpack"))
    model = create_model({"backbone": "resnet50"})
    load_checkpoint(model, ck)
    model.eval()
    images = np.random.default_rng(8).integers(0, 256, (6, IMG, IMG, 3), dtype=np.uint8)
    amax = calibrate(model, [tpred.normalize_images(torch.from_numpy(images))], dtype=torch.float32)
    return ck, save_amax(amax, str(d / "amax.npz")), model


def jax_kernels(jp) -> dict:
    """The JAX predictor's prepared kernels as the port's qparams."""
    return {k: (gemm_weight(torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(kq), (3, 2, 0, 1))))),
                torch.from_numpy(np.array(ws)), torch.from_numpy(np.array(b)))
            for k, (kq, ws, b) in jp.quant_qparams.items()}


@pytest.fixture(scope="module")
def predictors(files):
    ck, amax, _ = files
    config = {"img_size": IMG, "quant_amax": amax}
    jp = jpred.FaceMeshPredictor(config=config, checkpoint_path=ck)
    tp = tpred.FaceMeshPredictor(config=config, checkpoint_path=ck, device="cpu")
    assert set(tp.quant_qparams) == set(jp.quant_qparams) and len(tp.quant_qparams) == 76
    tp.quant_qparams = jax_kernels(jp)
    return jp, tp


@pytest.fixture(scope="module")
def own_fold(predictors):
    """The port's own prepared kernels, with the float kernel each was
    quantized from (in site order)."""
    floats = []
    real = tqd.quantize_weights_per_channel

    def recording(kernel):
        floats.append(kernel)
        return real(kernel)

    tqd.quantize_weights_per_channel = recording
    try:
        own = tqd.prepare_int8_params(predictors[1].model, dtype=torch.float32, img_size=IMG)
    finally:
        tqd.quantize_weights_per_channel = real
    assert len(floats) == len(own) == 76
    return own, dict(zip(own, floats))


def test_port_fold_matches_jax_fold(predictors, own_fold):
    """The port's ``prepare_int8_params`` against the JAX package's jitted
    one on the same checkpoint. XLA computes the fold's scale / sqrt(var +
    eps) as scale * rsqrt(var + eps), some ulps off the port's quotient, so
    the weight scales part by up to 4 ulps (11,295 of the 33,028 channels on
    these weights) and a weight whose value sits on a rounding tie may land
    in the next bin: 12 of the 29,462,016 int8 values do, by one, each
    within 7.7e-6 of a tie in the port's own arithmetic (bound 1e-4). The
    folded biases agree within 1e-6."""
    jq = jax_kernels(predictors[0])
    own, floats = own_fold
    assert set(own) == set(jq)
    moved = channels = 0
    for site, (w, ws, b) in own.items():
        rw, rws, rb = jq[site]
        d = w.int() - rw.int()
        assert d.abs().max() <= 1, site
        if d.any():
            kernel = floats[site]
            n, k = kernel.shape[0], kernel[0].numel()
            ratio = (kernel / ws[:, None, None, None]).permute(0, 2, 3, 1).reshape(n, k).double().abs()
            on_ties = (ratio - ratio.floor() - 0.5).abs()[d[:n, :k] != 0]
            assert on_ties.max() <= 1e-4, (site, on_ties.max())
            moved += int((d != 0).sum())
        ulps = (ws.view(torch.int32).long() - rws.view(torch.int32).long()).abs()
        assert ulps.max() <= 4, site
        channels += int((ulps > 0).sum())
        np.testing.assert_allclose(b.numpy(), rb.numpy(), rtol=0, atol=1e-6, err_msg=site)
    assert moved <= 50 and channels < sum(ws.numel() for _, ws, _ in own.values())


def test_port_own_fold_serves_near_jax(predictors, own_fold):
    """The port's int8 predictor on its own kernels against the JAX int8
    predictor: on these random weights a bin that moves, or a
    requantization tie broken the other way, cascades through the int8
    chain, so the bound is set from the reading (3DMM 8.3e-3, points 0.20 px on
    test_predict_batch_matches_jax's images)."""
    jp, tp = predictors
    images = np.random.default_rng(3).integers(0, 256, size=(3, IMG, IMG, 3), dtype=np.uint8)
    with own_kernels(tp, own_fold[0]):
        out = tp.predict_batch(images)
    ref = jp.predict_batch(images)
    np.testing.assert_allclose(out["3dmm_params"], ref["3dmm_params"], atol=2e-2)
    np.testing.assert_allclose(out["points"], ref["points"], atol=0.5)


@contextlib.contextmanager
def own_kernels(tp, qparams):
    """``tp`` serving on the port's own prepared kernels for a while."""
    prepared = tp.quant_qparams
    tp.quant_qparams = qparams
    try:
        yield tp
    finally:
        tp.quant_qparams = prepared


def assert_close(out, ref, with_mesh=True):
    """3DMM and vertices atol 1e-3, projected 0.1 px, points within 1 px
    (truncated to ints after the readjustment); a requantized value may sit
    on a tie that the two packages round apart."""
    out, ref = (out, ref) if isinstance(out, list) else ([out], [ref])
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert set(o) == set(r)
        for key in r:
            assert np.shape(o[key]) == np.shape(r[key]), key
        np.testing.assert_allclose(o["3dmm_params"], r["3dmm_params"], atol=1e-3)
        assert np.abs(np.asarray(o["points"], np.float64) - np.asarray(r["points"], np.float64)).max() <= 1
        if with_mesh:
            np.testing.assert_allclose(o["3d_vertices"], r["3d_vertices"], atol=1e-3)
            np.testing.assert_allclose(o["projected_vertices"], r["projected_vertices"], atol=0.1)


def test_predictor_loads_amax_as_dict_or_npz(files, predictors):
    """``quant_amax`` as a dict or an .npz path gives one table; the mirror
    serves in the model's dtype, on tensors on the predictor's device."""
    ck, amax, _ = files
    tp = predictors[1]
    by_dict = tpred.FaceMeshPredictor({"img_size": IMG, "quant_amax": {k: v.item() for k, v in load_amax(amax).items()}},
                                      checkpoint_path=ck, device="cpu")
    assert set(by_dict.quant_amax) == set(tp.quant_amax) and len(tp.quant_amax) == 168
    assert all(by_dict.quant_amax[k].item() == tp.quant_amax[k].item() for k in tp.quant_amax)
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in tp.quant_amax.values())


def test_predict_batch_matches_jax(predictors):
    jp, tp = predictors
    images = np.random.default_rng(3).integers(0, 256, size=(3, IMG, IMG, 3), dtype=np.uint8)
    out, ref = tp.predict_batch(images), jp.predict_batch(images)
    for key in ref:
        assert out[key].shape == ref[key].shape and out[key].dtype == ref[key].dtype, key
    np.testing.assert_allclose(out["3dmm_params"], ref["3dmm_params"], atol=1e-3)
    np.testing.assert_allclose(out["points"], ref["points"], atol=0.1)


def test_call_and_predict_images_match_jax(predictors):
    """``__call__`` on one image of another size; ``predict_images`` on host
    images in batches of two (a padded last batch) and on a tensor of
    network-size images."""
    jp, tp = predictors
    rng = np.random.default_rng(4)
    image = rng.integers(0, 256, size=(50, 80, 3), dtype=np.uint8)
    assert_close(tp(image), jp(image))
    images = [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8) for h, w in ((70, 50), (64, 64), (33, 90))]
    assert_close(tp.predict_images(images, batch_size=2), jp.predict_images(images, batch_size=2))
    sized = rng.integers(0, 256, (3, IMG, IMG, 3), dtype=np.uint8)
    assert_close(tp.predict_images(torch.from_numpy(sized), batch_size=2, with_mesh=False),
                 jp.predict_images(jnp.asarray(sized), batch_size=2, with_mesh=False), with_mesh=False)


def test_predict_frames_matches_jax(predictors):
    """Frames with whole-frame, interior and loose boxes, batches of two."""
    jp, tp = predictors
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in ((70, 90), (120, 64), (99, 99))]
    boxes = [[0, 0, 90, 70], [5, 20, 60, 100], [-10, -10, 120, 120]]
    assert_close(tp.predict_frames(frames, bboxes=boxes, batch_size=2),
                 jp.predict_frames(frames, bboxes=boxes, batch_size=2))


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    import cv2

    d = tmp_path_factory.mktemp("imgs")
    for i, (h, w) in enumerate(((80, 100), (96, 72), (64, 64))):
        cv2.imwrite(str(d / f"img{i}.png"), np.random.default_rng(40 + i).integers(0, 256, (h, w, 3), dtype=np.uint8))
    return d


def test_predict_cli_serves_int8(files, predictors, own_fold, image_dir, tmp_path):
    """``cli.predict --quant-amax`` writes what the int8 predictor gives."""
    from dad3dheads_tpu_torch.cli.predict import main
    from dad3dheads_tpu_torch.data.io import read_as_rgb

    ck, amax, _ = files
    result = main(["--input", str(image_dir), "--output", str(tmp_path / "out"), "--batch", "2", "--img-size",
                   str(IMG), "--device", "cpu", "--checkpoint", ck, "--dtype", "float32", "--quant-amax", amax])
    lines = [json.loads(line) for line in open(result)]
    assert len(lines) == 3
    with own_kernels(predictors[1], own_fold[0]) as pred:
        ref = pred.predict_images([read_as_rgb(r["file"]) for r in lines], batch_size=2, with_mesh=False)
    for r, o in zip(lines, ref):
        np.testing.assert_array_equal(np.asarray(r["points"]), o["points"])
        np.testing.assert_allclose(r["3dmm_params"], o["3dmm_params"][0], rtol=1e-6, atol=1e-7)


def test_calibrate_cli(files, image_dir, tmp_path):
    """``cli.calibrate_int8`` on an image directory gives ``calibrate`` on
    the same preprocessed images; on synthetic batches, a full table."""
    from dad3dheads_tpu_torch.cli.calibrate_int8 import main
    from dad3dheads_tpu_torch.data.io import read_as_rgb
    from dad3dheads_tpu_torch.ops.preprocess import preprocess_image_np

    ck, _, model = files
    out = main(["--checkpoint", ck, "--out", str(tmp_path / "a.npz"), "--images", str(image_dir), "--num", "3",
                "--batch", "2", "--img-size", str(IMG), "--dtype", "fp32", "--device", "cpu"])
    got = load_amax(out)
    paths = sorted(str(p) for p in image_dir.iterdir())
    x = np.stack([preprocess_image_np(read_as_rgb(p), IMG)[0] for p in paths])
    ref = calibrate(model, [x[:2], x[2:]], dtype=torch.float32)
    assert set(got) == set(ref) and len(got) == 168
    assert all(got[k].item() == ref[k].item() for k in ref)
    synthetic = load_amax(main(["--checkpoint", ck, "--out", str(tmp_path / "s"), "--num", "2", "--batch", "2",
                                "--img-size", str(IMG), "--dtype", "bf16", "--device", "cpu"]))
    assert set(synthetic) == set(ref) and all(np.isfinite(v.item()) and v.item() > 0 for v in synthetic.values())
    assert os.path.isfile(tmp_path / "s")
