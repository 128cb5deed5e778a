"""The whole slice: the port's FaceMeshPredictor against the JAX predictor on
one ``.msgpack`` checkpoint and the same images, and the port's freedom from
JAX."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dad3dheads_tpu.api import predictor as jpred
from dad3dheads_tpu.models import create_model as jax_create_model
from dad3dheads_tpu_torch.api import predictor as tpred
from dad3dheads_tpu_torch.ops.preprocess import normalize_images_reference


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tests run beside other test processes: two torch threads each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 64


def seeded_variables(seed: int):
    """Random flax variables of the model's tree shapes, drawn with numpy:
    kernels at half the lecun-normal variance (which keeps this random
    trunk's 3DMM out of tanh saturation), BN statistics and affine terms
    non-trivial. The shapes come from tracing ``model.init`` without
    compiling it."""
    model = jax_create_model({})
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False)
    )
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        if name.endswith("['kernel']"):
            value = rng.normal(size=shape) * np.sqrt(0.5 / np.prod(shape[:-1]))
        elif name.endswith(("['var']", "['scale']", "['w1']", "['w2']")):
            value = rng.uniform(0.75, 1.25, size=shape)
        elif name.endswith("['depthwise_scale']"):
            value = rng.normal(size=shape)
        else:  # biases and BN means
            value = rng.normal(size=shape) * 0.1
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def predictors(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ck") / "dad_3dnet.msgpack")
    jpred.save_predictor_checkpoint(seeded_variables(2), path)
    config = {"img_size": IMG}
    return (
        jpred.FaceMeshPredictor(config=config, checkpoint_path=path),
        tpred.FaceMeshPredictor(config=config, checkpoint_path=path, device="cpu"),
    )


def test_predict_batch_matches_jax(predictors):
    """3DMM and 3D vertices atol 1e-4; 2D points and projected vertices atol
    1e-2 px (fp32 network, sums in another order)."""
    jp, tp = predictors
    images = np.random.default_rng(3).integers(0, 256, size=(3, IMG, IMG, 3), dtype=np.uint8)
    ref, out = jp.predict_batch(images), tp.predict_batch(images)
    assert set(out) == set(ref)
    for key in ref:
        assert out[key].shape == ref[key].shape and out[key].dtype == ref[key].dtype, key
    for key, atol in (("3dmm_params", 1e-4), ("3d_vertices", 1e-4), ("points", 1e-2), ("projected_vertices", 1e-2)):
        np.testing.assert_allclose(out[key], ref[key], atol=atol, err_msg=key)


@pytest.fixture(scope="module")
def bf16_predictor():
    config = {"img_size": IMG, "model": {"backbone": "resnet50", "dtype": "bfloat16"}}
    return tpred.FaceMeshPredictor(config, device="cpu", seed=3)


def trunk_input_dtypes(model):
    """The dtypes of the inputs the model is called with, as a list that
    fills while the returned hook is registered."""
    seen = []
    return seen, model.register_forward_pre_hook(lambda module, args: seen.append(args[0].dtype))


def test_predict_batch_feeds_the_trunk_its_dtype(predictors, bf16_predictor):
    """A uint8 batch is normalized straight into the trunk's dtype: the bf16
    trunk reads bf16, which autocast passes on uncast, and predict_batch is
    bit-identical to the route through the fp32 normalize and autocast's
    cast, model(normalize_images_reference(x).float()). The fp32 trunk reads
    fp32."""
    images = np.random.default_rng(6).integers(0, 256, size=(2, IMG, IMG, 3), dtype=np.uint8)
    for pred, dtype in ((predictors[1], torch.float32), (bf16_predictor, torch.bfloat16)):
        seen, hook = trunk_input_dtypes(pred.model)
        out = pred.predict_batch(images)
        hook.remove()
        assert seen == [dtype]
    with torch.inference_mode():
        x = normalize_images_reference(torch.from_numpy(images)).float()
        dev = tpred.decode_pipeline_outputs(bf16_predictor.model(x), 4, IMG)
        local = bf16_predictor._replica(bf16_predictor.device)
        vertices, projected = bf16_predictor._decode_3dmm(dev["3dmm"], local)
    ref = {"points": dev["landmarks"], "3dmm_params": dev["3dmm"], "3d_vertices": vertices,
           "projected_vertices": projected}
    for key, value in ref.items():
        np.testing.assert_array_equal(out[key], value.numpy(), err_msg=key)


def test_call_matches_jax(predictors):
    """One image of another size through resize, pad and readjustment. The
    readjusted points are truncated to ints, so they may differ by one."""
    jp, tp = predictors
    image = np.random.default_rng(4).integers(0, 256, size=(50, 80, 3), dtype=np.uint8)
    ref, out = jp(image), tp(image)
    for key in ref:
        assert out[key].shape == ref[key].shape and out[key].dtype == ref[key].dtype, key
    np.testing.assert_allclose(out["3dmm_params"], ref["3dmm_params"], atol=1e-4)
    np.testing.assert_allclose(out["3d_vertices"], ref["3d_vertices"], atol=1e-4)
    np.testing.assert_allclose(out["projected_vertices"], ref["projected_vertices"], atol=1e-2)
    assert np.abs(out["points"] - ref["points"]).max() <= 1


def test_decode_heatmap_branch_matches_jax():
    """Without a landmark head, landmarks are the heatmap argmax x stride."""
    rng = np.random.default_rng(5)
    heat = rng.normal(size=(2, 16, 16, 68)).astype(np.float32)
    p3dmm = rng.normal(size=(2, 413)).astype(np.float32)
    key_h, key_p = jpred.OUTPUT_LANDMARKS_HEATMAP, jpred.OUTPUT_3DMM_PARAMS
    ref = jpred.decode_pipeline_outputs({key_h: jnp.asarray(heat), key_p: jnp.asarray(p3dmm)}, 4, IMG)
    out = tpred.decode_pipeline_outputs({key_h: torch.from_numpy(heat), key_p: torch.from_numpy(p3dmm)}, 4, IMG)
    np.testing.assert_array_equal(out["landmarks"].numpy().reshape(2, -1), np.asarray(ref["landmarks"]))
    np.testing.assert_array_equal(out["3dmm"].numpy(), np.asarray(ref["3dmm"]))


def test_port_runs_without_jax(tmp_path):
    """In a fresh interpreter with DAD3D_PLATFORM cleared, the port's batch
    path (both backbones; resnet50's over a two-row mesh), frames and render
    paths run on the CPU, its layer zoo, int8, training, parallel, dataset and
    benchmark modules import, a Trainer over a mesh is built, and neither
    the JAX package nor jax, flax or optax is ever imported (the training CLI runs so in
    tests/test_torch_train_cli.py, the acceptance CLI in
    tests/test_torch_acceptance.py)."""
    code = textwrap.dedent(
        """
        import sys
        import numpy as np
        from dad3dheads_tpu_torch.api import FaceMeshPredictor
        from dad3dheads_tpu_torch.render import PNCCEstimator, UVTextureCreator
        import dad3dheads_tpu_torch.cli.train
        import dad3dheads_tpu_torch.train
        import dad3dheads_tpu_torch.cli.acceptance, dad3dheads_tpu_torch.cli.benchmark
        import dad3dheads_tpu_torch.cli.make_dataset
        from dad3dheads_tpu_torch.benchmark_harness import DADEvaluator, generate_gt, generate_submission
        from dad3dheads_tpu_torch.data import DataLoader, FlameDataset, HeatmapCoder
        from dad3dheads_tpu_torch.render import RenderPipeline
        from dad3dheads_tpu_torch.models import MaskPredictionHead, MobileNetStages, pixel_shuffle
        import dad3dheads_tpu_torch.models.layers, dad3dheads_tpu_torch.models.mobilenet
        import dad3dheads_tpu_torch.models.quant, dad3dheads_tpu_torch.models.quantized
        import dad3dheads_tpu_torch.cli.calibrate_int8, dad3dheads_tpu_torch.cli.export, dad3dheads_tpu_torch.precision
        from dad3dheads_tpu_torch.parallel import make_mesh, shard_heads, set_sync_bn, device_prefetch
        from dad3dheads_tpu_torch.train.loop import Trainer
        Trainer({"experiment_dir": sys.argv[1]}, device="cpu", mesh=make_mesh(["cpu"]))
        m = FaceMeshPredictor({"img_size": 64, "model": {"backbone": "mobilenet_w1"}}, device="cpu", seed=1)
        assert m.predict_batch(np.zeros((1, 64, 64, 3), np.uint8))["3dmm_params"].shape == (1, 413)
        p = FaceMeshPredictor({"img_size": 64}, device="cpu", seed=1, mesh=make_mesh(["cpu", "cpu"]))
        out = p.predict_batch(np.zeros((2, 64, 64, 3), np.uint8))
        assert out["3d_vertices"].shape == (2, 5023, 3), out["3d_vertices"].shape
        assert np.isfinite(out["3d_vertices"]).all()
        frame = np.random.default_rng(0).integers(0, 256, (50, 70, 3), dtype=np.uint8)
        preds = p.predict_frames([frame], bboxes=[[5, 5, 60, 45]])
        assert preds[0]["3d_vertices"].shape == (5023, 3)
        assert PNCCEstimator(device="cpu")(frame, preds[0]).shape == frame.shape
        assert UVTextureCreator(resolution=32, device="cpu")(frame, preds[0]).shape == (32, 32, 3)
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("dad3dheads_tpu", "jax", "jaxlib", "flax", "optax"))
        assert not bad, bad
        print("NO_JAX_OK")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "DAD3D_PLATFORM"}
    proc = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path)], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0 and "NO_JAX_OK" in proc.stdout, proc.stderr[-3000:]


def test_port_constants_and_assets_equal_the_jax_packages():
    """The port carries its own copies of the constants and asset files."""
    import filecmp

    from dad3dheads_tpu import assets as jax_assets
    from dad3dheads_tpu import constants as jax_constants
    from dad3dheads_tpu_torch import assets, constants

    names = [n for n in vars(jax_constants) if n.isupper()]
    assert names and names == [n for n in vars(constants) if n.isupper()]
    for name in names:
        assert getattr(constants, name) == getattr(jax_constants, name), name
    for key in constants.FLAME_3DMM_ORDER:
        assert constants.flame_param_offset(key) == jax_constants.flame_param_offset(key)
    jax_dir, port_dir = jax_assets._ASSET_DIR, assets._ASSET_DIR
    files = sorted(os.listdir(jax_dir))
    assert len(files) == 4 and files == sorted(os.listdir(port_dir))
    for name in files:
        assert filecmp.cmp(os.path.join(jax_dir, name), os.path.join(port_dir, name), shallow=False), name
