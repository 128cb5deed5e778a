"""The port's mobilenet_w1 DAD-3DNet, its weight bridge and its predictor
against the JAX package on the CPU.

Weights are drawn with numpy in the shapes of the flax ``model.init`` tree
at 64x64, BN statistics and affine terms non-trivial (a mean/var mix-up
would show), and cross through
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

from dad3dheads_tpu.api import predictor as jpred
from dad3dheads_tpu.constants import OUTPUT_2D_LANDMARKS, OUTPUT_3DMM_PARAMS, OUTPUT_LANDMARKS_HEATMAP
from dad3dheads_tpu.models import create_model as jax_create_model
from dad3dheads_tpu_torch import weights
from dad3dheads_tpu_torch.api import predictor as tpred
from dad3dheads_tpu_torch.models import ENCODER_CHANNELS, MobileNetStages, create_model


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tests run beside other test processes: two torch threads each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
IMG = 64
MOBILENET = {"backbone": "mobilenet_w1"}
KEYS = (OUTPUT_LANDMARKS_HEATMAP, OUTPUT_3DMM_PARAMS, OUTPUT_2D_LANDMARKS)


def _tools():
    sys.path.insert(0, TOOLS)
    try:
        import port_torch_weights
        import torch_dad3dnet
    finally:
        sys.path.remove(TOOLS)
    return port_torch_weights, torch_dad3dnet


@pytest.fixture(scope="module")
def variables():
    return _seeded_variables(0)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(1).normal(size=(2, IMG, IMG, 3)).astype(np.float32)


def _outputs(variables, images, dtype):
    jmodel = jax_create_model({**MOBILENET, "dtype": dtype})
    jout = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, jnp.asarray(images))
    tmodel = create_model({**MOBILENET, "dtype": dtype})
    tmodel.load_state_dict(weights.state_dict_from_flax(variables))
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(images))
    return {k: np.asarray(jout[k], np.float32) for k in KEYS}, {k: tout[k].numpy() for k in KEYS}


@pytest.fixture(scope="module")
def fp32_outputs(variables, images):
    return _outputs(variables, images, "float32")


def test_create_model_builds_the_published_widths():
    """create_model({"backbone": "mobilenet_w1"}) at the JAX package's
    widths: stem 32, stages 64/128/256/512/1024 of 1/2/2/6/2 units, BiFPN
    on (128, 256, 512), fusion and heads on 512 and 1024; another backbone
    name raises KeyError."""
    model = create_model(MOBILENET)
    assert model.backbone == "mobilenet_w1" and isinstance(model.encoder, MobileNetStages)
    ch = ENCODER_CHANNELS["mobilenet_w1"]
    assert model.encoder.encoder_channels == ch
    assert model.bifpn.sizes == (ch["layer3"], ch["layer2"], ch["layer1"]) == (128, 256, 512)
    assert model.fusion_layer.conv1x1.out_channels == 512 and model.shape.logit_image[0].in_features == 1024
    units = [len(model.encoder.model[f"stage{s}"]) for s in range(1, 6)]
    assert units == [1, 2, 2, 6, 2]
    x = torch.zeros(2, 3, IMG, IMG).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        outs = model.encoder(x)
    assert [tuple(o.shape[1:]) for o in outs] == [(64, 32, 32), (128, 16, 16), (256, 8, 8), (512, 4, 4),
                                                 (1024, 2, 2)]
    assert all(o.is_contiguous(memory_format=torch.channels_last) for o in outs)
    with pytest.raises(KeyError):
        create_model({"backbone": "other"})


def test_depthwise_init_draws_flax_fan_in():
    """lecun_normal with fan_in = weight[0].numel() = 9 for a depthwise 3x3
    kernel, flax's fan-in of a (3, 3, 1, C) kernel: the port's init and
    flax's default conv init have the same spread (within 5%) on the widest
    depthwise convs."""
    import flax.linen as nn

    model = create_model(MOBILENET, torch.Generator().manual_seed(0))
    for s, c in ((4, 512), (5, 1024)):
        port = model.encoder.model[f"stage{s}"].unit2.dw_conv.conv.weight.detach()
        flax = np.asarray(nn.initializers.lecun_normal()(jax.random.PRNGKey(s), (3, 3, 1, c)))
        assert port.shape == (c, 1, 3, 3)
        assert float(port.std()) == pytest.approx(float(flax.std()), rel=0.05), s


@pytest.mark.parametrize("backbone", ["resnet50", "mobilenet_w1"])
def test_name_map_equals_the_tools_map(backbone):
    tool, _ = _tools()
    assert weights.name_map(backbone) == tool.dad3dnet_name_map(backbone)


@pytest.mark.parametrize("dialect", ["pytorchcv", "torchvision"])
def test_backbone_name_map_equals_the_tools_map(dialect):
    tool, _ = _tools()
    assert weights.backbone_name_map(dialect) == tool.backbone_name_map(dialect)


def test_bridge_covers_every_leaf(variables):
    flat = weights._flatten(variables)
    assert set(flat) == set(weights.name_map("mobilenet_w1"))
    assert weights.flax_backbone(variables) == "mobilenet_w1"
    sd = weights.state_dict_from_flax(variables)
    assert set(sd) == set(create_model(MOBILENET).state_dict())
    assert weights.state_dict_backbone(sd) == "mobilenet_w1"


def test_bridge_is_total(variables):
    """A missing leaf fails the bridge; it never leaves a random weight."""
    trimmed = jax.tree_util.tree_map(lambda x: x, variables)
    del trimmed["params"]["encoder"]["s4_3"]["Conv_1"]
    with pytest.raises(KeyError):
        weights.state_dict_from_flax(trimmed)


def test_flax_torch_flax_is_identity(variables):
    back = weights._flatten(weights.flax_from_state_dict(weights.state_dict_from_flax(variables)))
    flat = weights._flatten(variables)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


def test_torch_flax_torch_is_identity():
    sd = create_model(MOBILENET, torch.Generator().manual_seed(3)).state_dict()
    back = weights.state_dict_from_flax(weights.flax_from_state_dict(sd))
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


@pytest.mark.parametrize("key", KEYS)
def test_fp32_forward_matches_flax(fp32_outputs, key):
    """rtol 1e-4 / atol 1e-4: fp32 convolutions summed in another order."""
    jout, tout = fp32_outputs
    assert tout[key].shape == jout[key].shape
    np.testing.assert_allclose(tout[key], jout[key], rtol=1e-4, atol=1e-4)


def test_bf16_forward_matches_flax(variables, images, fp32_outputs):
    """bf16 trunk against flax's bf16 trunk, as the resnet50 test holds it:
    heatmap and 2D landmarks atol 3e-2; the 3DMM (tanh(x)*3 amplifies
    one-ulp rounding differences of the trunk) within 1.5x flax's own
    bf16-against-fp32 gap on these weights; and the port's bf16 really is
    bf16 (off its own fp32 output)."""
    jb, tb = _outputs(variables, images, "bfloat16")
    jf, tf = fp32_outputs
    for key in (OUTPUT_LANDMARKS_HEATMAP, OUTPUT_2D_LANDMARKS):
        np.testing.assert_allclose(tb[key], jb[key], atol=3e-2)
    band = np.abs(jb[OUTPUT_3DMM_PARAMS] - jf[OUTPUT_3DMM_PARAMS]).max()
    gap = np.abs(tb[OUTPUT_3DMM_PARAMS] - jb[OUTPUT_3DMM_PARAMS]).max()
    print(f"bf16 3DMM: port against flax {gap:.3g}, flax bf16 against fp32 {band:.3g}")
    assert gap <= 1.5 * band, (gap, band)
    assert np.abs(tb[OUTPUT_LANDMARKS_HEATMAP] - tf[OUTPUT_LANDMARKS_HEATMAP]).max() > 1e-3


def _mirror(backbone, seed):
    _, mirror_module = _tools()
    torch.manual_seed(seed)
    mirror = mirror_module.TorchDAD3DNet(backbone=backbone).eval()
    mirror_module.randomize_bn_stats(mirror, seed=seed + 1)
    return mirror


def test_reference_state_dict_loads_as_is():
    """The reference mirror's mobilenet state dict (pytorchcv keys) loads
    strictly, and both torch modules compute the same function at 1e-4."""
    mirror = _mirror("mobilenet_w1", 5)
    port = create_model(MOBILENET)
    port.load_state_dict(mirror.state_dict(), strict=True)
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(2, IMG, IMG, 3)).astype(np.float32))
    with torch.no_grad():
        ref = mirror(x.permute(0, 3, 1, 2).contiguous())
        out = port(x)
    torch.testing.assert_close(out[OUTPUT_LANDMARKS_HEATMAP], ref["heatmap"].permute(0, 2, 3, 1), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out[OUTPUT_3DMM_PARAMS], ref["params_3dmm"], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out[OUTPUT_2D_LANDMARKS], ref["landmarks"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("backbone", ["resnet50", "mobilenet_w1"])
def test_reference_checkpoint_in_the_ports_keys(backbone):
    """A Lightning checkpoint's state dict (``model.`` prefix) -> the port's
    state dict, which loads strictly into that backbone's model; an
    unknown tensor raises."""
    mirror = _mirror(backbone, 9)
    lightning = {f"model.{k}": v for k, v in mirror.state_dict().items()}
    sd = weights.state_dict_from_reference(lightning)
    model = create_model({"backbone": backbone})
    model.load_state_dict(sd, strict=True)
    for k, v in mirror.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(model.state_dict()[k], v), k
    with pytest.raises(KeyError):
        weights.state_dict_from_reference({**lightning, "model.extra.weight": torch.zeros(1)})


def _resnet50_flax_zeros():
    model = jax_create_model({})
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)


@pytest.mark.parametrize("dialect", ["pytorchcv", "torchvision"])
def test_backbone_only_matches_the_tool(dialect):
    """An ImageNet resnet50 backbone in either naming gives the port the
    encoder weights that the tool's ``port_by_name_map`` gives flax, carried
    through ``state_dict_from_flax``; the classifier is dropped."""
    tool, mirror_module = _tools()
    torch.manual_seed(11)
    features = mirror_module.resnet50_features()
    mirror_module.randomize_bn_stats(features, seed=12)
    cv = {f"features.{k}": v.numpy() for k, v in features.state_dict().items()}
    if dialect == "pytorchcv":
        source = {**cv, "output.weight": np.zeros((1000, 2048), np.float32)}
    else:
        rename = {tool.backbone_name_map("pytorchcv")[p][0]: key for p, (key, _) in
                  tool.backbone_name_map("torchvision").items()}
        source = {rename[k]: v for k, v in cv.items() if k in rename}
        source["fc.weight"] = np.zeros((1000, 2048), np.float32)
    ported, report = tool.port_by_name_map({k: v for k, v in source.items() if not k.startswith(("output.", "fc."))},
                                           _resnet50_flax_zeros(), tool.backbone_name_map(dialect))
    assert report == []
    want = {k: v for k, v in weights.state_dict_from_flax(ported).items()
            if k.startswith("encoder.") and not k.endswith("num_batches_tracked")}
    got = weights.state_dict_from_backbone(source, dialect)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    model = create_model({})
    missing, unexpected = model.load_state_dict(got, strict=False)
    assert not unexpected and all(not k.startswith("encoder.") or k.endswith("num_batches_tracked") for k in missing)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory, variables):
    """A mobilenet and a resnet50 predictor checkpoint (the port's writer)."""
    d = tmp_path_factory.mktemp("ck")
    mobile = weights.save_flax_msgpack(variables, str(d / "mobilenet.msgpack"))
    resnet = weights.save_flax_msgpack(weights.flax_from_state_dict(create_model({}).state_dict()),
                                       str(d / "resnet50.msgpack"))
    return mobile, resnet


def test_wrong_backbone_checkpoint_raises(checkpoints, variables):
    """Either way round, the error names both backbones; the predictor
    refuses before the map is reached."""
    mobile, resnet = checkpoints
    for path, model, found, expected in ((mobile, create_model({}), "mobilenet_w1", "resnet50"),
                                         (resnet, create_model(MOBILENET), "resnet50", "mobilenet_w1")):
        with pytest.raises(ValueError, match=f"{found}.*{expected}"):
            weights.load_checkpoint(model, path)
    with pytest.raises(ValueError, match="resnet50.*mobilenet_w1"):
        tpred.FaceMeshPredictor({"img_size": IMG, "model": MOBILENET}, checkpoint_path=resnet, device="cpu")
    model = create_model(MOBILENET)
    weights.load_checkpoint(model, mobile)
    want = np.asarray(variables["batch_stats"]["encoder"]["init_bn"]["mean"])
    np.testing.assert_array_equal(model.encoder.model.init_block.bn.running_mean.numpy(), want)


def _seeded_variables(seed: int):
    """Random flax variables of the mobilenet tree, drawn with numpy as
    ``test_torch_predictor.seeded_variables`` draws the resnet50's: kernels at
    half the lecun-normal variance, BN statistics and affine terms
    non-trivial."""
    model = jax_create_model(MOBILENET)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))
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


def test_predict_batch_matches_jax(tmp_path):
    """The mobilenet predictor on one checkpoint, the port against the JAX
    package: 3DMM and 3D vertices atol 1e-4; 2D points and projected
    vertices atol 1e-2 px (fp32 network, sums in another order)."""
    path = str(tmp_path / "dad_3dnet.msgpack")
    jpred.save_predictor_checkpoint(_seeded_variables(2), path)
    config = {"img_size": IMG, "model": MOBILENET}
    jp = jpred.FaceMeshPredictor(config=config, checkpoint_path=path)
    tp = tpred.FaceMeshPredictor(config=config, checkpoint_path=path, device="cpu")
    assert tp.model.backbone == "mobilenet_w1" and tp.loaded_checkpoint == path
    images = np.random.default_rng(3).integers(0, 256, size=(3, IMG, IMG, 3), dtype=np.uint8)
    ref, out = jp.predict_batch(images), tp.predict_batch(images)
    assert set(out) == set(ref)
    for key in ref:
        assert out[key].shape == ref[key].shape and out[key].dtype == ref[key].dtype, key
    for key, atol in (("3dmm_params", 1e-4), ("3d_vertices", 1e-4), ("points", 1e-2), ("projected_vertices", 1e-2)):
        np.testing.assert_allclose(out[key], ref[key], atol=atol, err_msg=key)
