"""The SwinV2 DAD-3DNet (``models/swin.py``, backbone ``swinv2_b_w16``)
against the benchmark's plain reference (``portbench/reference/swinv2.py``).

On the CPU at a small spec that reaches all four window regimes of the
published one (128x128 images, embed 16, depths (2, 2, 2, 2), heads
(1, 2, 4, 8), window 8, a BiFPN of 32 filters: 16 shifted windows, 4
shifted windows, one unshifted window, a window clipped to 4), on seeded
weights with every LayerNorm away from the identity (the benchmark's served
weights): the fp32 outputs, the bf16 trunk, the parameter gradients,
``predict_batch`` and one train step; the state dict's names; the published
widths on the meta device; the spans and the attention roofline's bound;
the backbone's checkpoints, int8 and export refusals. On the card
(``cuda``): the graphed train step against eager steps. This file imports
no JAX.
"""

import functools

import numpy as np
import pytest
import torch

from dad3dheads_tpu_torch import tracing, weights
from dad3dheads_tpu_torch.constants import OUTPUT_2D_LANDMARKS, OUTPUT_3DMM_PARAMS, OUTPUT_LANDMARKS_HEATMAP
from dad3dheads_tpu_torch.models import ENCODER_CHANNELS, create_model, dad3dnet
from dad3dheads_tpu_torch.models.swin import SWINV2_B_W16, SwinSpec, SwinV2Stages
from portbench import seeded
from portbench.drivers.predict_batch_swin import weights as seeded_weights
from portbench.reference import network, precision, swinv2
from portbench.roofline_swin import attention_bound_s

NAME, IMG, FILTERS, B = "swinv2_test", 128, 32, 2
SMALL = SwinSpec(embed_dim=16, depths=(2, 2, 2, 2), heads=(1, 2, 4, 8), window=8)
SWIN = {"embed_dim": 16, "depths": [2, 2, 2, 2], "num_heads": [1, 2, 4, 8], "window_size": 8, "patch_size": 4,
        "mlp_ratio": 4}
CONFIG = {"model": {"backbone": NAME, "num_filters": FILTERS, "num_classes": 68}, "swin": SWIN}
OUTPUTS = ((OUTPUT_3DMM_PARAMS, "3dmm"), (OUTPUT_2D_LANDMARKS, "landmarks"), (OUTPUT_LANDMARKS_HEATMAP, "heatmap"))
# tolerances: worst row of the 3DMM against its reference row's norm, and the
# landmarks and heatmap against their largest reference value
FP32_TOL = 1e-4  # the port reads ~7e-7 (rounding order); the bf16 trunk ~1e-2
BF16_TOL = 5e-2  # the bf16 trunk reads ~1e-2; the fp8 control ~0.15


@pytest.fixture(scope="module", autouse=True)
def small_backbone():
    with pytest.MonkeyPatch.context() as m:
        m.setitem(dad3dnet.ENCODERS, NAME, functools.partial(SwinV2Stages, SMALL))
        yield


def _model(dtype="float32", seed=3):
    model = create_model({"backbone": NAME, "num_filters": FILTERS, "dtype": dtype}, torch.Generator().manual_seed(0))
    model.load_state_dict(seeded_weights(CONFIG, seed, "cpu"))
    return model


def _images(seed=3, batch=B):
    return network.normalize(seeded.images(seed, 1, batch, IMG, "cpu")[0])


def _gaps(out, ref) -> dict:
    mm = float(((out["3dmm"] - ref["3dmm"]).norm(dim=-1) / ref["3dmm"].norm(dim=-1)).max())
    return {"3dmm": mm, **{k: float((out[k] - ref[k]).abs().max() / ref[k].abs().max()) for k in ("landmarks", "heatmap")}}


@pytest.fixture(scope="module")
def outputs():
    P = seeded_weights(CONFIG, 3, "cpu")
    x = _images()
    with torch.no_grad():
        port = {dtype: {r: v for (k, r), v in zip(OUTPUTS, (_model(dtype)(x)[k] for k, _ in OUTPUTS))}
                for dtype in ("float32", "bfloat16")}
        ref = swinv2.forward(P, x, SWIN)
        control = swinv2.forward(P, x, SWIN, quant=precision.fp8)
    return port, ref, control


def test_fp32_matches_the_reference_where_bf16_does_not(outputs):
    port, ref, _ = outputs
    fp32, bf16 = _gaps(port["float32"], ref), _gaps(port["bfloat16"], ref)
    assert max(fp32.values()) < FP32_TOL, fp32
    assert bf16["3dmm"] > FP32_TOL, bf16


def test_bf16_trunk_matches_the_reference_where_fp8_does_not(outputs):
    port, ref, control = outputs
    bf16, fp8 = _gaps(port["bfloat16"], ref), _gaps(control, ref)
    assert max(bf16.values()) < BF16_TOL, bf16
    assert fp8["3dmm"] > BF16_TOL, fp8


def test_gradients_match_autograd_through_the_reference():
    """fp32, eval mode: every parameter's gradient of a fixed weighted sum of
    the outputs (logit scales, the position-bias MLP, q and v biases
    included) within 1e-3 of the largest reference entry of that leaf."""
    model = _model()
    params = {n for n, _ in model.named_parameters()}
    P = {k: v.clone().requires_grad_(k in params) for k, v in seeded_weights(CONFIG, 3, "cpu").items()}
    x = _images()
    g = torch.Generator().manual_seed(7)
    out = model(x)
    w = {r: torch.randn(out[k].shape, generator=g) for k, r in OUTPUTS}
    sum((out[k] * w[r]).sum() for k, r in OUTPUTS).backward()
    ref = swinv2.forward(P, x, SWIN)
    sum((ref[r] * w[r]).sum() for _, r in OUTPUTS).backward()
    names = [n for n, _ in model.named_parameters()]
    for must in ("logit_scale", "cpb_mlp.0.weight", "cpb_mlp.2.weight", "q_bias", "v_bias", "patch_embed.proj.weight"):
        assert any(must in n for n in names), must
    for name, p in model.named_parameters():
        r = P[name].grad
        if r is None:  # the BiFPN's last p6 and p7 nodes feed no output
            assert name.startswith("bifpn.") and (p.grad is None or not p.grad.any()), name
            continue
        assert float(r.abs().max()) > 0 or not name.startswith("encoder."), name
        torch.testing.assert_close(p.grad, r, rtol=0, atol=1e-3 * float(r.abs().max()), msg=name)


def test_layout_is_the_ports_state_dict():
    sd = create_model({"backbone": NAME, "num_filters": FILTERS}, torch.Generator().manual_seed(0)).state_dict()
    lay = swinv2.layout(SWIN, FILTERS)
    assert {n for n, _, _ in lay} == set(sd)
    assert all(tuple(sd[n].shape) == tuple(s) for n, s, _ in lay)


def test_published_widths_on_the_meta_device():
    with torch.device("meta"):
        encoder = SwinV2Stages()
        model = dad3dnet.DAD3DNet(backbone="swinv2_b_w16")
    assert encoder.spec == SWINV2_B_W16
    assert sum(p.numel() for p in encoder.parameters()) == 86_893_816
    assert encoder.encoder_channels == ENCODER_CHANNELS["swinv2_b_w16"]
    published = {"embed_dim": 128, "depths": [2, 2, 18, 2], "num_heads": [4, 8, 16, 32], "window_size": 16,
                 "patch_size": 4, "mlp_ratio": 4}
    sd = model.state_dict()
    lay = swinv2.layout(published)
    assert {n for n, _, _ in lay} == set(sd)
    assert all(tuple(sd[n].shape) == tuple(s) for n, s, _ in lay)


def test_init_is_swinv2s():
    """Linear weights N(0, 0.02) truncated at 2 deviations, LayerNorms the
    identity but the zeroed res-post-norms, logit scales log 10, q and v
    biases zero; the neck keeps the JAX package's scheme."""
    model = create_model({"backbone": NAME, "num_filters": FILTERS}, torch.Generator().manual_seed(0))
    sd = model.state_dict()
    qkv = sd["encoder.model.layers.0.blocks.0.attn.qkv.weight"]
    assert float(qkv.abs().max()) <= 0.04 and 0.01 < float(qkv.std()) < 0.02
    assert torch.equal(sd["encoder.model.layers.1.blocks.1.norm1.weight"], torch.zeros(32))
    assert torch.equal(sd["encoder.model.layers.1.blocks.1.norm2.bias"], torch.zeros(32))
    assert torch.equal(sd["encoder.model.layers.1.downsample.norm.weight"], torch.ones(64))
    assert torch.allclose(sd["encoder.model.layers.3.blocks.0.attn.logit_scale"], torch.full((8, 1, 1), np.log(10.0)))
    assert torch.equal(sd["encoder.model.layers.2.blocks.0.attn.q_bias"], torch.zeros(64))
    p3 = sd["bifpn.p3.weight"]  # lecun_normal on the first tap's 16 channels
    assert float(p3.abs().max()) <= 2 * (1 / 16) ** 0.5 / 0.87962566103423978 + 1e-6


def test_a_grid_the_window_does_not_divide_raises():
    encoder = SwinV2Stages(SMALL)
    with pytest.raises(ValueError, match="whole number of 8x8 windows"):
        encoder(torch.zeros(1, 3, 96, 96))


def test_predict_batch_serves_it():
    from dad3dheads_tpu_torch.api import FaceMeshPredictor

    pred = FaceMeshPredictor({"img_size": IMG, "model": {"backbone": NAME, "num_filters": FILTERS, "dtype": "float32"}},
                             device="cpu")
    P = seeded_weights(CONFIG, 4, "cpu")
    pred.model.load_state_dict(P)
    images = seeded.images(4, 1, 3, IMG, "cpu")[0]
    out = pred.predict_batch(images.numpy())
    with torch.no_grad():
        ref = swinv2.forward(P, network.normalize(images), SWIN)
    np.testing.assert_allclose(out["3dmm_params"], ref["3dmm"].numpy(), rtol=0,
                               atol=FP32_TOL * float(ref["3dmm"].abs().max()))
    assert out["3d_vertices"].shape == (3, 5023, 3) and np.isfinite(out["projected_vertices"]).all()


def test_one_train_step():
    from dad3dheads_tpu_torch.core import FlameModel, LandmarkEmbedding
    from dad3dheads_tpu_torch.data.synthetic import synthetic_batch
    from dad3dheads_tpu_torch.train import build_train_step, init_train_state

    flame, emb = FlameModel.load(), LandmarkEmbedding.load()
    state = init_train_state({"backbone": NAME, "num_filters": FILTERS}, {"name": "adam", "lr": 1e-3},
                             torch.Generator().manual_seed(0), "cpu", 5.0)
    # served weights: at SwinV2's init the zeroed res-post-norms give the attention no gradient
    state.model.load_state_dict(seeded_weights(CONFIG, 3, "cpu"))
    before = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    batch = synthetic_batch(torch.Generator().manual_seed(1), flame, emb, B, IMG)
    logs = build_train_step(img_size=IMG)(state, flame, batch)
    assert np.isfinite(float(logs["loss"])) and float(logs["grad_norm"]) > 0
    moved = [k for k, v in state.model.named_parameters() if not torch.equal(v, before[k])]
    assert any("attn.cpb_mlp" in k for k in moved) and any("attn.logit_scale" in k for k in moved)
    assert len(moved) > 0.9 * len(before)


def test_spans_on_under_a_profiler_and_off_without():
    model = _model()
    x = _images()
    tracing.clear()
    with torch.no_grad():
        model(x)
    assert not [r for r in tracing.records() if r.name.startswith("dad3d.swin.")]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]), torch.no_grad():
        model(x)
    stages = [r.counts for r in tracing.records() if r.name == "dad3d.swin.stage"]
    attention = [r.counts for r in tracing.records() if r.name == "dad3d.swin.attention"]
    grids, channels = (32, 16, 8, 4), (16, 32, 64, 128)
    assert stages == [{"stage": s + 1, "blocks": 2, "tokens": B * g * g, "channels": c}
                      for s, (g, c) in enumerate(zip(grids, channels))]
    expected = []
    for (g, c, h) in zip(grids, channels, SMALL.heads):
        w = min(g, 8)
        for j in range(2):
            shift = 4 if g > 8 and j % 2 else 0
            expected.append({"tokens": B * g * g, "window_tokens": w * w, "channels": c, "heads": h,
                             "windows": (g // w) ** 2, "shift": shift, "itemsize": 4})
    assert attention == expected


def test_attention_bound_is_the_hand_count():
    """Stage 1 of the published cell, a shifted block: B = 256, a 64x64 grid,
    16 windows of 256 tokens, 128 channels, 4 heads, bf16."""
    tokens, n, c = 256 * 64 * 64, 256, 128
    flops = 4 * tokens * n * c  # q k^T and p v, 2 a multiply-add
    moved = 2 * (4 * tokens * c + (4 + 16) * n * n)  # q, k, v, out; the bias and the mask
    assert flops == 137_438_953_472 and moved == 1_076_363_264
    expect = max(moved / 3.35e12, flops / 989e12)
    assert attention_bound_s(tokens, n, c, 4, 16, 8, 2) == pytest.approx(expect, rel=1e-12)
    assert attention_bound_s(tokens, n, c, 4, 16, 0, 2) == pytest.approx(2 * (4 * tokens * c + 4 * n * n) / 3.35e12)


def test_checkpoints_tell_the_backbone(tmp_path):
    """The state dict and the flax tree name the backbone; a Swin state dict
    goes through the msgpack names and back; a resnet50 checkpoint is refused
    by a Swin model, and a Swin one by a resnet50 model."""
    model = dad3dnet.DAD3DNet(backbone="swinv2_b_w16")
    sd = model.state_dict()
    assert weights.state_dict_backbone(sd) == "swinv2_b_w16"
    variables = weights.flax_from_state_dict(sd)
    assert weights.flax_backbone(variables) == "swinv2_b_w16"
    back = weights.state_dict_from_flax(variables)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    resnet = weights.save_flax_msgpack(
        weights.flax_from_state_dict(dad3dnet.DAD3DNet(backbone="resnet50").state_dict()), str(tmp_path / "r.msgpack"))
    with pytest.raises(ValueError, match="holds a resnet50 DAD-3DNet, but the model is swinv2_b_w16"):
        weights.load_checkpoint(model, resnet)
    swin = weights.save_flax_msgpack(variables, str(tmp_path / "s.msgpack"))
    with torch.device("meta"):
        resnet_model = dad3dnet.DAD3DNet(backbone="resnet50")
    with pytest.raises(ValueError, match="holds a swinv2_b_w16 DAD-3DNet, but the model is resnet50"):
        weights.load_checkpoint(resnet_model, swin)


def test_int8_and_export_refuse_it(tmp_path):
    from dad3dheads_tpu_torch.cli import export as export_cli
    from dad3dheads_tpu_torch.cli import train as train_cli
    from dad3dheads_tpu_torch.models.quantized import check_backbone

    with pytest.raises(ValueError, match="resnet50 flagship only; got backbone='swinv2_b_w16'"):
        check_backbone("swinv2_b_w16")
    with pytest.raises(ValueError, match="export is not built for 'swinv2_b_w16'"):
        export_cli.main(["--checkpoint", str(tmp_path / "none.msgpack"), "--out", str(tmp_path / "a.aot.zip"),
                         "--backbone", "swinv2_b_w16", "--device", "cpu"])
    with pytest.raises(ValueError, match="export is not built for 'swinv2_b_w16'"):
        train_cli.main(["--synthetic", "1", "--device", "cpu", "model.backbone=swinv2_b_w16", "export_aot=true",
                        f"experiment_dir={tmp_path / 'exp'}"])
    assert not (tmp_path / "exp").exists()
    export_cli.check_exportable("mobilenet_w1")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_card_replay_matches_eager_steps():
    """Three seeded steps that warm, capture and replay a CUDA graph against
    three eager steps from the same state (B = 8 at 128x128, bf16 trunk,
    uint8 images), held to the CNN families' tolerances
    (``test_torch_train_graph.py``): losses 1e-4 relative, grad_norm 1e-2,
    the parameters' L2 gap under 25% of the update's norm. The position
    tables are made by the first (warm) step, outside the capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dad3dheads_tpu_torch.constants import INPUT_IMAGE_KEY, TARGET_LANDMARKS_HEATMAP
    from dad3dheads_tpu_torch.core import FlameModel, LandmarkEmbedding
    from dad3dheads_tpu_torch.data.synthetic import synthetic_batch
    from dad3dheads_tpu_torch.train import build_train_step, init_train_state

    flame, emb = FlameModel.load(device="cuda"), LandmarkEmbedding.load(device="cuda")
    batches = []
    for i in range(3):
        b = synthetic_batch(torch.Generator(device="cuda").manual_seed(i), flame, emb, 8, IMG)
        b.pop(TARGET_LANDMARKS_HEATMAP)
        b[INPUT_IMAGE_KEY] = ((b[INPUT_IMAGE_KEY].clamp(-2, 2) + 2) * 63.75).to(torch.uint8)
        batches.append(b)

    def run(graphed):
        state = init_train_state({"backbone": NAME, "num_filters": FILTERS, "dtype": "bfloat16"},
                                 {"name": "adam", "lr": 1e-4}, torch.Generator().manual_seed(0), "cuda", 5.0)
        one = build_train_step(img_size=IMG)
        logs = []
        for s, batch in zip((11, 12, 13), batches):
            torch.manual_seed(s)
            step = one if graphed else build_train_step(img_size=IMG)
            logs.append({k: float(v) for k, v in step(state, flame, batch).items()})
        torch.cuda.synchronize()
        if graphed:
            assert len(one.graphs.captured) == 1
        return logs, {k: v.detach() for k, v in state.model.named_parameters()}

    p0 = {k: v.detach() for k, v in init_train_state({"backbone": NAME, "num_filters": FILTERS, "dtype": "bfloat16"},
                                                      {"name": "adam", "lr": 1e-4}, torch.Generator().manual_seed(0),
                                                      "cuda", 5.0).model.named_parameters()}
    eager, pe = run(False)
    graph, pg = run(True)
    for e, g in zip(eager, graph):
        for k, v in e.items():
            rel = 1e-2 if k == "grad_norm" else 1e-3 if k.startswith("metrics/") else 1e-4
            assert g[k] == pytest.approx(v, rel=rel, abs=1e-6), (k, g[k], v)
    update = sum(float((pe[k] - p0[k]).square().sum()) for k in p0) ** 0.5
    gap = sum(float((pg[k] - pe[k]).square().sum()) for k in p0) ** 0.5
    print(f"swin: update gap {gap / update:.3e} of the update's norm")
    assert update > 1e-4 and gap <= 0.25 * update
