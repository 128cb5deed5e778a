"""The benchmark's plain reference held to the port on the CPU at a small
size: both encoders' forward, the FLAME decode, and the first train steps."""

import numpy as np
import pytest
import torch
import yaml

from portbench import compare, seeded
from portbench.drivers.train_step import port_batch
from portbench.reference import flame as flame_ref
from portbench.reference import network
from portbench.reference import train as train_ref

BACKBONES = ("resnet50", "mobilenet_w1")


def model_config(backbone):
    return {"backbone": backbone, "num_filters": 256, "num_classes": 68}


@pytest.mark.parametrize("backbone", BACKBONES)
def test_layout_is_the_ports_state_dict(backbone):
    from dad3dheads_tpu_torch.models import create_model

    sd = create_model({"backbone": backbone}, torch.Generator().manual_seed(0)).state_dict()
    lay = network.layout(backbone)
    assert {n for n, _, _ in lay} == set(sd)
    assert all(tuple(sd[n].shape) == tuple(s) for n, s, _ in lay)


@pytest.mark.parametrize("backbone", BACKBONES)
def test_eval_forward_matches_the_port(backbone):
    from dad3dheads_tpu_torch.models import create_model

    P = seeded.weights(model_config(backbone), 3, "cpu", random_bn=True)
    model = create_model({"backbone": backbone}, torch.Generator().manual_seed(0))
    model.load_state_dict(P)
    x = network.normalize(seeded.images(3, 1, 2, 64, "cpu")[0])
    with torch.no_grad():
        port = model(x)
        ref = network.forward(P, x, backbone)
    for k, r in (("OUTPUT_3DMM_PARAMS", "3dmm"), ("OUTPUT_2D_LANDMARKS", "landmarks"),
                 ("OUTPUT_LANDMARKS_HEATMAP", "heatmap")):
        torch.testing.assert_close(port[k], ref[r], rtol=1e-5, atol=1e-5 * ref[r].abs().max().item())


def test_normalize_matches_the_ports():
    from dad3dheads_tpu_torch.ops.preprocess import normalize_images

    x = seeded.images(4, 1, 2, 16, "cpu")[0]
    torch.testing.assert_close(normalize_images(x), network.normalize(x), rtol=0, atol=1e-6)


def test_decode_matches_the_predictors(tmp_path):
    from dad3dheads_tpu_torch.api.predictor import decode_3dmm_to_mesh
    from dad3dheads_tpu_torch.constants import FLAME_CONSTS
    from dad3dheads_tpu_torch.core.flame import FlameModel

    arrays = seeded.flame(5, "cpu")
    fm = FlameModel.load(seeded.save_flame(arrays, str(tmp_path / "f.npz")), device="cpu")
    x = torch.randn(4, 413, generator=torch.Generator().manual_seed(0)) * 0.3
    x[:, 412] = 2.0
    v, proj = decode_3dmm_to_mesh(fm, x, FLAME_CONSTS, 256)
    _, v_ref, proj_ref = flame_ref.decode(arrays, x, 256)
    torch.testing.assert_close(v, v_ref, rtol=0, atol=1e-6)
    torch.testing.assert_close(proj, proj_ref, rtol=0, atol=1e-3)


def test_train_steps_match_the_port(tmp_path):
    """Three fp32 train steps of the port and of the reference from one state,
    on the same batches and dropout seeds. The random network in train mode
    amplifies round-off (BatchNorm over a handful of values per channel at
    this size), so the later steps' losses are held at 1e-3, the median
    leaf's gradient at 5% and the leaves' changes at 10%; the first step's
    loss and the BatchNorms' running statistics at round-off."""
    from dad3dheads_tpu_torch.core.flame import FlameModel
    from dad3dheads_tpu_torch.losses import LossModule
    from dad3dheads_tpu_torch.train.state import init_train_state
    from dad3dheads_tpu_torch.train.step import build_train_step

    mc = model_config("resnet50")
    arrays = seeded.flame(7, "cpu")
    fm = FlameModel.load(seeded.save_flame(arrays, str(tmp_path / "f.npz")), device="cpu")
    batches = seeded.train_batches(7, 3, 2, 64, arrays, "cpu")
    loss = yaml.safe_load(open("configs/loss/train_loss.yaml"))["loss"]
    settings = {"img_size": 64, "heatmap_stride": 4, "heatmap_radius": 5, "loss": loss, "lr": 1e-4, "clip": 5.0,
                "warmup_steps": 400}
    state = init_train_state({**mc, "dtype": "float32"}, {"name": "adam", "lr": 1e-4},
                             torch.Generator().manual_seed(0), "cpu", 5.0)
    start = seeded.weights(mc, 7, "cpu", random_bn=False)
    state.model.load_state_dict(start)
    step = build_train_step(LossModule(loss), 64, 400, with_metrics=True)
    params = dict(state.model.named_parameters())
    losses = []
    for i in range(3):
        torch.manual_seed(100 + i)
        losses.append(float(step(state, fm, port_batch(batches[i], 64))["loss"]))
        if i == 0:
            grads = {k: float(state.optimizer.optimizer.state[p]["exp_avg"].norm()) / 0.1 for k, p in params.items()}
    changes = {k: float((p.detach() - start[k]).norm()) for k, p in params.items()}
    ref = train_ref.run_steps(seeded.weights(mc, 7, "cpu", random_bn=False), arrays, batches, "resnet50",
                              settings, [100, 101, 102])
    buffers = dict(state.model.named_buffers())
    bn = {k[: -len(".running_mean")]: (v, buffers[k[: -len("mean")] + "var"])
          for k, v in buffers.items() if k.endswith(".running_mean")}
    numbers = compare.train_numbers({"losses": losses, "grad_norms": grads, "change_norms": changes, "bn": bn}, ref)
    np.testing.assert_allclose(losses[0], ref["losses"][0], rtol=1e-5)
    assert numbers["loss_rel"] < 1e-3
    assert numbers["stem_bn_rel"] < 1e-5
    assert numbers["bn_med"] < 1e-4
    assert numbers["grad_med"] < 0.05
    assert numbers["change_rel"] < 0.1
