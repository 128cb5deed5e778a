"""The yardstick's arithmetic against hand counts at small shapes."""

import pytest

from portbench import roofline as R


def test_kernel_bounds_by_hand():
    # normalize: 2 x 4 x 4 x 3 = 96 values, 1 byte in, 2 out -> 288 bytes
    assert R.normalize_bound_s(2, 4, R.BF16) == pytest.approx(288 / 3.35e12)
    # blendshapes B=2, K=3, N=5: bytes 4 (6 + 15 + 5 + 10) = 144; flops 3 x 2 x 30 = 180 at TF32
    assert R.blend_shapes_bound_s(2, 3, 5) == pytest.approx(max(144 / 3.35e12, 180 / 495e12))
    # its backward: bytes 4 (10 + 15 + 6 + 5) = 144; flops 180 + 10
    assert R.blend_shapes_bwd_bound_s(2, 3, 5) == pytest.approx(max(144 / 3.35e12, 190 / 495e12))
    # at the cells' shapes (PERF.md's kernel table): B=256 bound by operations, B=64 by bytes
    assert R.blend_shapes_bound_s(256) * 1e3 == pytest.approx(0.0187, abs=1e-4)
    assert R.blend_shapes_bound_s(64) * 1e3 == pytest.approx(0.0084, abs=1e-4)
    assert R.normalize_bound_s(256, 256, R.BF16) * 1e3 == pytest.approx(0.0451, abs=1e-4)


def test_model_flops_of_one_conv_layer_by_hand(monkeypatch):
    """The counter on the meta device: a 3x3 conv of 2 images of 8x8, 3 -> 4
    channels, is 2 x (2 x 8 x 8 x 4) x (3 x 9) FLOPs forward and twice that
    backward (the weight's gradient and the input's)."""
    import torch
    import torch.nn.functional as F
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.empty(2, 3, 8, 8, device="meta", requires_grad=True)
    w = torch.empty(4, 3, 3, 3, device="meta", requires_grad=True)
    with FlopCounterMode(display=False) as c:
        F.conv2d(x, w, padding=1).sum().backward()
    fwd = 2 * (2 * 8 * 8 * 4) * (3 * 9)
    assert c.get_total_flops() == 3 * fwd


@pytest.mark.parametrize("backbone, per_image", [("resnet50", 15.73), ("mobilenet_w1", 5.43)])
def test_model_flops_served(backbone, per_image):
    """Within 1% of the count recorded in PERF.md (the XLA record of the JAX
    package read 15.5 GFLOP an image for resnet50 serving)."""
    mc = {"backbone": backbone, "num_filters": 256, "num_classes": 68}
    assert R.model_flops(mc, 4, 256, train=False) / 4 / 1e9 == pytest.approx(per_image, rel=0.01)


def test_model_flops_train_is_about_three_forwards():
    mc = {"backbone": "resnet50", "num_filters": 256, "num_classes": 68}
    ratio = R.model_flops(mc, 2, 128, train=True) / R.model_flops(mc, 2, 128, train=False)
    assert 2.9 < ratio < 3.0  # the stem's input needs no gradient
