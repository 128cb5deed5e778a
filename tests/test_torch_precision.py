"""``precision.fp32_exact``: the geometry stays full fp32 whatever TF32
setting the caller made. The JAX package pins its geometry matmuls to
``Precision.HIGHEST`` (dad3dheads_tpu/core/lbs.py); PyTorch reads a
process-wide setting instead. The guard sets and restores both cuBLAS's and
cuDNN's settings under either of torch's APIs; the LBS matmuls of the
predictor's decode and of the train step run with TF32 off after a caller
turned it on (a spy on ``torch.matmul``); on the card, the decode under
``torch.set_float32_matmul_precision("high")`` holds ``chip_smoke.py``
phase 4's fp32 tolerances against the CPU. Imports no JAX: the card test runs
from this file."""

import numpy as np
import pytest
import torch

from dad3dheads_tpu_torch.precision import fp32_exact

NEW_API = {
    "global": lambda: torch.backends,
    "matmul": lambda: torch.backends.cuda.matmul,
    "cudnn": lambda: torch.backends.cudnn,
    "conv": lambda: torch.backends.cudnn.conv,
    "rnn": lambda: torch.backends.cudnn.rnn,
}


def _read(fn):
    try:
        return fn()
    except RuntimeError:  # torch refuses the legacy getters when the two APIs disagree
        return "refused"


def snapshot() -> dict:
    """Every setting either API shows: the per-backend strings and the
    legacy flags."""
    out = {name: get().fp32_precision for name, get in NEW_API.items()}
    out["legacy_matmul"] = _read(lambda: torch.backends.cuda.matmul.allow_tf32)
    out["legacy_cudnn"] = _read(lambda: torch.backends.cudnn.allow_tf32)
    out["legacy_precision"] = _read(torch.get_float32_matmul_precision)
    return out


@pytest.fixture
def restore_settings():
    """Put the process's settings back as they were: the worker runs other
    tests after this one."""
    before = snapshot()
    legacy = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    yield before
    torch.backends.fp32_precision = before["global"]
    torch.set_float32_matmul_precision(legacy[0])
    torch.backends.cudnn.allow_tf32 = legacy[1]
    for name in ("matmul", "cudnn", "conv", "rnn"):
        NEW_API[name]().fp32_precision = before[name]
    assert snapshot() == before


def set_legacy_high():
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True


def set_legacy_off():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def set_new_tf32():
    torch.backends.cuda.matmul.fp32_precision = "tf32"
    torch.backends.cudnn.conv.fp32_precision = "tf32"


def set_new_global_tf32():
    torch.backends.fp32_precision = "tf32"


CALLERS = {"default": lambda: None, "legacy_high": set_legacy_high, "legacy_off": set_legacy_off,
           "new_tf32": set_new_tf32, "new_global_tf32": set_new_global_tf32}


@pytest.mark.parametrize("caller", sorted(CALLERS))
def test_guard_sets_and_restores_both_settings(restore_settings, caller):
    """Inside: cuBLAS and cuDNN convolutions at "ieee" (no TF32). After:
    every setting as the caller left it, under either API, nested too."""
    CALLERS[caller]()
    before = snapshot()
    with fp32_exact():
        assert torch.backends.cuda.matmul.fp32_precision == "ieee"
        assert torch.backends.cudnn.conv.fp32_precision == "ieee"
        with fp32_exact():
            assert torch.backends.cuda.matmul.fp32_precision == "ieee"
        assert torch.backends.cudnn.conv.fp32_precision == "ieee"
    assert snapshot() == before
    with pytest.raises(ValueError):
        with fp32_exact():
            raise ValueError("inside")
    assert snapshot() == before


@pytest.fixture
def matmul_spy(monkeypatch):
    """The cuBLAS setting at each ``torch.matmul`` the geometry makes
    (core/lbs.py calls it through the module attribute)."""
    seen = []
    matmul = torch.matmul

    def spy(*args, **kwargs):
        seen.append(torch.backends.cuda.matmul.fp32_precision)
        return matmul(*args, **kwargs)

    monkeypatch.setattr(torch, "matmul", spy)
    return seen


def test_lbs_matmuls_run_without_tf32_after_the_caller_turned_it_on(restore_settings, matmul_spy):
    """The predictor's decode and the train step (geometry, losses and
    backward) after ``torch.set_float32_matmul_precision("high")``: every
    LBS matmul sees "ieee"; the caller's "high" is back afterwards."""
    from dad3dheads_tpu_torch.api import FaceMeshPredictor
    from dad3dheads_tpu_torch.core.landmarks import LandmarkEmbedding
    from dad3dheads_tpu_torch.data.synthetic import synthetic_batch
    from dad3dheads_tpu_torch.models import create_model
    from dad3dheads_tpu_torch.train import TrainState, build_train_step, get_optimizer

    pred = FaceMeshPredictor({"img_size": 64, "model": {"backbone": "mobilenet_w1", "num_filters": 64}},
                             device="cpu", seed=1)
    model = create_model({"backbone": "mobilenet_w1", "num_filters": 64, "dtype": "bfloat16"},
                         torch.Generator().manual_seed(2))
    state = TrainState(model, get_optimizer({"name": "adam", "lr": 1e-4}, model.parameters()), step=0)
    batch = synthetic_batch(torch.Generator().manual_seed(3), pred.flame, LandmarkEmbedding.load(), 2, 64)
    matmul_spy.clear()

    torch.set_float32_matmul_precision("high")
    pred.predict_batch(np.zeros((2, 64, 64, 3), np.uint8))
    decode_calls = len(matmul_spy)
    assert decode_calls > 0
    build_train_step(img_size=64)(state, pred.flame, batch)
    assert len(matmul_spy) > decode_calls
    assert set(matmul_spy) == {"ieee"}, matmul_spy
    assert torch.get_float32_matmul_precision() == "high"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_decode_under_tf32_caller_matches_the_cpu(restore_settings, cuda):
    """``chip_smoke.py`` phase 4's fp32 tolerances (3D vertices 1e-3, the
    projection 0.5 px) on the card's decode of 64 seeded 3DMM vectors,
    against the CPU's, after the caller asked for TF32 everywhere."""
    from dad3dheads_tpu_torch.api import FaceMeshPredictor
    from dad3dheads_tpu_torch.kernel_timing import head_params

    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    config = {"img_size": 256, "model": {"backbone": "mobilenet_w1"}}
    rng = np.random.default_rng(0)
    params = np.concatenate([head_params(seed) for seed in range(64)]).astype(np.float32)
    params[:, :400] += rng.normal(size=(64, 400)).astype(np.float32) * 0.5
    out, ref = ([t.cpu().numpy() for t in pred._decode_3dmm(torch.from_numpy(params).to(pred.device),
                                                             pred._replica(pred.device))]
                for pred in (FaceMeshPredictor(config, device=cuda), FaceMeshPredictor(config, device="cpu")))
    assert np.abs(out[0] - ref[0]).max() <= 1e-3
    assert np.abs(out[1] - ref[1]).max() <= 0.5
    assert torch.get_float32_matmul_precision() == "high"
