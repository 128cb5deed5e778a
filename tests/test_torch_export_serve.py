"""The port's deployment artifact written by the trainer (``export_aot``)
and served by a process that cannot import the models, the FLAME code or
JAX; and ``torch.library.opcheck`` on the five ``dad3d::`` custom operators,
on CPU tensors. The artifact's parity with the live predictor and with the
JAX package's artifact is in tests/test_torch_export.py.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from dad3dheads_tpu_torch.api import predictor as tpred
from dad3dheads_tpu_torch.api.export import SUFFIX, read_meta


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tests run beside other test processes: two torch threads each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the artifact's loader and server import none of these (nor anything of them)
BLOCKED = ("dad3dheads_tpu_torch.models", "dad3dheads_tpu_torch.core.flame", "dad3dheads_tpu_torch.assets",
           "dad3dheads_tpu", "jax", "jaxlib", "flax")


def _uint8(seed: int, *shape: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``cli.train --synthetic 2 --device cpu export_aot=true`` at smoke size:
    its checkpoints directory."""
    from dad3dheads_tpu_torch.cli.train import main

    exp = str(tmp_path_factory.mktemp("train") / "exp")
    main(["--config", "configs/train.yaml", "--synthetic", "2", "--device", "cpu", "export_aot=true",
          "model.backbone=mobilenet_w1", "model.num_filters=64", "img_size=64", "batch_size=2", "max_epochs=1",
          f"experiment_dir={exp}"])
    return os.path.join(exp, "checkpoints")


def test_trainer_export_aot_writes_the_artifact(trained):
    """The artifact lies beside the msgpack, with programs for the trainer's
    device (the CPU here) alone, at the run's image size and backbone."""
    meta = read_meta(os.path.join(trained, f"dad_3dnet{SUFFIX}"))
    assert os.path.isfile(os.path.join(trained, "dad_3dnet.msgpack"))
    assert meta["devices"] == ["cpu"] and meta["img_size"] == 64 and meta["backbone"] == "mobilenet_w1"


def test_serves_without_model_code_flame_or_jax(trained, tmp_path):
    """A fresh interpreter that cannot import the models, the FLAME code and
    assets, JAX or the JAX package loads the trainer's artifact and serves
    predict_batch and __call__, as the live predictor serves the trainer's
    msgpack."""
    images, image = _uint8(12, 2, 64, 64, 3), _uint8(13, 90, 70, 3)
    np.savez(tmp_path / "in.npz", images=images, image=image)
    code = textwrap.dedent(
        f"""
        import importlib.abc, sys
        BLOCKED = {BLOCKED!r}

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                    raise ImportError("blocked: " + name)

        sys.meta_path.insert(0, Block())
        import numpy as np, torch
        torch.set_num_threads(1)
        from dad3dheads_tpu_torch.api import ExportedFaceMeshPredictor

        z = np.load({str(tmp_path / "in.npz")!r})
        pred = ExportedFaceMeshPredictor({os.path.join(trained, "dad_3dnet" + SUFFIX)!r}, device="cpu")
        batch, one = pred.predict_batch(z["images"]), pred(z["image"])
        np.savez({str(tmp_path / "out.npz")!r}, **{{"batch_" + k: v for k, v in batch.items()}},
                 **{{"call_" + k: v for k, v in one.items()}})
        print("SERVED_OK")
        """
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=600,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0 and "SERVED_OK" in proc.stdout, proc.stderr[-4000:]
    out = np.load(tmp_path / "out.npz")
    config = {"img_size": 64, "model": {"backbone": "mobilenet_w1", "num_filters": 64}}
    live = tpred.FaceMeshPredictor(config, checkpoint_path=os.path.join(trained, "dad_3dnet.msgpack"), device="cpu",
                                   require_weights=True)
    for prefix, ref in (("batch_", live.predict_batch(images)), ("call_", live(image))):
        for k, v in ref.items():
            atol = 1.0 if prefix + k == "call_points" else 1e-4  # integers after the readjustment
            np.testing.assert_allclose(out[prefix + k], v, rtol=1e-4, atol=atol, err_msg=prefix + k)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _op_cases(device="cpu"):
    """Each op's arguments: small on the CPU; on the card the blendshape ops
    take FLAME's widths (400 coefficients, 5,023 vertices) and its padded
    rows, which their kernels are built for."""
    from dad3dheads_tpu_torch.ops.preprocess_device import frame_scalars

    rng = np.random.default_rng(15)
    K, V = (8, 4) if device == "cpu" else (400, 5023)

    def f32(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    padded = f32(K, -(-3 * V // 4) * 4)[:, : 3 * V]  # FLAME's rows, padded to 16 bytes
    sizes = torch.tensor([[20, 30], [18, 25]], dtype=torch.int32)
    boxes = torch.tensor([[2, 3, 25, 19], [0, 0, 25, 18]], dtype=torch.int32)
    scalars, _, _ = frame_scalars(sizes, boxes, 16)
    verts = torch.from_numpy(np.concatenate([rng.uniform(0, 11, size=(9, 2)), rng.normal(size=(9, 1))], 1)
                             .astype(np.float32))
    faces = torch.from_numpy(rng.integers(0, 9, size=(7, 3)).astype(np.int32))
    u8 = torch.from_numpy(rng.integers(0, 256, size=(2, 5, 7, 3), dtype=np.uint8))
    frames = torch.from_numpy(rng.integers(0, 256, size=(2, 20, 30, 3), dtype=np.uint8))
    cases = {
        "blend_shapes": (torch.ops.dad3d.blend_shapes, (f32(3, K), padded, f32(V, 3)), True),
        "blend_shapes_bwd": (torch.ops.dad3d.blend_shapes_bwd, (f32(3, 3 * V), f32(3, K), padded, True), False),
        "blend_shapes_bwd_no_dirs": (torch.ops.dad3d.blend_shapes_bwd, (f32(3, 3 * V), f32(3, K), padded, False),
                                     False),
        "normalize_u8": (torch.ops.dad3d.normalize_u8, (u8, "imagenet", torch.bfloat16), False),
        "resample_normalize_u8": (torch.ops.dad3d.resample_normalize_u8,
                                  (frames, scalars, 16, "imagenet", torch.float32), False),
        "rasterize": (torch.ops.dad3d.rasterize, (verts, faces, 12, 10), False),
    }

    def move(a, grad):
        if not isinstance(a, torch.Tensor):
            return a
        out = torch.empty_strided(a.shape, a.stride(), dtype=a.dtype, device=device).copy_(a)  # keeps the strides
        return out.requires_grad_(grad and a.is_floating_point())

    return {name: (op, tuple(move(a, grad) for a in args)) for name, (op, args, grad) in cases.items()}


@pytest.mark.parametrize("case", ["blend_shapes", "blend_shapes_bwd", "blend_shapes_bwd_no_dirs", "normalize_u8",
                                  "resample_normalize_u8", "rasterize"])
def test_opcheck(case):
    """torch.library.opcheck on CPU tensors: schema, fake implementation,
    autograd registration (the blendshape forward's gradient through the
    backward op), and a trace with dynamic shapes."""
    import dad3dheads_tpu_torch.render.rasterizer  # noqa: F401  registers dad3d::rasterize

    op, args = _op_cases()[case]
    torch.library.opcheck(op, args)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["blend_shapes", "blend_shapes_bwd", "blend_shapes_bwd_no_dirs", "normalize_u8",
                                  "resample_normalize_u8", "rasterize"])
def test_opcheck_cuda(cuda, case):
    """The same on CUDA tensors: each op's kernel against its schema, its
    fake implementation (shapes, types, strides) and its autograd
    registration."""
    import dad3dheads_tpu_torch.render.rasterizer  # noqa: F401  registers dad3d::rasterize

    op, args = _op_cases(cuda)[case]
    torch.library.opcheck(op, args)
