"""The int8 deployment artifact on the CPU: ``cli.export --quant-amax``
writes a resnet50 artifact whose ``pipeline`` program runs the int8 mirror,
with the prepared kernels stored once and the folded fp weights left out;
``ExportedFaceMeshPredictor`` serves it with a gap of 0 to the live int8
predictor on the same inputs. The artifact here is written and loaded with
the ``frames`` program left out of ``api.export.PROGRAMS``, whose trace and
load would double the file's time: the int8 ``frames`` program is the same
network behind the device preprocessing that tests/test_torch_export.py
serves, and ``chip_smoke.py`` phase 10 serves it from the card against the
live predictor."""

import io
import zipfile

import numpy as np
import pytest
import torch

from dad3dheads_tpu.api import predictor as jpred
from dad3dheads_tpu_torch.api import predictor as tpred
from dad3dheads_tpu_torch.api import export
from dad3dheads_tpu_torch.api.export import ExportedFaceMeshPredictor, read_meta
from dad3dheads_tpu_torch.models.quantized import calibrate, save_amax
from dad3dheads_tpu_torch.ops.preprocess import normalize_scale_bias

from .test_torch_predictor import IMG, seeded_variables


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tests run beside other test processes: two torch threads each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The live int8 predictor and its artifact, written by ``cli.export``."""
    from dad3dheads_tpu_torch.cli.export import main

    d = tmp_path_factory.mktemp("int8_aot")
    ck = jpred.save_predictor_checkpoint(seeded_variables(4), str(d / "dad_3dnet.msgpack"))
    fp = tpred.FaceMeshPredictor({"img_size": IMG}, checkpoint_path=ck, device="cpu")
    images = np.random.default_rng(9).integers(0, 256, (4, IMG, IMG, 3), dtype=np.uint8)
    amax = save_amax(calibrate(fp.model, [tpred.normalize_images(torch.from_numpy(images))]), str(d / "amax.npz"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(export, "PROGRAMS", ("pipeline", "decode"))
        path = main(["--checkpoint", ck, "--out", str(d / "q.aot.zip"), "--img-size", str(IMG), "--dtype", "fp32",
                     "--device", "cpu", "--devices", "cpu", "--quant-amax", amax])
        exported = ExportedFaceMeshPredictor(path, device="cpu")
    live = tpred.FaceMeshPredictor({"img_size": IMG, "model": {"dtype": "float32"}, "quant_amax": amax},
                                   checkpoint_path=ck, device="cpu")
    return path, live, exported


def assert_same(got: dict, ref: dict) -> None:
    """The network's outputs bit for bit; the mesh, from the decode program
    against the live decode (the exported graph's products may sum in
    another order on the CPU), within 1e-5."""
    assert set(got) == set(ref)
    for key in ("points", "3dmm_params"):
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(ref[key]), err_msg=key)
    for key in ("3d_vertices", "projected_vertices"):
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(ref[key]), rtol=0, atol=1e-5, err_msg=key)


def test_int8_artifact_contents(served):
    """``"quantized": true``; the 76 prepared kernels stored once; of the fp
    weights only those the mirror reads (the BiFPN fusion weights and the
    regression heads), and no weight inside the programs: their constants
    are the amax table's scalars."""
    path, live, exported = served
    meta = read_meta(path)
    assert meta["quantized"] is True and meta["backbone"] == "resnet50" and meta["devices"] == ["cpu"]
    with zipfile.ZipFile(path) as z:
        assert {n for n in z.namelist() if n.endswith(".pt2")} == {"pipeline.cpu.pt2", "decode.cpu.pt2"}
    with zipfile.ZipFile(path) as z:
        tensors = torch.load(io.BytesIO(z.read("weights.pt")), weights_only=True)
    assert set(tensors["qparams"]) == set(live.quant_qparams) and len(tensors["qparams"]) == 76
    for k, (w, ws, b) in tensors["qparams"].items():
        assert w.dtype == torch.int8 and torch.equal(w, live.quant_qparams[k][0]), k
    assert tensors["model"] and all(k.startswith(("shape.", "pose.", "landmarks.")) or k.endswith((".w1", ".w2"))
                                    for k in tensors["model"])
    assert not any(k.startswith(("encoder.", "head.", "fusion_layer.")) for k in tensors["model"])
    program = exported._programs["pipeline"]
    constants = [getattr(program, n.target) for n in program.graph.nodes if n.op == "get_attr"]
    assert constants and all(t.numel() == 1 for t in constants)


def test_int8_artifact_serves_what_the_live_predictor_does(served):
    """Gap 0 in the network's outputs on the same inputs: predict_batch on a
    normalized batch and ``__call__`` on an image of another size (both
    normalize it on the host)."""
    _, live, exported = served
    rng = np.random.default_rng(12)
    scale, bias = normalize_scale_bias("imagenet")
    x = (rng.integers(0, 256, (3, IMG, IMG, 3)).astype(np.float32) * scale + bias).astype(np.float32)
    assert_same(exported.predict_batch(x), live.predict_batch(x))
    image = rng.integers(0, 256, (50, 80, 3), dtype=np.uint8)
    assert_same(exported(image), live(image))
