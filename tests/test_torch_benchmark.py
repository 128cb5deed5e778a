"""The port's benchmark harness against the JAX package's on the CPU, on a
val set of 5 images at 64x64 rendered once by the port's
``cli/make_dataset.py`` and a submission made from its ground truth with
noise (the JAX package reads the same files):

- ``generate_gt``: the same json, byte for byte;
- ``DADEvaluator`` against ``dad3dheads_tpu.benchmark_harness.DADEvaluator``:
  pose and NME bit-equal, the Chamfer per-point minima within 1e-6
  relative, Z_5 equal per sample (or each flip a near tie, within 2 ulp);
- the port's batched scorer bit for bit its per-sample oracle, on a ragged
  submission too, and its fallback to the oracle taken whatever stops the
  batched scorer;
- ``predictions_to_submission_entry`` within 1e-5 of the JAX package's;
- the benchmark CLI.
"""

import importlib
import json
import logging
import os

import numpy as np
import pytest
import torch

from dad3dheads_tpu_torch.benchmark_harness import DADEvaluator, generate_gt, one_sided_chamfer_mins, zn_accuracy
from dad3dheads_tpu_torch.benchmark_harness.evaluate import SEVEN_LMK_INDICES, HeadAnnotation
from dad3dheads_tpu_torch.cli.make_dataset import make_dataset

S, N = 64, 5


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(dataset root, GT path, submission path)."""
    root = tmp_path_factory.mktemp("bench")
    out = str(root / "ds")
    make_dataset(out, "val", N, S, seed=5, device="cpu")
    gt_path = generate_gt(out, "val", output_dir=str(root / "gt"))
    gt = json.load(open(gt_path))
    for i, g in enumerate(gt):  # attributes for the aggregation
        g["attributes"] = {"quality": "good" if i % 2 else "bad"}
    gt_path = str(root / "gt_with_attributes.json")
    json.dump(gt, open(gt_path, "w"))
    sub_path = str(root / "sub.json")
    json.dump(noisy_submission(gt, np.random.default_rng(0)), open(sub_path, "w"))
    return out, gt_path, sub_path


def noisy_submission(gt, rng):
    """A perfect submission from the GT (camera-convention mesh and 7
    landmarks of the 20 mm-scaled GT, the GT's 2D landmarks and rotation),
    with noise on every field."""
    ev = DADEvaluator.__new__(DADEvaluator)
    DADEvaluator.__init__(ev, "", "", device="cpu")
    sub = {}
    for g in gt:
        a = HeadAnnotation.from_config(g)
        world = a.vertices3d_world_homo[:, :3]
        svn = ev._landmarks68_3d(world)[SEVEN_LMK_INDICES]
        scaled = world * (20.0 / np.linalg.norm(svn[1] - svn[2]))
        svn_scaled = ev._landmarks68_3d(scaled)[SEVEN_LMK_INDICES]
        w = rng.normal(size=3) * 0.05
        th = np.linalg.norm(w)
        k = w / th
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        dR = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)
        sub[a.id] = {
            "68_landmarks_2d": (ev.gt_landmarks_68_2d(a) + rng.normal(size=(68, 2)) * 2.0).tolist(),
            "N_landmarks_3d": (-scaled + rng.normal(size=scaled.shape) * 0.3).tolist(),
            "7_landmarks_3d": (-svn_scaled + rng.normal(size=(7, 3)) * 0.1).tolist(),
            "rotation_matrix": (dR @ ev.get_gt_rot_mat(a)).tolist(),
        }
    return sub


def test_generate_gt_equals_the_jax_packages(data, tmp_path):
    from dad3dheads_tpu.benchmark_harness import generate_gt as jax_generate_gt

    out = data[0]
    port, ref = generate_gt(out, "val", output_dir=str(tmp_path / "a")), jax_generate_gt(out, "val", output_dir=str(
        tmp_path / "b"))
    assert os.path.basename(port) == os.path.basename(ref) == "ground_truth_val.json"
    assert open(port).read() == open(ref).read()
    gt = json.load(open(port))
    assert len(gt) == N and gt[0]["image_height"] == S and len(gt[0]["vertices"]) == 5023
    with pytest.raises(AssertionError, match="Attributes"):
        generate_gt(out, "val", with_attributes=True, output_dir=str(tmp_path / "c"))


def assert_zn_flips_are_ties(pred_head, gt_head, z_port, z_ref, top_k=5):
    """Where the per-sample Z_5 differ, each neighbour ranking of the port
    differs from the exact (float64) ranking only between distances within
    2 ulp of each other: the flip is a near tie that rounding decided."""
    if z_port == z_ref:
        return
    g = gt_head.astype(np.float64)
    exact = ((g[:, None, :] - g[None, 1 : top_k + 1, :]) ** 2).sum(-1)
    g32 = gt_head.astype(np.float32)
    d = [g32[:, None, k] - g32[None, 1 : top_k + 1, k] for k in range(3)]
    d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    for j in range(top_k):
        port_order = np.argsort(d2[:, j], kind="stable")
        exact_order = np.argsort(exact[:, j], kind="stable")
        for a, b in zip(port_order[port_order != exact_order], exact_order[port_order != exact_order]):
            assert abs(d2[a, j] - d2[b, j]) <= 2 * np.spacing(np.float32(d2[a, j])), (j, a, b)


def test_evaluator_matches_the_jax_packages(data):
    """Two items through both evaluators' batched scorers (the JAX one
    sorts the whole (3669, 3669) matrix per item, ~7 s on two threads)."""
    ev_mod = importlib.import_module("dad3dheads_tpu.benchmark_harness.evaluate")
    _, gt_path, sub_path = data
    port = DADEvaluator(gt_path, sub_path, device="cpu")
    ref = ev_mod.DADEvaluator(gt_path, sub_path)
    anns, preds = port.load()
    anns, preds = anns[:2], preds[:2]
    got = port.score_batched(anns, preds, chunk=2)
    want = ref.score_batched([ev_mod.HeadAnnotation.from_config(g) for g in json.load(open(gt_path))[:2]], preds,
                             chunk=2)
    # pose and NME bit-equal to the JAX package's per-sample metrics (its
    # batched pose reduces a stack of norms in another order, and can part
    # from its own per-sample pose in the last bit)
    jax_anns = [ev_mod.HeadAnnotation.from_config(g) for g in json.load(open(gt_path))[:2]]
    np.testing.assert_array_equal(got["pose_error"], [ref.pose_error(a, p) for a, p in zip(jax_anns, preds)])
    np.testing.assert_array_equal(got["nme"], [ref.nme(a, p) for a, p in zip(jax_anns, preds)])
    np.testing.assert_array_equal(got["nme"], want["nme"])
    np.testing.assert_allclose(got["pose_error"], want["pose_error"], rtol=1e-15)
    for i, (a, p) in enumerate(zip(anns, preds)):
        # the per-point minima: the port's oracle (its batched scorer's bits,
        # test_batched_scorer_equals_its_oracle_bit_for_bit) against the JAX
        # Chamfer kernel on the oracle's inputs
        world = a.vertices3d_world_homo[:, :3]
        svn = port._landmarks68_3d(world)[SEVEN_LMK_INDICES]
        gt_v = world.astype(np.float32) * np.float32(20.0 / (np.linalg.norm(svn[1] - svn[2]) + 1e-12))
        tf = ev_mod.procrustes(port._landmarks68_3d(gt_v)[SEVEN_LMK_INDICES],
                               np.asarray(p["7_landmarks_3d"], np.float32))
        aligned = tf["scale"] * np.asarray(p["N_landmarks_3d"], np.float32) @ tf["rotation"] + tf["translation"]
        ref_mins = np.asarray(ev_mod._chamfer_mins_jit(gt_v[port.face_indices], aligned.astype(np.float32)))
        np.testing.assert_allclose(port.chamfer_mins(a, p), ref_mins, rtol=1e-6, atol=0)
        np.testing.assert_allclose(got["chamfer"][i], want["chamfer"][i], rtol=1e-6)
        pred_head = np.asarray(p["N_landmarks_3d"], np.float32)[port.head_indices]
        assert_zn_flips_are_ties(pred_head, -world[port.head_indices], got["z5"][i], want["z5"][i])
    assert got["z5"].min() > 0.5 and got["chamfer"].max() < 10  # a near-perfect submission


def test_batched_scorer_equals_its_oracle_bit_for_bit(data):
    """Every metric, overall and by attribute, with a chunk that leaves a
    ragged last chunk (5 items, chunk 2)."""
    _, gt_path, sub_path = data
    ev = DADEvaluator(gt_path, sub_path, device="cpu")
    fast, fast_attrs = ev(batched=True, chunk=2)
    slow, slow_attrs = ev(batched=False)
    assert fast.keys() == {"pose_error", "nme_reprojection", "z5_accuracy", "chamfer"}
    for k in slow:
        np.testing.assert_array_equal(fast[k], slow[k], err_msg=k)
    assert set(slow_attrs["chamfer"]["quality"]) == {"good", "bad"}
    assert fast_attrs == slow_attrs
    assert ev(batched=True, chunk=5)[0] == fast


def _rewrite(sub_path, tmp_path, edit):
    sub = json.load(open(sub_path))
    edit(sub)
    path = str(tmp_path / "edited.json")
    json.dump(sub, open(path, "w"))
    return path


def test_ragged_submission_falls_back_loudly_and_matches_oracle(data, tmp_path, caplog):
    _, gt_path, sub_path = data

    def add_vertices(sub):
        item = sorted(sub)[1]
        v = sub[item]["N_landmarks_3d"]
        sub[item]["N_landmarks_3d"] = v + v[:10]

    path = _rewrite(sub_path, tmp_path, add_vertices)
    ev = DADEvaluator(gt_path, path, device="cpu")
    with caplog.at_level(logging.WARNING, logger="dad3dheads_tpu_torch.benchmark_harness.evaluate"):
        fast, _ = ev(batched=True, chunk=2)
    assert any("per-sample oracle" in r.message and "5023, 5033" in r.message for r in caplog.records)
    slow, _ = ev(batched=False)
    assert fast == slow


def test_fallback_is_taken_when_an_entry_lacks_its_mesh(data, tmp_path, caplog):
    """A missing N_landmarks_3d stops the batched scorer and the diagnostic
    sizes alike: the fallback is still taken (and logged), and the oracle
    then names the missing key."""
    _, gt_path, sub_path = data
    path = _rewrite(sub_path, tmp_path, lambda sub: sub[sorted(sub)[0]].pop("N_landmarks_3d"))
    ev = DADEvaluator(gt_path, path, device="cpu")
    with caplog.at_level(logging.WARNING, logger="dad3dheads_tpu_torch.benchmark_harness.evaluate"):
        with pytest.raises(KeyError, match="N_landmarks_3d"):
            ev(batched=True)
    (record,) = [r for r in caplog.records if "per-sample oracle" in r.message]
    assert "unreadable" in record.message


def test_zn_sorts_only_the_columns_the_reference_reads():
    """Z_5 from the columns 1..5 of the squared-distance matrix equals the
    reference's argsort of the whole matrix along dim 0, then [:, 1:6], and
    the JAX package's literal double loop; on coordinates with many exact
    ties, where only a stable sort keeps the order."""
    rng = np.random.default_rng(3)
    for n in (40, 300):
        gt = np.round(rng.normal(size=(n, 3)) * 4).astype(np.float32) / 4  # exact ties
        pred = (gt + rng.normal(size=gt.shape) * 0.3).astype(np.float32)
        g = torch.from_numpy(gt)
        d = [g[:, None, k] - g[None, :, k] for k in range(3)]
        idx = torch.argsort(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], dim=0, stable=True)[:, 1:6].numpy()
        full = np.mean((gt[:, None, 2] >= gt[idx, 2]) == (pred[:, None, 2] >= pred[idx, 2]))
        loops = np.mean([(gt[i, 2] >= gt[idx[i, j], 2]) == (pred[i, 2] >= pred[idx[i, j], 2])
                         for i in range(n) for j in range(5)])
        ours = float(zn_accuracy(torch.from_numpy(pred), g))
        assert ours == np.float32(full) == np.float32(loops)
        batched = zn_accuracy(torch.from_numpy(np.stack([pred, gt])), torch.stack([g, g]))
        assert float(batched[0]) == ours and float(batched[1]) == 1.0


def test_chamfer_minima_against_float64():
    rng = np.random.default_rng(4)
    src = rng.normal(size=(1100, 3)).astype(np.float32) * 20
    dst = rng.normal(size=(700, 3)).astype(np.float32) * 20
    exact = ((src[:, None].astype(np.float64) - dst[None]) ** 2).sum(-1).min(-1)
    got = one_sided_chamfer_mins(torch.from_numpy(src), torch.from_numpy(dst)).numpy()
    assert got.shape == (1100,)
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-4)
    again = one_sided_chamfer_mins(torch.from_numpy(src), torch.from_numpy(dst), rows=37).numpy()
    np.testing.assert_array_equal(again, got)


def test_perfect_submission_scores(data, tmp_path):
    _, gt_path, _ = data
    gt = json.load(open(gt_path))
    ev = DADEvaluator(gt_path, "", device="cpu")
    sub = {}
    for g in gt:
        a = HeadAnnotation.from_config(g)
        world = a.vertices3d_world_homo[:, :3]
        svn = ev._landmarks68_3d(world)[SEVEN_LMK_INDICES]
        scaled = world * (20.0 / np.linalg.norm(svn[1] - svn[2]))
        sub[a.id] = {"68_landmarks_2d": ev.gt_landmarks_68_2d(a).tolist(), "N_landmarks_3d": (-scaled).tolist(),
                     "7_landmarks_3d": (-ev._landmarks68_3d(scaled)[SEVEN_LMK_INDICES]).tolist(),
                     "rotation_matrix": ev.get_gt_rot_mat(a).tolist()}
    ev.sub_path = str(tmp_path / "perfect.json")
    json.dump(sub, open(ev.sub_path, "w"))
    overall, _ = ev()
    assert overall["pose_error"] == pytest.approx(0.0, abs=1e-5)
    assert overall["nme_reprojection"] == pytest.approx(0.0, abs=1e-4)
    assert overall["z5_accuracy"] == pytest.approx(1.0, abs=1e-6)
    assert overall["chamfer"] == pytest.approx(0.0, abs=5e-3)


def test_submission_entry_matches_the_jax_packages():
    from dad3dheads_tpu.benchmark_harness.submission import predictions_to_submission_entry as jax_entry
    from dad3dheads_tpu_torch.benchmark_harness import predictions_to_submission_entry

    rng = np.random.default_rng(6)
    mm = (rng.normal(size=(1, 413)) * 0.1).astype(np.float32)
    mm[0, 403:409] = [1.0, 0.1, 0.0, -0.1, 1.0, 0.2]
    preds = {"3d_vertices": (rng.normal(size=(5023, 3)) * 0.1).astype(np.float32),
             "projected_vertices": (rng.uniform(0, 64, size=(1, 5023, 2))).astype(np.float32),
             "3dmm_params": mm}
    got, want = predictions_to_submission_entry(preds), jax_entry(preds)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]), atol=1e-5, err_msg=key)


def test_benchmark_cli(data, tmp_path, capsys):
    from dad3dheads_tpu_torch.cli.benchmark import main

    out, gt_path, sub_path = data
    main(["generate-gt", "--base-path", out, "--subset", "val", "--output-dir", str(tmp_path)])
    assert capsys.readouterr().out.strip() == str(tmp_path / "ground_truth_val.json")
    main(["evaluate", "--submission", sub_path, "--gt", gt_path, "--device", "cpu"])
    printed = capsys.readouterr().out
    overall, _ = DADEvaluator(gt_path, sub_path, device="cpu")()
    assert "=== DAD-3DHeads benchmark ===" in printed and f"{overall['chamfer']:.6f}" in printed
    assert "quality:" in printed
