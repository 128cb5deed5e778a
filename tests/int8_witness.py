"""A second witness for the int8 leg of the port's acceptance run: the
checkpoint the port trains on the card, scored through the JAX package's
int8 predictor on the CPU beside the port's, on the same amax table.

The trained resnet50 checkpoint is 126 MiB in fp32. To keep what the card
run writes small (about 60 MiB in all), the ``card`` mode rounds every tensor
of 65,536 values or more to bf16 (round to nearest even; the rest stay
exact), compresses it, and scores that rounded checkpoint on the card in
fp32 and int8 beside the exact one. The ``cpu`` mode then scores the same
rounded checkpoint through both packages on the CPU:

  # on the card, from the repo root
  python3 tests/int8_witness.py card --out DIR
  # on the CPU, with DIR copied here
  python -m tests.int8_witness cpu --from DIR

This file is a script, not a test module; the ``card`` mode imports only
the port.
"""

from __future__ import annotations

import argparse
import glob
import json
import lzma
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(REPO, "experiments", "acc")  # git-ignored
IMG = 128


def _du(d: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(d) for f in fs)


def _round_tree(tree, counts):
    """Tensors of 65,536 values or more to the nearest bf16 (kept as fp32)."""
    if isinstance(tree, dict):
        return {k: _round_tree(v, counts) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype != np.float32 or a.size < 65536:
        counts["exact"] += a.size
        return a
    counts["rounded"] += a.size
    u = a.view(np.uint32).astype(np.uint64)
    return (((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)).view(np.float32)


def card(out: str) -> None:
    """The acceptance run with its int8 leg, then the rounded checkpoint
    (compressed), the amax tables, the card's legs on it, and the val set's
    images and ground truth."""
    from dad3dheads_tpu_torch import weights
    from dad3dheads_tpu_torch.cli.acceptance import evaluate_checkpoint
    from dad3dheads_tpu_torch.cli.calibrate_int8 import main as calibrate_int8

    os.makedirs(out, exist_ok=True)
    t0 = time.time()
    with open(f"{out}/acc.txt", "w") as log:
        rc = subprocess.call([sys.executable, "-m", "dad3dheads_tpu_torch.cli.acceptance", "--work", WORK,
                              "--train-num", "512", "--val-num", "32", "--epochs", "40", "--img", str(IMG), "--batch",
                              "32", "--device-preprocess", "--int8", "--calib-num", "32"], stdout=log,
                             stderr=subprocess.STDOUT)
    print("acceptance rc", rc, time.time() - t0, flush=True)
    shutil.copy(f"{WORK}/acceptance.json", out)
    shutil.copy(f"{WORK}/amax.npz", out)

    ck = f"{WORK}/exp/checkpoints/dad_3dnet.msgpack"
    counts = {"rounded": 0, "exact": 0}
    rpath = os.path.join(WORK, "ck_bf16.msgpack")
    weights.save_flax_msgpack(_round_tree(weights.load_flax_msgpack(ck), counts), rpath)
    with open(rpath, "rb") as f, lzma.open(f"{out}/ck_bf16.msgpack.xz", "wb", preset=1) as g:
        g.write(f.read())
    print(counts, "xz MiB", os.path.getsize(f"{out}/ck_bf16.msgpack.xz") / 2**20, flush=True)

    amax_r = f"{out}/amax_rounded.npz"
    calibrate_int8(["--checkpoint", rpath, "--out", amax_r, "--images", f"{WORK}/DAD-3DHeadsDataset/val/images",
                    "--num", "32", "--batch", "16", "--img-size", str(IMG), "--dtype", "fp32", "--device", "cuda"])
    gt = [g for g in glob.glob(f"{WORK}/gt/*.json") if "val" in os.path.basename(g)][0]
    legs = {}
    for tag, path, amax in (("rounded_fp32", rpath, None), ("rounded_int8", rpath, amax_r),
                            ("exact_fp32", ck, None), ("exact_int8", ck, f"{WORK}/amax.npz")):
        r = evaluate_checkpoint(WORK, IMG, path, gt, tag, "cuda", quant_amax=amax)
        np.save(f"{out}/{tag}_3dmm.npy", r.pop("_3dmm"))
        legs[tag] = r
    with open(f"{out}/rounded_legs.json", "w") as f:
        json.dump(legs, f, indent=1)
    os.makedirs(f"{out}/val/images")
    shutil.copy(f"{WORK}/DAD-3DHeadsDataset/val/val.json", f"{out}/val/")
    for f in os.listdir(f"{WORK}/DAD-3DHeadsDataset/val/images"):
        shutil.copy(f"{WORK}/DAD-3DHeadsDataset/val/images/{f}", f"{out}/val/images/")
    shutil.copy(gt, f"{out}/ground_truth_val.json")
    print(json.dumps(legs), "MiB out", _du(out) / 2**20, flush=True)


def score(predictor, work: str, gt_path: str, tag: str):
    """``cli.acceptance.evaluate_checkpoint``'s host-crop leg for any
    predictor with the ``__call__`` contract, scored by the port's
    evaluator on the CPU: (overall metrics, network-frame 3DMM)."""
    from dad3dheads_tpu_torch.benchmark_harness import DADEvaluator
    from dad3dheads_tpu_torch.benchmark_harness.submission import predictions_to_submission_entry
    from dad3dheads_tpu_torch.cli.acceptance import head_crop
    from dad3dheads_tpu_torch.core.landmarks import LandmarkEmbedding
    from dad3dheads_tpu_torch.data.io import read_as_rgb
    from dad3dheads_tpu_torch.ops.preprocess import preprocess_image_np

    emb = LandmarkEmbedding.load()
    base = os.path.join(work, "DAD-3DHeadsDataset", "val")
    with open(os.path.join(base, "val.json")) as f:
        items = json.load(f)
    images = [read_as_rgb(os.path.join(base, el["img_path"])) for el in items]
    boxes = [head_crop(image, el["bbox"]) for image, el in zip(images, items)]
    submission = {}
    for el, image, (x, y, w, h) in zip(items, images, boxes):
        preds = {k: np.asarray(v) for k, v in predictor(image[y : y + h, x : x + w]).items()}
        preds["projected_vertices"] = preds["projected_vertices"] + np.asarray([x, y], np.float32)
        submission[el["item_id"]] = predictions_to_submission_entry(preds, emb)
    sub_path = os.path.join(work, f"submission_{tag}.json")
    with open(sub_path, "w") as f:
        json.dump(submission, f)
    overall, _ = DADEvaluator(gt_path, sub_path, device="cpu")()
    crops = np.stack([preprocess_image_np(image[y : y + h, x : x + w], IMG, normalize="none")[0]
                      for image, (x, y, w, h) in zip(images, boxes)])
    return overall, np.asarray(predictor.predict_batch(crops)["3dmm_params"])


def cpu(src: str, work: str) -> dict:
    """Both packages' fp32 and int8 legs on the rounded checkpoint, on the
    card's amax table and on each package's own CPU calibration."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from dad3dheads_tpu.api.predictor import FaceMeshPredictor as JaxPredictor
    from dad3dheads_tpu.models.quantized import calibrate as jax_calibrate
    from dad3dheads_tpu.models.quantized import save_amax as jax_save_amax
    from dad3dheads_tpu_torch.api.predictor import FaceMeshPredictor
    from dad3dheads_tpu_torch.cli.acceptance import predictor_config
    from dad3dheads_tpu_torch.cli.calibrate_int8 import main as calibrate_int8
    from dad3dheads_tpu_torch.data.io import read_as_rgb
    from dad3dheads_tpu_torch.ops.preprocess import preprocess_image_np

    torch.set_num_threads(4)
    os.makedirs(f"{work}/DAD-3DHeadsDataset", exist_ok=True)
    if not os.path.isdir(f"{work}/DAD-3DHeadsDataset/val"):
        shutil.copytree(f"{src}/val", f"{work}/DAD-3DHeadsDataset/val")
    gt = f"{src}/ground_truth_val.json"
    ck = f"{work}/ck_bf16.msgpack"
    with lzma.open(f"{src}/ck_bf16.msgpack.xz") as f, open(ck, "wb") as g:
        g.write(f.read())
    card_amax = f"{src}/amax_rounded.npz"

    port_amax = calibrate_int8(["--checkpoint", ck, "--out", f"{work}/amax_port_cpu.npz", "--images",
                                f"{work}/DAD-3DHeadsDataset/val/images", "--num", "32", "--batch", "16", "--img-size",
                                str(IMG), "--dtype", "fp32", "--device", "cpu"])
    jp = JaxPredictor(predictor_config(IMG), checkpoint_path=ck)
    paths = sorted(glob.glob(f"{work}/DAD-3DHeadsDataset/val/images/*.png"))[:32]
    x = np.stack([preprocess_image_np(read_as_rgb(p), IMG)[0] for p in paths])
    jax_amax = jax_save_amax(jax_calibrate(jp.model, jp.variables, [jnp.asarray(x[i : i + 16]) for i in (0, 16)],
                                           dtype=jnp.float32), f"{work}/amax_jax_cpu.npz")

    card_3dmm = np.load(f"{src}/rounded_int8_3dmm.npy")
    result = {}
    for tag, make, amax in (
        ("port_fp32", FaceMeshPredictor, None),
        ("jax_fp32", JaxPredictor, None),
        ("port_int8_card_amax", FaceMeshPredictor, card_amax),
        ("jax_int8_card_amax", JaxPredictor, card_amax),
        ("port_int8_own_cpu_amax", FaceMeshPredictor, port_amax),
        ("jax_int8_own_cpu_amax", JaxPredictor, jax_amax),
    ):
        kw = {"device": "cpu"} if make is FaceMeshPredictor else {}
        predictor = make(predictor_config(IMG, quant_amax=amax), checkpoint_path=ck, **kw)
        overall, mm = score(predictor, work, gt, tag)
        overall["3dmm_max_abs_gap_to_card_port_int8"] = float(np.abs(mm - card_3dmm).max())
        result[tag] = overall
        print(tag, json.dumps(overall), flush=True)
    with open(f"{work}/witness.json", "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mode", choices=["card", "cpu"])
    ap.add_argument("--out", default=os.path.join(REPO, "experiments", "int8_witness_card"),
                    help="where the card mode writes its files (default git-ignored)")
    ap.add_argument("--from", dest="src", default=os.path.join(REPO, "experiments", "int8_witness_card"),
                    help="the card mode's files (cpu mode)")
    ap.add_argument("--work", default="experiments/int8_witness", help="working directory (cpu mode)")
    args = ap.parse_args(argv)
    if args.mode == "card":
        sys.path.insert(0, REPO)
        card(args.out)
    else:
        cpu(args.src, args.work)


if __name__ == "__main__":
    main()
