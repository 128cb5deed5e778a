"""The acceptance workflow on rendered data, end to end through the port.
The port's copy of ``tools/acceptance_run.py``:

  1. render train and val datasets (``cli.make_dataset``);
  2. score the untrained network (random weights from seed 0);
  3. train DAD-3DNet through the data pipeline (``cli.train``, the JAX
     tool's overrides: bf16 trunk, uint8 batches, device heatmaps);
  4. predict the val set and score it with the DAD-3DHeads evaluator:
     through host crops (``predictor(crop)``), and with
     ``--device-preprocess`` also through ``predict_frames`` (crop, resize
     and normalize on the device); then the host-crop leg with a bf16 trunk,
     and the largest gap of its 3DMM to the fp32 trunk's;
  5. with ``--int8``, the int8 leg of ``tools/acceptance_extra_legs.py``:
     ``cli.calibrate_int8`` on the first ``--calib-num`` val images (fp32,
     the dtype the legs serve), then the val set scored through
     ``quant_amax`` (host crops, and with ``--device-preprocess`` also
     ``predict_frames``), and the largest gap of its 3DMM to the fp32 leg's.

Like the JAX tool, it renders train and val from the same seed, so the val
images are the first train images; it also renders as many held-out images
from another seed and scores the trained network on them. Each stage's
wall time is printed, and the last line is one JSON object with every
leg's metrics (also written to ``<work>/acceptance.json``).

  python -m dad3dheads_tpu_torch.cli.acceptance --work /tmp/acc \\
      --train-num 512 --val-num 32 --epochs 40 --img 128 --batch 32 \\
      --device-preprocess [--int8 --calib-num 32] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def sh(*cmd: str) -> None:
    print("+", " ".join(cmd), flush=True)
    subprocess.run(cmd, check=True)


def predictor_config(img: int, dtype: str = "float32", quant_amax: Optional[str] = None) -> Dict[str, Any]:
    return {
        "img_size": img,
        "stride": 4,
        "model": {"backbone": "resnet50", "num_classes": 68, "num_filters": 256, "limit_value": 3, "dtype": dtype},
        "quant_amax": quant_amax,
    }


def head_crop(image: np.ndarray, bbox) -> tuple:
    """The annotated head box grown by 10% per side and clamped: (x, y, w,
    h); the whole image where that leaves 4 pixels or fewer a side."""
    from ..data.bbox import ensure_bbox_boundaries, extend_bbox

    x, y, w, h = (int(v) for v in ensure_bbox_boundaries(extend_bbox(np.asarray(bbox), 0.1), image.shape[:2]))
    if not (w > 4 and h > 4):
        return 0, 0, image.shape[1], image.shape[0]
    return x, y, w, h


def evaluate_checkpoint(
    work: str,
    img: int,
    ckpt_path: Optional[str],
    gt_path: str,
    tag: str,
    device: str = "cuda",
    device_preprocess: bool = False,
    dtype: str = "float32",
    subset: str = "val",
    quant_amax: Optional[str] = None,
) -> Dict[str, Any]:
    """Predict ``subset`` with the checkpoint (random weights when None;
    int8 with an amax file), write a submission and score it; returns the
    overall metrics, plus the network-frame 3DMM of the host crops under
    "_3dmm"."""
    from ..api.predictor import FaceMeshPredictor
    from ..benchmark_harness import DADEvaluator
    from ..benchmark_harness.submission import predictions_to_submission_entry
    from ..core.landmarks import LandmarkEmbedding
    from ..data.io import read_as_rgb
    from ..ops.preprocess import preprocess_image_np

    predictor = FaceMeshPredictor(predictor_config(img, dtype, quant_amax), checkpoint_path=ckpt_path, device=device)
    emb = LandmarkEmbedding.load()
    base = os.path.join(work, "DAD-3DHeadsDataset", subset)
    with open(os.path.join(base, f"{subset}.json")) as f:
        items = json.load(f)
    images = [read_as_rgb(os.path.join(base, el["img_path"])) for el in items]
    boxes = [head_crop(image, el["bbox"]) for image, el in zip(images, items)]

    submission = {}
    if device_preprocess:
        # crop, resize and normalize on the device; the points come back in
        # the frame, and the projected vertices are moved there as the host
        # path moves them
        preds_list = predictor.predict_frames(
            images, bboxes=[(x, y, x + w, y + h) for x, y, w, h in boxes], batch_size=16
        )
        for el, preds, (x, y, _, _) in zip(items, preds_list, boxes):
            preds["projected_vertices"] = preds["projected_vertices"] + np.asarray([x, y], np.float32)
            submission[el["item_id"]] = predictions_to_submission_entry(preds, emb)
    else:
        for el, image, (x, y, w, h) in zip(items, images, boxes):
            preds = predictor(image[y : y + h, x : x + w])
            preds["projected_vertices"] = preds["projected_vertices"] + np.asarray([x, y], np.float32)
            preds["points"] = preds["points"] + np.asarray([x, y])
            submission[el["item_id"]] = predictions_to_submission_entry(preds, emb)
    sub_path = os.path.join(work, f"submission_{tag}.json")
    with open(sub_path, "w") as f:
        json.dump(submission, f)

    overall, _ = DADEvaluator(gt_path, sub_path, device=device)()
    print(f"[{tag}] " + "  ".join(f"{k}={v:.4f}" for k, v in overall.items()), flush=True)
    crops = np.stack([
        preprocess_image_np(image[y : y + h, x : x + w], img, normalize="none")[0]
        for image, (x, y, w, h) in zip(images, boxes)
    ])
    return {**overall, "_3dmm": predictor.predict_batch(crops)["3dmm_params"]}


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--work", default="acceptance")
    ap.add_argument("--train-num", type=int, default=256)
    ap.add_argument("--val-num", type=int, default=32)
    ap.add_argument("--img", type=int, default=128)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--skip-generate", action="store_true")
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--device-preprocess", action="store_true",
                    help="also serve the val set through predict_frames (crop/resize/normalize on the device)")
    ap.add_argument("--int8", action="store_true", help="also calibrate and score the int8 path (quant_amax)")
    ap.add_argument("--calib-num", type=int, default=32, help="val images the int8 calibration reads")
    args = ap.parse_args(argv)

    from ..benchmark_harness import generate_gt

    py, dev, work = sys.executable, args.device, args.work
    seconds: Dict[str, float] = {}

    def stage(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        seconds[name] = time.perf_counter() - t0
        print(f"[stage] {name}: {seconds[name]:.1f} s", flush=True)
        return out

    # (subset, images, seed): val repeats the first train images, as the JAX tool's does
    subsets = [("train", args.train_num, 0), ("val", args.val_num, 0), ("heldout", args.val_num, 1)]
    if not args.skip_generate:
        for subset, num, seed in subsets:
            stage(f"render_{subset}", sh, py, "-m", "dad3dheads_tpu_torch.cli.make_dataset", "--out", work,
                  "--subset", subset, "--num", str(num), "--img-size", str(args.img), "--seed", str(seed),
                  "--device", dev)
    gt_dir = os.path.join(work, "gt")
    gt_paths = {subset: generate_gt(work, subset, output_dir=gt_dir) for subset, _, _ in subsets[1:]}

    exp_dir = os.path.join(work, "exp")
    base_t = os.path.join(work, "DAD-3DHeadsDataset", "train")
    base_v = os.path.join(work, "DAD-3DHeadsDataset", "val")
    legs: Dict[str, Dict[str, Any]] = {}
    legs["untrained"] = stage("score_untrained", evaluate_checkpoint, work, args.img, None, gt_paths["val"],
                              "untrained", dev)

    if not args.skip_train:
        stage(
            "train", sh, py, "-m", "dad3dheads_tpu_torch.cli.train",
            "--config", os.path.join(REPO, "configs", "train.yaml"), "--device", dev,
            f"experiment_dir={exp_dir}", f"batch_size={args.batch}", f"img_size={args.img}",
            f"max_epochs={args.epochs}", "min_epochs=0", "early_stopping=null", "model.dtype=bf16",
            "scheduler.warmup_steps=50", "num_workers=8",
            f"train.ann_path={base_t}/train.json", f"train.dataset_root={base_t}", f"train.img_size={args.img}",
            "train.output_uint8=true", f"val.ann_path={base_v}/val.json", f"val.dataset_root={base_v}",
            f"val.img_size={args.img}", "val.output_uint8=true",
        )
    ckpt = os.path.join(exp_dir, "checkpoints", "dad_3dnet.msgpack")
    legs["trained_host_preprocess"] = stage("score_host", evaluate_checkpoint, work, args.img, ckpt,
                                            gt_paths["val"], "trained", dev)
    if args.device_preprocess:
        legs["trained_device_preprocess"] = stage("score_device", evaluate_checkpoint, work, args.img, ckpt,
                                                  gt_paths["val"], "trained_device", dev, device_preprocess=True)
    legs["trained_bf16_host_preprocess"] = stage("score_bf16", evaluate_checkpoint, work, args.img, ckpt,
                                                 gt_paths["val"], "trained_bf16", dev, dtype="bfloat16")
    legs["trained_heldout_host_preprocess"] = stage("score_heldout", evaluate_checkpoint, work, args.img, ckpt,
                                                    gt_paths["heldout"], "trained_heldout", dev, subset="heldout")
    if args.int8:
        amax = os.path.join(work, "amax.npz")
        from .calibrate_int8 import main as calibrate_int8

        stage("calibrate_int8", calibrate_int8, ["--checkpoint", ckpt, "--out", amax, "--images",
                                                 os.path.join(base_v, "images"), "--num", str(args.calib_num),
                                                 "--batch", "16", "--img-size", str(args.img), "--dtype", "fp32",
                                                 "--device", dev])
        legs["trained_int8_host_preprocess"] = stage("score_int8", evaluate_checkpoint, work, args.img, ckpt,
                                                     gt_paths["val"], "trained_int8", dev, quant_amax=amax)
        if args.device_preprocess:
            legs["trained_int8_device_preprocess"] = stage(
                "score_int8_device", evaluate_checkpoint, work, args.img, ckpt, gt_paths["val"],
                "trained_int8_device", dev, device_preprocess=True, quant_amax=amax)

    result: Dict[str, Any] = {k: {m: v for m, v in leg.items() if not m.startswith("_")} for k, leg in legs.items()}
    gap = np.abs(legs["trained_bf16_host_preprocess"]["_3dmm"] - legs["trained_host_preprocess"]["_3dmm"])
    result["bf16_3dmm_max_abs_gap"] = float(gap.max())
    if args.int8:
        gap = np.abs(legs["trained_int8_host_preprocess"]["_3dmm"] - legs["trained_host_preprocess"]["_3dmm"])
        result["int8_3dmm_max_abs_gap"] = float(gap.max())
    result["seconds"] = seconds
    result["settings"] = {k: getattr(args, k) for k in ("train_num", "val_num", "img", "batch", "epochs", "device",
                                                        "int8", "calib_num")}
    with open(os.path.join(work, "acceptance.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
