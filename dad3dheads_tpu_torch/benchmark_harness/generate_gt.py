"""Fold per-image DAD-3DHeads annotations into one ground-truth json. The
port's copy of ``dad3dheads_tpu/benchmark_harness/generate_gt.py``: reads
{base}/DAD-3DHeadsDataset/{subset}/{subset}.json, joins each item with its
annotation json and image height, optionally its attributes, and writes
{output_dir}/ground_truth_{subset}[_with_attributes].json."""

from __future__ import annotations

import argparse
import json
import os


def _image_height(path: str) -> int:
    import cv2

    img = cv2.imread(path)
    if img is None:
        from PIL import Image

        with Image.open(path) as im:
            return im.height
    return img.shape[0]


def generate_gt(base_path: str, subset_name: str = "val", with_attributes: bool = False,
                output_dir: str = "data") -> str:
    assert not (subset_name == "val" and with_attributes), f"Attributes not supported for subset '{subset_name}'"
    root = f"{base_path}/DAD-3DHeadsDataset/{subset_name}"
    with open(f"{root}/{subset_name}.json") as f:
        subset_anno = json.load(f)

    subset_json = []
    for el in subset_anno:
        item_id = el["item_id"]
        with open(f"{root}/annotations/{item_id}.json") as f:
            anno = json.load(f)
        el_dict = {
            "id": item_id,
            "bbox": el["bbox"],
            "vertices": anno["vertices"],
            "model_view_matrix": anno["model_view_matrix"],
            "projection_matrix": anno["projection_matrix"],
            "image_height": _image_height(f"{root}/images/{item_id}.png"),
        }
        if with_attributes:
            el_dict["attributes"] = el["attributes"]
        subset_json.append(el_dict)

    os.makedirs(output_dir, exist_ok=True)
    suffix = "_with_attributes" if with_attributes else ""
    out = os.path.join(output_dir, f"ground_truth_{subset_name}{suffix}.json")
    with open(out, "w") as f:
        json.dump(subset_json, f)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--base-path", required=True)
    ap.add_argument("--subset", default="val")
    ap.add_argument("--with-attributes", action="store_true")
    ap.add_argument("--output-dir", default="data")
    args = ap.parse_args(argv)
    print(generate_gt(args.base_path, args.subset, args.with_attributes, args.output_dir))


if __name__ == "__main__":
    main()
