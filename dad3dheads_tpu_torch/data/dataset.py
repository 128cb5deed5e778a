"""FlameDataset: the DAD-3DHeads annotation format -> fixed-shape numpy
batches. Port of ``dad3dheads_tpu/data/dataset.py``; the per-item work is
host numpy and cv2, copied from the JAX package so that both give the same
items from the same files.

Per item: read RGB, jitter and clamp the bbox (each side grows U(0.05,
0.15), from a generator seeded with (seed, idx)), crop; load the GT mesh
json (vertices + model_view_matrix -> homogeneous world vertices,
projection_matrix; cached in a ``.cache.npy`` sidecar); project the 68
barycentric landmarks (or a keypoint index subset) and all vertices to crop
space with a y-flip; resize/pad (and normalize, unless ``output_uint8``);
presence = the in-crop test; uint8 Gaussian heatmaps (unless
``device_heatmap``: the train step encodes them on the device); landmarks
normalized to [0, 1]. Failed samples are replaced in ``collate`` by
duplicates of good ones.

:class:`DataLoader` yields the JAX loader's batches in its order: the
permutation of ``np.random.default_rng(seed)``, the interleaved slice
``order[rank::count]`` and ``drop_last``. Rank and count come from
``torch.distributed`` when it is initialised, else 0 and 1.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import weakref
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from .. import assets
from ..constants import (
    IMAGE_FILENAME_KEY,
    INPUT_BBOX_KEY,
    INPUT_IMAGE_KEY,
    SAMPLE_INDEX_KEY,
    TARGET_2D_FULL_LANDMARKS,
    TARGET_2D_LANDMARKS,
    TARGET_2D_LANDMARKS_PRESENCE,
    TARGET_3D_MODEL_VERTICES,
    TARGET_LANDMARKS_HEATMAP,
)
from ..ops.preprocess import preprocess_image_np, transform_keypoints_np
from .bbox import random_extended_bbox
from .io import read_as_rgb

logger = logging.getLogger(__name__)


class HeatmapCoder:
    """Host per-sample Gaussian heatmap encoder (the train step's device
    encoder, ``ops.heatmap.encode_heatmap``, gives the same values)."""

    def __init__(self, img_size: int = 256, stride: int = 4, radius=5, num_classes: int = 68):
        self.img_size = img_size
        self.stride = stride
        self.num_classes = num_classes
        if radius == "pointwise":
            # a fixed 3x3 kernel
            self.radius = 1
            self._gaussian = np.asarray([[0.5, 0.75, 0.5], [0.75, 1.0, 0.75], [0.5, 0.75, 0.5]], np.float32)
        else:
            self.radius = int(radius)
            d = 2 * self.radius + 1
            sigma = d / 6.0
            ax = np.arange(-self.radius, self.radius + 1)
            xx, yy = np.meshgrid(ax, ax)
            g = np.exp(-(xx * xx + yy * yy) / (2 * sigma * sigma)).astype(np.float32)
            g[g < np.finfo(np.float32).eps * g.max()] = 0
            self._gaussian = g

    def __call__(self, keypoints: np.ndarray, presence: np.ndarray) -> np.ndarray:
        size = self.img_size // self.stride
        hm = np.zeros((self.num_classes, size, size), np.float32)
        r = self.radius
        for i, kp in enumerate(keypoints):
            if not presence[i]:
                continue
            x, y = int(kp[0] // self.stride), int(kp[1] // self.stride)
            if x < 0 or y < 0 or x >= size or y >= size:
                continue
            l, rr = min(x, r), min(size - x, r + 1)
            t, b = min(y, r), min(size - y, r + 1)
            patch = self._gaussian[r - t : r + b, r - l : r + rr]
            window = hm[i, y - t : y + b, x - l : x + rr]
            np.maximum(window, patch, out=window)
        return np.uint8(255.0 * hm)


class FlameDataset:
    """data: list of {img_path, annotation_path, bbox}; config: the dataset
    dict (dataset_root, img_size, stride, num_classes, keypoints, transform,
    output_uint8, device_heatmap, radius, train_mode, seed)."""

    def __init__(self, data: List[Dict[str, Any]], config: Dict[str, Any]):
        self.data = data
        self.config = config
        self.root = config.get("dataset_root", ".")
        self.img_size = int(config.get("img_size", 256))
        self.stride = int(config.get("stride", 4))
        self.num_classes = int(config.get("num_classes", 68))
        transform = config.get("transform", {}) or {}
        self.normalize = transform.get("normalize", "imagenet")
        # 'longest_max_size' (aspect + pad) or plain 'resize'
        self.resize_mode = transform.get("resize_mode", "longest_max_size")
        # uint8 images: the train step normalizes them on the device
        self.output_uint8 = bool(config.get("output_uint8", False))
        # no heatmap in the sample: the train step encodes it on the device
        self.device_heatmap = bool(config.get("device_heatmap", False))
        kp_cfg = config.get("keypoints", {}) or {}
        subset_name = kp_cfg.get("2d_subset_name", "multipie_keypoints")
        # the 68 barycentric landmarks, or a vertex index subset
        self.keypoint_indices = (
            None if subset_name == "multipie_keypoints" else assets.load_keypoint_subset(subset_name)
        )
        self.coder = HeatmapCoder(self.img_size, self.stride, radius=config.get("radius", 5),
                                  num_classes=self.num_classes)
        self.train_mode = bool(config.get("train_mode", True))
        self._seed = int(config.get("seed", 0))
        emb = assets.load_landmark_embeddings()
        faces = assets.get_faces()
        self._static_vids = faces[emb["static_lmk_face_idx"]]
        self._static_bary = emb["static_lmk_b_coords"]
        self._dyn_vids = faces[emb["dynamic_lmk_face_idx"][0]]
        self._dyn_bary = emb["dynamic_lmk_b_coords"][0]

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> "FlameDataset":
        with open(config["ann_path"]) as f:
            anno = json.load(f)
        return cls(data=anno, config=config)

    def __len__(self) -> int:
        return len(self.data)

    def _landmarks68_host(self, vertices: np.ndarray) -> np.ndarray:
        """(V, 3) -> (68, 3): the zero-pose contour, then the static points."""
        stat = np.einsum("kic,ki->kc", vertices[self._static_vids], self._static_bary)
        dyn = np.einsum("kic,ki->kc", vertices[self._dyn_vids], self._dyn_bary)
        return np.concatenate([dyn, stat], axis=0)

    @staticmethod
    def _load_mesh(path: str):
        """(v3d, world_homo, proj) of one annotation json. Parsing the json
        is most of an item's cost, so the arrays are cached in one raw
        ``<path>.cache.npy`` beside it (rows 0..V-1: [v3d | world_homo], then
        a (3, 7) tail whose first 16 values are the projection matrix),
        written atomically; a stale, absent or corrupt cache is reparsed."""
        cache = path + ".cache.npy"
        try:
            if os.path.getmtime(cache) >= os.path.getmtime(path):
                a = np.load(cache)
                V = a.shape[0] - 3
                return a[:V, :3], a[:V, 3:7], a[V:].ravel()[:16].reshape(4, 4)
        except (OSError, ValueError):
            pass
        with open(path) as f:
            data = json.load(f)
        v3d = np.asarray(data["vertices"], np.float32)
        mv = np.asarray(data["model_view_matrix"], np.float32)
        homo = np.concatenate([v3d, np.ones_like(v3d[:, :1])], -1)
        world_homo = (homo @ mv.T).astype(np.float32)
        proj = np.asarray(data["projection_matrix"], np.float32)
        try:
            packed = np.concatenate([v3d, world_homo], axis=1)  # (V, 7)
            tail = np.zeros((3, 7), np.float32)
            tail.ravel()[:16] = proj.ravel()
            packed = np.concatenate([packed, tail], axis=0)
            tmp = cache + f".tmp{os.getpid()}-{threading.get_ident()}"
            with open(tmp, "wb") as f:
                np.save(f, packed)
            os.replace(tmp, cache)
        except OSError:
            pass  # a read-only dataset directory: no cache
        return v3d, world_homo, proj

    @staticmethod
    def _project(world_homo: np.ndarray, proj: np.ndarray, height: float, cx: float, cy: float):
        p = world_homo @ proj.T
        xy = p[:, :2] / p[:, 3:4]
        xy = np.stack([xy[:, 0], height - xy[:, 1]], -1)
        return xy - np.asarray([cx, cy], np.float32)

    def __getitem__(self, idx: int) -> Optional[Dict[str, Any]]:
        try:
            item = self.data[idx]
            img = read_as_rgb(os.path.join(self.root, item["img_path"]))
            # one generator per (seed, idx): deterministic on any worker
            rng = np.random.default_rng((self._seed, idx))
            bbox = random_extended_bbox(item["bbox"], img.shape[:2], rng)
            x, y, w, h = bbox
            crop = img[y : y + h, x : x + w]
            if crop.size == 0:
                return None

            v3d, world_homo, proj = self._load_mesh(os.path.join(self.root, item["annotation_path"]))
            height = img.shape[0]
            if self.keypoint_indices is None:
                lm3 = self._landmarks68_host(world_homo[:, :3])
                lm3h = np.concatenate([lm3, np.ones_like(lm3[:, :1])], -1)
            else:
                lm3h = world_homo[self.keypoint_indices]
            lms_2d = self._project(lm3h, proj, height, x, y)
            full_2d = self._project(world_homo, proj, height, x, y)
            presence = (lms_2d[:, 0] > 0) & (lms_2d[:, 0] < w) & (lms_2d[:, 1] > 0) & (lms_2d[:, 1] < h)

            norm = "none" if self.output_uint8 else self.normalize
            tensor, scale, pads = preprocess_image_np(crop, self.img_size, norm, mode=self.resize_mode)
            if self.output_uint8 and tensor.dtype != np.uint8:
                tensor = np.clip(tensor * 255.0 + 0.5, 0, 255).astype(np.uint8)
            lms_t = transform_keypoints_np(lms_2d, scale, pads)
            full_t = transform_keypoints_np(full_2d, scale, pads)

            sample = {
                SAMPLE_INDEX_KEY: idx,
                IMAGE_FILENAME_KEY: item["img_path"],
                INPUT_IMAGE_KEY: tensor,
                INPUT_BBOX_KEY: np.asarray(bbox, np.float32),
                TARGET_3D_MODEL_VERTICES: v3d,
                TARGET_2D_LANDMARKS: (lms_t / self.img_size).astype(np.float32),
                TARGET_2D_FULL_LANDMARKS: full_t.astype(np.float32),
                TARGET_2D_LANDMARKS_PRESENCE: presence,
            }
            if not self.device_heatmap:
                heatmap = self.coder(lms_t, presence)  # (C, S, S) uint8
                sample[TARGET_LANDMARKS_HEATMAP] = np.transpose(heatmap, (1, 2, 0))
            return sample
        except (OSError, KeyError, ValueError, json.JSONDecodeError):
            return None


def collate(samples: List[Optional[Dict[str, Any]]]) -> Dict[str, Any]:
    """Stack samples; None entries are replaced by duplicating good ones.
    Arrays are stacked, other values (indices, file names) listed."""
    good = [s for s in samples if s is not None]
    if not good:
        raise RuntimeError("all samples in batch failed to load")
    n_good = len(good)
    while len(good) < len(samples):
        good.append(good[(len(good) - n_good) % n_good])
    out: Dict[str, Any] = {}
    for k in good[0]:
        vals = [s[k] for s in good]
        out[k] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
    return out


def distributed_rank_and_count() -> tuple:
    """(rank, world size) of ``torch.distributed`` when it is initialised,
    else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class _EpochBatches:
    """The batch sampler of the process mode: each pass is one epoch of the
    loader's batches, drawn in the main process when the pass starts (torch
    makes and drops an iterator it never reads when it starts its workers)."""

    def __init__(self, loader: "DataLoader"):
        # a weak reference: the loader owns the torch loader that owns this
        # sampler, and a cycle would keep the workers alive until the cyclic
        # garbage collector runs
        self.loader = weakref.ref(loader)

    def __iter__(self):
        yield from self.loader().epoch_batches()

    def __len__(self) -> int:
        return len(self.loader())


class DataLoader:
    """Prefetching loader of numpy batches with thread or process workers
    (``worker_mode``).

    - ``"thread"`` (default): no IPC; the worker count is clamped to the CPU
      count, with a warning, since the GIL serializes the numpy sections.
    - ``"process"``: ``torch.utils.data.DataLoader`` with persistent worker
      processes of the ``spawn`` context (forking a parent that holds a CUDA
      context is unsafe), fed by a batch sampler that gives the thread
      mode's batches in the same order; each worker collates whole batches.

    Several processes: give each the same ``seed``. Every process draws the
    same permutation, takes the interleaved slice ``order[rank::count]`` and
    yields local batches of ``batch_size // count``; the per-epoch batch
    count comes from ``len(dataset) // count``, so that every process yields
    the same number of batches."""

    def __init__(
        self,
        dataset: FlameDataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 8,
        prefetch: int = 4,
        seed: int = 0,
        drop_last: bool = True,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        worker_mode: str = "thread",
    ):
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode must be 'thread' or 'process', got {worker_mode!r}")
        if process_index is None or process_count is None:
            rank, count = distributed_rank_and_count()
            process_index = rank if process_index is None else process_index
            process_count = count if process_count is None else process_count
        if batch_size % process_count != 0:
            raise ValueError(f"global batch size {batch_size} must be divisible by process_count {process_count}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.local_batch_size = batch_size // process_count
        self.process_index = process_index
        self.process_count = process_count
        self.shuffle = shuffle
        self.worker_mode = worker_mode
        if worker_mode == "thread":
            cpus = os.cpu_count() or num_workers
            if num_workers > cpus:
                logger.warning("DataLoader: %d thread workers clamped to the %d CPUs (the GIL serializes the "
                               "rest); worker_mode='process' is not clamped", num_workers, cpus)
                num_workers = cpus
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)
        self._torch_loader = None

    def set_batch_size(self, batch_size: int) -> None:
        """Rebind the global batch size; takes effect next epoch."""
        if batch_size % self.process_count != 0:
            raise ValueError(
                f"global batch size {batch_size} must be divisible by process_count {self.process_count}"
            )
        self.batch_size = batch_size
        self.local_batch_size = batch_size // self.process_count

    def __len__(self) -> int:
        n = len(self.dataset) // self.process_count
        b = self.local_batch_size
        return n // b if self.drop_last else (n + b - 1) // b

    def epoch_batches(self) -> List[np.ndarray]:
        """One epoch's batches of sample indices (draws the permutation)."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        n_local = len(order) // self.process_count
        local_order = order[self.process_index :: self.process_count][:n_local]
        bs = self.local_batch_size
        batches = [local_order[i : i + bs] for i in range(0, len(local_order), bs)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == bs]
        return batches

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self.worker_mode == "process":
            yield from self._iter_processes()
            return
        batches = self.epoch_batches()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            # a bounded put that re-checks the stop flag, so that an abandoned
            # iterator cannot wedge the worker on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            from concurrent.futures import ThreadPoolExecutor

            try:
                with ThreadPoolExecutor(self.num_workers) as ex:
                    for b in batches:
                        if stop.is_set():
                            return
                        if not put_or_stop(collate(list(ex.map(self.dataset.__getitem__, b)))):
                            return
            except BaseException as e:  # noqa: BLE001 — relayed to the consumer
                # a crash surfaces in the training loop rather than ending the
                # epoch early
                put_or_stop(e)
                return
            finally:
                put_or_stop(None)

        threading.Thread(target=worker, daemon=True).start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()

    def _iter_processes(self) -> Iterator[Dict[str, Any]]:
        import torch.utils.data

        if self._torch_loader is None:
            self._torch_loader = torch.utils.data.DataLoader(
                self.dataset,
                batch_sampler=_EpochBatches(self),
                num_workers=self.num_workers,
                collate_fn=collate,
                multiprocessing_context="spawn",
                persistent_workers=True,
                prefetch_factor=max(1, self.prefetch),
            )
        yield from self._torch_loader

    def close(self) -> None:
        """Stop the process mode's worker processes (they also stop when the
        loader is dropped); the next epoch starts new ones."""
        it = getattr(self._torch_loader, "_iterator", None)
        if it is not None:
            it._shutdown_workers()
        self._torch_loader = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass
