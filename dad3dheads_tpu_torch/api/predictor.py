"""FaceMeshPredictor: images -> 68 landmarks + FLAME mesh + 3DMM params.
Port of ``dad3dheads_tpu/api/predictor.py``.

Three bulk entries, each with the JAX predictor's keys, shapes and dtypes:

- ``predict_frames``: full frames + face boxes. The host only pastes the
  frames into one padded uint8 buffer; crop, resize and normalize run on the
  device in the resample kernel, then DAD-3DNet, the landmark/3DMM decode and
  the FLAME decode (the blendshape kernel). The deployment path.
- ``predict_images``: images of any size, resized on host threads with cv2
  (or one tensor of network-size images already on the device), normalized by
  the normalize kernel.
- ``predict_batch``: pre-sized square uint8 batches, network-frame outputs.

``__call__`` serves one image of any size. The bulk entries keep two batches
in flight: the next batch is queued on the card before the previous one's
results are copied back and readjusted on the host.

The model config's ``backbone`` (resnet50, the default, or mobilenet_w1)
selects the network. Weights come from a JAX-package ``.msgpack`` checkpoint
of that backbone (another backbone's is refused): the given path, else
``~/.dad3d_tpu_checkpoints/dad_3dnet.msgpack`` when it exists, else that
file downloaded from the config's ``model_url`` (``download_model``: urllib,
with retries), else random weights from a seeded ``torch.Generator`` (with a
warning, or an error with ``require_weights``). A given path that does not
exist raises and is never replaced by the cache or a download.

``mesh=`` (``parallel.make_mesh``) serves the bulk entries sharded over the
mesh's data rows, as the JAX predictor does over its mesh: each device call
pads its batch to a multiple of the rows, cuts it into one chunk per row,
runs each chunk on its device's copy of the network and FLAME (the
preprocess kernels, the network and the decode, each launch on that device;
the devices may repeat, as ``[cuda:0, cuda:0]``), and joins the results in
order on the mesh's first device, without the pad. ``__call__`` runs there.

int8 inference: a ``quant_amax`` config entry (an amax table from
``models.quantized.calibrate`` / ``cli.calibrate_int8``, as a dict or an
``.npz`` path, either package's) runs every entry point through the int8
mirror (``models/quantized.py``) in the model's dtype; the kernels are
folded and quantized once, at load. resnet50 only.

The FLAME decode runs with TF32 off (``precision.fp32_exact``), whatever the
caller's settings.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import contextlib
import logging
import os
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from ..constants import (
    FLAME_CONSTS,
    OUTPUT_2D_LANDMARKS,
    OUTPUT_3DMM_PARAMS,
    OUTPUT_LANDMARKS_HEATMAP,
)

from ..core.flame import FlameModel, FlameParams, flame_decode
from ..core.projection import weak_perspective_project
from ..core.rotation import rot_mat_from_6dof, rotate_vertices
from ..models import create_model
from ..models.quantized import amax_tensors, check_backbone, prepare_int8_params, quantized_forward
from ..ops.preprocess import (
    normalize_images,
    preprocess_image_np,
    readjust_3dmm_np,
    readjust_landmarks_np,
)
from ..ops.preprocess_device import pack_frames_host, preprocess_frames_device
from ..parallel import pad_batch_to_devices, replicate, shard_batch
from ..precision import fp32_exact
from ..weights import load_checkpoint

logger = logging.getLogger(__name__)

_CKPT_DIR = os.path.join(os.path.expanduser("~"), ".dad3d_tpu_checkpoints")
_CKPT_FILE = "dad_3dnet.msgpack"

DEFAULT_CONFIG: Dict[str, Any] = {
    "img_size": 256,
    "stride": 4,
    "constants": dict(FLAME_CONSTS),
    "model": {"backbone": "resnet50", "num_filters": 256, "num_classes": 68, "limit_value": 3},
}


def model_exists(filename: str = _CKPT_FILE) -> bool:
    return os.path.isfile(os.path.join(_CKPT_DIR, filename))


def download_model(url: str, retries: int = 5, filename: str = _CKPT_FILE) -> str:
    """Download a published checkpoint into the cache dir with ``retries``
    retries, backing off 1, 2, 4, ... (at most 30) seconds between them;
    returns its path."""
    import time
    import urllib.request

    if retries < 0:
        raise ValueError("Number of retries should be at least 0")
    os.makedirs(_CKPT_DIR, exist_ok=True)
    path = os.path.join(_CKPT_DIR, filename)
    last_err: Optional[Exception] = None
    for attempt in range(retries + 1):
        try:
            logger.info("downloading %s from %s (attempt %d)", path, url, attempt + 1)
            with urllib.request.urlopen(url) as r, open(path, "wb") as f:
                while True:
                    chunk = r.read(1 << 20)
                    if not chunk:
                        break
                    f.write(chunk)
            return path
        except Exception as e:  # noqa: BLE001 -- network errors are retryable
            last_err = e
            if attempt < retries:
                time.sleep(min(2**attempt, 30))
    raise RuntimeError(f"failed downloading {url}") from last_err


def decode_pipeline_outputs(out: Mapping[str, torch.Tensor], stride: int, img_size: int):
    """Model outputs -> {"landmarks" (B, 68, 2), "3dmm" (B, 413)} in the
    network frame: the regression head's normalized landmarks when present,
    else the heatmap argmax times the stride; clipped to [0, img_size]."""
    if OUTPUT_2D_LANDMARKS in out:
        landmarks = out[OUTPUT_2D_LANDMARKS] * float(img_size)
    else:
        heatmap = out[OUTPUT_LANDMARKS_HEATMAP]  # (B, H, W, C)
        B, H, W, C = heatmap.shape
        idx = torch.argmax(torch.sigmoid(heatmap).reshape(B, H * W, C), dim=1)
        landmarks = torch.stack([idx % W, idx // W], dim=-1).float() * stride
    return {
        "landmarks": torch.clamp(landmarks, 0, img_size),
        "3dmm": out[OUTPUT_3DMM_PARAMS],
    }


def decode_3dmm_to_mesh(flame: FlameModel, params_3dmm: torch.Tensor, consts, img_size: int):
    """3DMM params (B, P) -> (vertices_3d (B, V, 3), projected_2d (B, V, 2))."""
    params = FlameParams.from_3dmm(params_3dmm, dict(consts))
    v0 = flame_decode(flame, params, zero_rot=True)
    v = rotate_vertices(rot_mat_from_6dof(params.rotation), v0)
    proj = weak_perspective_project(v, params.scale, params.translation, img_size)
    return v, proj[..., :2]


def coerce_u8(x: torch.Tensor) -> torch.Tensor:
    """Float images in 0..255 -> uint8, rounded and clipped as the host path
    coerces them, so that they take the normalize kernel as uint8 does."""
    return torch.clamp(torch.round(x.float()), 0, 255).to(torch.uint8)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _join(parts: list, device: torch.device, n: int):
    """Per-chunk outputs (tensors, or tuples of them) joined along the batch
    on ``device`` and cut to ``n`` rows."""
    if isinstance(parts[0], tuple):
        return tuple(_join(list(column), device, n) for column in zip(*parts))
    return torch.cat([p.to(device) for p in parts])[:n]


class _Pending:
    """One batch queued on the device: its packed outputs, copied to the host
    without blocking, and the event that says the copy is done."""

    def __init__(self, packed: torch.Tensor, count: int, meta: Any):
        self.count, self.meta = count, meta
        if packed.device.type == "cuda":
            self.host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            self.host.copy_(packed, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = packed, None

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class FaceMeshPredictor:
    def __init__(
        self,
        config: Optional[Dict[str, Any]] = None,
        checkpoint_path: Optional[str] = None,
        flame_path: Optional[str] = None,
        device: Union[str, torch.device] = "cuda",
        seed: int = 0,
        require_weights: bool = False,
        mesh=None,
    ):
        """``checkpoint_path``: a JAX-package ``.msgpack`` predictor checkpoint,
        which must exist when given. Without one, the cached checkpoint is
        loaded when present; otherwise the weights are random, drawn from a
        ``torch.Generator`` seeded with ``seed``, or, with ``require_weights``
        (the CLIs set it unless --allow-random-weights), the call raises.
        ``device``: where the network and the FLAME decode run. ``mesh``: a
        ``parallel.Mesh`` whose data rows share every bulk call (module
        docstring); ``device`` is then its first device."""
        self.config = {**DEFAULT_CONFIG, **(config or {})}
        quant_amax = self.config.get("quant_amax")
        if quant_amax is not None:  # before loading anything
            check_backbone(self.config["model"].get("backbone", "resnet50"))
        self.mesh = mesh
        self.device = mesh.local_devices[0] if mesh is not None else torch.device(device)
        self._img_size = int(self.config["img_size"])
        self._stride = int(self.config.get("stride", 4))
        self._resize_mode = self.config.get("resize_mode", "longest_max_size")
        self.flame_constants = self.config["constants"]
        self.flame = FlameModel.load(flame_path, device=self.device)

        self.model = create_model(self.config["model"], torch.Generator().manual_seed(seed))
        path = self._checkpoint(checkpoint_path, require_weights)
        self.loaded_checkpoint: Optional[str] = None
        if path is not None:
            load_checkpoint(self.model, path)
            self.loaded_checkpoint = path
            logger.info("loaded predictor checkpoint from %s", path)
        else:
            logger.warning("no checkpoint found: using random weights (seed %d)", seed)
        self.model = self.model.to(self.device).eval()
        self.quant_amax: Optional[Dict[str, torch.Tensor]] = None
        self.quant_qparams = None
        if quant_amax is not None:
            self.quant_amax = amax_tensors(quant_amax, self.device)
            # fold BN and quantize the kernels once; each call reads only these
            self.quant_qparams = prepare_int8_params(self.model, img_size=self._img_size)
        # a copy of what a call reads on each other device of the mesh
        self._copies: Dict[torch.device, Dict[str, Any]] = {}
        if mesh is not None:
            copies = replicate(self._replica(self.device), mesh)
            self._copies = {d: r for d, r in copies.items() if d != self.device}

    # -- weights -----------------------------------------------------------
    def _checkpoint(self, checkpoint_path: Optional[str], require_weights: bool) -> Optional[str]:
        """The checkpoint to load, or None for random weights."""
        if checkpoint_path is not None and not os.path.isfile(checkpoint_path):
            # a requested checkpoint is never silently replaced by the cache
            raise FileNotFoundError(
                f"checkpoint not found: {checkpoint_path}. Train one "
                "(python -m dad3dheads_tpu_torch.cli.train) or port the reference "
                "weights (dad3dheads_tpu_torch.weights.state_dict_from_reference, "
                "or tools/port_torch_weights.py)."
            )
        path = checkpoint_path or os.path.join(_CKPT_DIR, _CKPT_FILE)
        if os.path.isfile(path):
            return path
        if self.config.get("model_url"):
            # fetch the published checkpoint into the cache dir
            return download_model(self.config["model_url"])
        if require_weights:
            raise FileNotFoundError(
                f"no predictor checkpoint at {path}. Train one (python -m "
                "dad3dheads_tpu_torch.cli.train), port the reference weights "
                "(dad3dheads_tpu_torch.weights.state_dict_from_reference, or "
                "tools/port_torch_weights.py --torch model.trcd --out "
                "dad_3dnet.msgpack), set model_url in the predictor config to "
                "download one, or pass --allow-random-weights to run with "
                "random weights."
            )
        return None

    # -- the device pipeline -----------------------------------------------
    def _replica(self, device: torch.device) -> Dict[str, Any]:
        """What a call on ``device`` reads: the network, FLAME and the int8
        tables. On the predictor's device they are its attributes, read at
        the call; on the mesh's other devices, their copies."""
        if device != self.device:
            return self._copies[device]
        return {"model": self.model, "flame": self.flame, "amax": self.quant_amax, "qparams": self.quant_qparams}

    def _sharded(self, fn, *tensors: torch.Tensor):
        """``fn(*tensors, replica=...)`` on the predictor's device; with a mesh,
        over its data rows: the batch (host or device tensors) padded with
        copies of its last row to a multiple of the rows, one chunk per row
        on its device under that device's replica, the outputs joined in
        order on the first device without the pad."""
        if self.mesh is None:
            return fn(*[t.to(self.device) for t in tensors], replica=self._replica(self.device))
        n = tensors[0].shape[0]
        pad = pad_batch_to_devices(n, self.mesh) - n
        if pad:
            tensors = tuple(torch.cat([t, t[-1:].expand(pad, *t.shape[1:])]) for t in tensors)
        parts = []
        for chunk, dev in zip(shard_batch(tuple(tensors), self.mesh), self.mesh.local_devices):
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                parts.append(fn(*chunk, replica=self._replica(dev)))
        return _join(parts, self.device, n)

    def _network(self, x: torch.Tensor, replica: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The network's outputs on a normalized NHWC batch: ``replica``'s
        int8 mirror with ``quant_amax``, else its model."""
        if replica["amax"] is None:
            return replica["model"](x)
        return quantized_forward(replica["model"], x, replica["amax"], mode="int8", qparams=replica["qparams"])[0]

    @torch.inference_mode()
    def _run(self, x: torch.Tensor, replica: Dict[str, Any]):
        """Normalized or uint8 NHWC batch on the device -> decoded outputs. A
        uint8 batch is normalized straight into the trunk's dtype (the bf16
        trunk then reads it without a cast); other inputs reach it as fp32."""
        if x.dtype == torch.uint8:
            x = normalize_images(x, out_dtype=self.model.dtype)
        elif x.dtype != self.model.dtype:
            x = x.float()
        return decode_pipeline_outputs(self._network(x, replica), self._stride, self._img_size)

    @torch.inference_mode()
    def _run_packed(self, x: torch.Tensor, replica: Dict[str, Any]) -> torch.Tensor:
        """As ``_run``, packed into one (B, 136 + 413) fp32 tensor, so that
        each batch comes back in one copy."""
        dev = self._run(x, replica)
        return torch.cat([dev["landmarks"].reshape(x.shape[0], -1), dev["3dmm"].float()], dim=1)

    @torch.inference_mode()
    def _run_frames(self, frames: torch.Tensor, sizes: torch.Tensor, bboxes: torch.Tensor,
                    replica: Dict[str, Any]) -> torch.Tensor:
        """Padded uint8 frames (planar (B, Hmax, 3*Wmax) or NHWC) + sizes +
        boxes on the device -> one packed (B, 2 + 4 + 136 + 413) fp32 tensor:
        the preprocess scales and paddings, then landmarks and 3DMM."""
        layout = "planar" if frames.ndim == 3 else "nhwc"
        images, scales, paddings = preprocess_frames_device(
            frames, sizes, bboxes, self._img_size, "imagenet", self._resize_mode, layout=layout,
            out_dtype=self.model.dtype,
        )
        dev = decode_pipeline_outputs(self._network(images, replica), self._stride, self._img_size)
        B = frames.shape[0]
        return torch.cat(
            [scales, paddings.float(), dev["landmarks"].reshape(B, -1), dev["3dmm"].float()], dim=1
        )

    @torch.inference_mode()
    def _decode_3dmm(self, params_3dmm: torch.Tensor, replica: Dict[str, Any]):
        with fp32_exact():
            return decode_3dmm_to_mesh(replica["flame"], params_3dmm, self.flame_constants, self._img_size)

    def _run_decoded(self, x: torch.Tensor, replica: Dict[str, Any]):
        """``_run`` and the FLAME decode of its 3DMM on one device:
        (landmarks, 3DMM, vertices, projected vertices)."""
        dev = self._run(x, replica)
        return (dev["landmarks"], dev["3dmm"]) + tuple(self._decode_3dmm(dev["3dmm"], replica))

    def _mesh_results(self, pts, adj: np.ndarray) -> list:
        """Per-image result dicts for readjusted points and 3DMM rows, with
        the FLAME decode of the rows on the device (the mesh's rows)."""
        v3, proj = self._sharded(self._decode_3dmm, torch.from_numpy(np.ascontiguousarray(adj)))
        v3, proj = _numpy(v3), _numpy(proj)
        return [
            {"points": pts[j], "projected_vertices": proj[j : j + 1], "3d_vertices": v3[j],
             "3dmm_params": adj[j : j + 1]}
            for j in range(len(adj))
        ]

    # -- public API --------------------------------------------------------
    def __call__(self, image: np.ndarray) -> Dict[str, Any]:
        """RGB uint8 (H, W, 3) -> prediction dict in original-image coords."""
        tensor, scale, paddings = preprocess_image_np(image, self._img_size, mode=self._resize_mode)
        local = self._replica(self.device)
        dev = self._run(torch.from_numpy(np.ascontiguousarray(tensor[None])).to(self.device), local)
        landmarks = readjust_landmarks_np(_numpy(dev["landmarks"])[0], paddings, scale)
        pred_3dmm = readjust_3dmm_np(
            _numpy(dev["3dmm"]), paddings, scale, self._img_size, self.flame_constants
        )
        vertices_3d, projected = self._decode_3dmm(torch.from_numpy(pred_3dmm).to(self.device), local)
        return {
            "points": np.reshape(landmarks, (-1, 2)),
            "projected_vertices": _numpy(projected),
            "3d_vertices": _numpy(vertices_3d[0]),
            "3dmm_params": pred_3dmm,
        }

    def predict_batch(self, images: Union[np.ndarray, torch.Tensor]) -> Dict[str, np.ndarray]:
        """Batched prediction on pre-sized square inputs (B, S, S, 3), uint8
        or fp32-normalized. Returns network-frame outputs as numpy arrays:
        points (B, 68, 2), projected_vertices (B, V, 2), 3d_vertices
        (B, V, 3), 3dmm_params (B, 413), all float32."""
        landmarks, params, vertices_3d, projected = self._sharded(self._run_decoded,
                                                                  torch.as_tensor(images).contiguous())
        return {
            "points": _numpy(landmarks),
            "projected_vertices": _numpy(projected),
            "3d_vertices": _numpy(vertices_3d),
            "3dmm_params": _numpy(params),
        }

    def predict_images(
        self, images, batch_size: int = 32, num_workers: int = 0, with_mesh: bool = True
    ) -> list:
        """Bulk prediction: RGB images of any size -> one dict per image in
        original-image coordinates (the ``__call__`` contract).

        Each image is resized and padded with cv2 on the host (on
        ``num_workers`` threads when > 1; float images are rounded and clipped
        to uint8 first); every device call takes a uint8 batch of
        ``batch_size`` (the last one padded), which the normalize kernel
        feeds to the network. ``with_mesh=False`` skips the FLAME decode and
        returns only {"points", "3dmm_params"}.

        ``images`` may instead be one ``torch.Tensor`` of network-size images
        (N, S, S, 3), uint8 or float 0..255, on the predictor's device: no
        host preprocessing and no upload; the outputs are in that frame."""
        if isinstance(images, torch.Tensor):
            if images.ndim != 4 or tuple(images.shape[1:]) != (self._img_size, self._img_size, 3):
                raise ValueError(f"expected (N, {self._img_size}, {self._img_size}, 3), got {tuple(images.shape)}")
            if images.shape[0] == 0:
                return []
            x = images.to(self.device)
            return self._predict_bulk_device(x if x.dtype == torch.uint8 else coerce_u8(x), batch_size, with_mesh)
        images = list(images)
        if not images:
            return []

        def prep(im):
            if im.dtype != np.uint8:
                im = np.clip(np.round(im), 0, 255).astype(np.uint8)
            return preprocess_image_np(im, self._img_size, normalize="none", mode=self._resize_mode)

        if num_workers > 1:
            with cf.ThreadPoolExecutor(num_workers) as ex:
                prepped = list(ex.map(prep, images))
        else:
            prepped = [prep(im) for im in images]

        lm_cols = 2 * self.model.num_classes
        results: list = []

        def drain(item: _Pending) -> None:
            packed = item.result()[: item.count]
            pts, adj = [], []
            for j, (scale, pads) in enumerate(item.meta):
                pts.append(np.reshape(readjust_landmarks_np(packed[j, :lm_cols].reshape(-1, 2), pads, scale), (-1, 2)))
                adj.append(readjust_3dmm_np(packed[j : j + 1, lm_cols:], pads, scale, self._img_size,
                                            self.flame_constants))
            adj = np.concatenate(adj, 0)
            if with_mesh:
                results.extend(self._mesh_results(pts, adj))
            else:
                results.extend({"points": pts[j], "3dmm_params": adj[j : j + 1]} for j in range(len(adj)))

        pending: collections.deque = collections.deque()
        for lo in range(0, len(prepped), batch_size):
            chunk = prepped[lo : lo + batch_size]
            x = np.stack([t for t, _, _ in chunk])
            if len(chunk) < batch_size:
                x = np.concatenate([x, np.repeat(x[-1:], batch_size - len(chunk), 0)])
            packed = self._sharded(self._run_packed, torch.from_numpy(x))
            pending.append(_Pending(packed, len(chunk), [(s, p) for _, s, p in chunk]))
            if len(pending) >= 2:
                drain(pending.popleft())
        while pending:
            drain(pending.popleft())
        return results

    def _predict_bulk_device(self, images: torch.Tensor, batch_size: int, with_mesh: bool) -> list:
        """Device-resident uint8 (N, S, S, 3): one packed call per batch, each
        copied back while the next one runs, then one readjustment with the
        identity (the inputs are already in the network frame)."""
        n = images.shape[0]
        if n % batch_size:
            images = torch.cat([images, images[-1:].expand(batch_size - n % batch_size, -1, -1, -1)])
        outs = [_Pending(self._sharded(self._run_packed, images[lo : lo + batch_size].contiguous()), batch_size, None)
                for lo in range(0, images.shape[0], batch_size)]
        packed = np.concatenate([o.result() for o in outs])[:n]
        lm_cols = 2 * self.model.num_classes
        identity = [0, 0, 0, 0]
        pts = readjust_landmarks_np(packed[:, :lm_cols].reshape(n, -1, 2), identity, 1.0)
        adj = readjust_3dmm_np(packed[:, lm_cols:], identity, 1.0, self._img_size, self.flame_constants)
        if not with_mesh:
            return [{"points": pts[j], "3dmm_params": adj[j : j + 1]} for j in range(n)]
        results: list = []
        for lo in range(0, n, batch_size):
            results.extend(self._mesh_results(pts[lo : lo + batch_size], adj[lo : lo + batch_size]))
        return results

    def predict_frames(
        self,
        frames,
        bboxes=None,
        batch_size: int = 32,
        with_mesh: bool = True,
        frame_bucket: int = 64,
    ) -> list:
        """Bulk prediction from full frames and optional face boxes, with the
        preprocess on the device.

        frames: RGB uint8 (H, W, 3) frames of any sizes; each batch is pasted
        into one channel-planar buffer whose extents round the batch's largest
        frame up to ``frame_bucket``. bboxes: optional (N, 4) [x0, y0, x1, y1]
        crop windows, clamped to each frame; the whole frame by default.

        Returns one dict per frame in the ``__call__`` contract, with
        "points" in full-frame coordinates (the crop origin added back) and
        "3dmm_params" in the crop's frame, as the reference predictor gives
        them."""
        frames = list(frames)
        if not frames:
            return []
        if bboxes is None:
            bb = [(0, 0, f.shape[1], f.shape[0]) for f in frames]
        else:
            bb = []
            for f, b in zip(frames, bboxes):
                h, w = f.shape[:2]
                x0 = int(np.clip(b[0], 0, w - 1))
                y0 = int(np.clip(b[1], 0, h - 1))
                bb.append((x0, y0, int(np.clip(b[2], x0 + 1, w)), int(np.clip(b[3], y0 + 1, h))))
        mm_col = 6 + 2 * self.model.num_classes  # after scales, paddings and landmarks
        results: list = []

        def drain(item: _Pending) -> None:
            packed = item.result()
            pts, adj = [], []
            for j in range(item.count):
                scale = packed[j, 0:2]
                pads = packed[j, 2:6].astype(np.int64).tolist()
                x0, y0 = item.meta[j][:2]
                pts.append(readjust_landmarks_np(packed[j, 6:mm_col].reshape(-1, 2), pads, scale)
                           + np.asarray([[x0, y0]]))
                adj.append(readjust_3dmm_np(packed[j : j + 1, mm_col:], pads, scale, self._img_size,
                                            self.flame_constants))
            adj = np.concatenate(adj, 0)
            if with_mesh:
                results.extend(self._mesh_results(pts, adj))
            else:
                results.extend({"points": pts[j], "3dmm_params": adj[j : j + 1]} for j in range(len(adj)))

        pending: collections.deque = collections.deque()
        for lo in range(0, len(frames), batch_size):
            chunk, boxes = frames[lo : lo + batch_size], bb[lo : lo + batch_size]
            buf, sizes, packed_boxes = pack_frames_host(chunk, boxes, batch_size, bucket=frame_bucket, planar=True)
            packed = self._sharded(self._run_frames, *[torch.from_numpy(a) for a in (buf, sizes, packed_boxes)])
            pending.append(_Pending(packed, len(chunk), boxes))
            if len(pending) >= 2:
                drain(pending.popleft())
        while pending:
            drain(pending.popleft())
        return results

    @classmethod
    def dad_3dnet(cls, checkpoint_path: Optional[str] = None, **kwargs) -> "FaceMeshPredictor":
        """The flagship predictor."""
        return cls(DEFAULT_CONFIG, checkpoint_path=checkpoint_path, **kwargs)

    @classmethod
    def from_yaml(cls, path: str, **kwargs) -> "FaceMeshPredictor":
        """Build from a predictor config yaml (``configs/dad_3dnet.yaml``); a
        ``checkpoint`` entry that names no file is ignored, as in the JAX
        predictor."""
        import yaml

        with open(path) as f:
            config = yaml.safe_load(f)
        ckpt = config.pop("checkpoint", None)
        if ckpt:
            ckpt = os.path.expanduser(ckpt)
            if not os.path.isfile(ckpt):
                ckpt = None
        return cls(config, checkpoint_path=ckpt, **kwargs)
