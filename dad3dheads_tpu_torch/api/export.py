"""The deployment artifact: one file that serves predictions without the
model's code. Port of ``dad3dheads_tpu/api/export.py``, the counterpart of
the reference's TorchScript ``.trcd``.

:func:`export_predictor` traces three programs with ``torch.export``, each
with a symbolic batch:

- ``pipeline(weights, images (b, S, S, 3) fp32) -> (landmarks (b, 136),
  3dmm (b, 413))``;
- ``decode(flame, 3dmm (b, P)) -> (vertices (b, V, 3), projected (b, V, 2))``;
- ``frames(weights, frames (bf, fh, fw, 3) uint8, sizes (bf, 2) int32,
  boxes (bf, 4) int32) -> (landmarks, 3dmm, scales (bf, 2), paddings
  (bf, 4))``, the crop, resize and normalize inside, with the frame extents
  symbolic too.

They are built from the live predictor's own functions
(``decode_pipeline_outputs``, ``decode_3dmm_to_mesh``,
``preprocess_frames_device``), so the artifact matches the live predictor by
construction. The hand-written kernels are ``torch.library`` custom
operators (``dad3d::blend_shapes`` in ``decode``,
``dad3d::resample_normalize_u8`` in ``frames``): each is one node of the
graph, which launches the kernel on the card and runs the plain version on
the CPU. Weights and FLAME tensors travel as arguments and are stored once;
the programs are traced once per device in ``devices``, since a graph holds
device-specific nodes (tensors made on a device, the bf16 trunk's autocast
region).

The file is a zip (suffix :data:`SUFFIX`): ``meta.json``, ``weights.pt``
(``torch.save`` of the network's state dict and the FLAME tensors, loadable
with ``weights_only=True``) and ``{program}.{device}.pt2`` for each program
and device (``torch.export.save``). :class:`ExportedFaceMeshPredictor` serves
``__call__``, ``predict_images``, ``predict_frames`` and ``predict_batch``
from it, importing neither the models, the FLAME code nor its assets.

An int8 artifact (``quant_amax``, resnet50 only; ``meta.json`` says
``"quantized": true``) traces ``pipeline`` and ``frames`` over the int8
mirror (``models/quantized.py``): they take the prepared int8 kernels as a
second argument (``weights.pt`` holds them once, as "qparams"), the amax
table is a constant of the graphs, and ``weights.pt`` keeps only the fp
weights the mirror reads beside them (the BiFPN fusion weights and the
regression heads). The fp32 programs, the int8 ones and the decode run with
TF32 off (``precision.fp32_exact``); the bf16 trunk under the caller's
settings, as the live bf16 network does.

Not ported: the JAX package's per-bucket TPU frames programs, which exist for
the TPU's static shapes.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import io
import json
import os
import time
import zipfile
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from .. import ops  # noqa: F401  registers the dad3d:: operators the programs call
from ..constants import FLAME_CONSTS
from ..ops.preprocess import normalize_scale_bias, preprocess_image_np, readjust_3dmm_np, readjust_landmarks_np
from ..ops.preprocess_device import pack_frames_host
from ..precision import fp32_exact

FORMAT_VERSION = 1
SUFFIX = ".aot.zip"
PROGRAMS = ("pipeline", "decode", "frames")
DEVICES = ("cuda", "cpu")
FLAME_FIELDS = ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights")


def default_devices() -> tuple:
    """The card and the CPU on a machine with a card; the CPU alone without."""
    return DEVICES if torch.cuda.is_available() else ("cpu",)


def _device_types(devices: Sequence[Union[str, torch.device]]) -> list:
    types = []
    for d in devices:
        t = d.type if isinstance(d, torch.device) else str(d).split(":")[0]
        if t not in DEVICES:
            raise ValueError(f"an artifact runs on {DEVICES}, not {d!r}")
        if t == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("devices names 'cuda', but no CUDA device is available")
        if t not in types:
            types.append(t)
    if not types:
        raise ValueError("devices is empty")
    return types


def _to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device`` with its strides: FLAME's shapedirs keeps the
    padded rows that the blendshape kernels copy 16 bytes at a time."""
    out = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=device)
    return out.copy_(t)


def _drop_dtype_asserts(program) -> None:
    """Erase the ``_assert_tensor_metadata`` nodes that ``torch.export`` writes
    after the ops of an autocast region. They hold the dtypes of its trace,
    where an op on the card's autocast fp32 list (``upsample_nearest2d``, in
    the BiFPN of the bf16 trunk) came out bf16; the running program, like the
    live network, gets fp32 from autocast there, and the assertion would
    refuse it. Without them the graph's ops take their dtypes as in eager
    mode."""
    for module in program.graph_module.modules():
        if isinstance(module, torch.fx.GraphModule):
            for node in list(module.graph.nodes):
                if node.op == "call_function" and node.target == torch.ops.aten._assert_tensor_metadata.default:
                    module.graph.erase_node(node)
            module.recompile()


def _read_by_int8_mirror(key: str) -> bool:
    """The state-dict entries the int8 mirror reads beside the prepared
    kernels: the BiFPN fusion weights and the regression heads."""
    return key.startswith(("shape.", "pose.", "landmarks.")) or key.endswith((".w1", ".w2"))


class _Int8Network(torch.nn.Module):
    """The int8 mirror as a module over ``model``, so that
    ``functional_call`` can hand it the weights; the amax table is a
    constant."""

    def __init__(self, model, amax):
        super().__init__()
        self.model, self.amax = model, amax

    def forward(self, images, qparams):
        from ..models.quantized import quantized_forward

        return quantized_forward(self.model, images, self.amax, mode="int8", qparams=qparams)[0]


class _Program(torch.nn.Module):
    """A stateless root for ``torch.export``: ``fn`` is a plain attribute, so
    the network it closes over gives the program no parameters; the weights
    arrive as its first argument."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_predictor(
    model,
    flame,
    path: str,
    img_size: int = 256,
    stride: int = 4,
    constants: Optional[Dict[str, int]] = None,
    devices: Sequence[Union[str, torch.device]] = DEVICES,
    quant_amax: Optional[Dict[str, Any]] = None,
    resize_mode: str = "longest_max_size",
) -> str:
    """Write the artifact of ``model`` (a ``DAD3DNet``, in its ``dtype``: fp32,
    or the bf16 trunk with fp32 heads) and ``flame`` (a ``FlameModel``) to
    ``path``, with each program traced for every device in ``devices``
    ("cuda", "cpu"); returns ``path``. The time each trace took is kept in
    the metadata (``export_seconds``). ``quant_amax`` (a dict or an ``.npz``
    path) writes the int8 artifact of a resnet50 ``model``."""
    from torch.func import functional_call

    from ..core.flame import FlameModel
    from ..models.quantized import amax_tensors, prepare_int8_params
    from ..ops.preprocess_device import preprocess_frames_device
    from .predictor import decode_3dmm_to_mesh, decode_pipeline_outputs

    types = _device_types(devices)
    constants = dict(constants or FLAME_CONSTS)
    parents = tuple(flame.parents)
    weights = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    flame_tensors = {k: _to_device(getattr(flame, k), "cpu") for k in FLAME_FIELDS}
    quantized = quant_amax is not None
    qparams: Dict[str, Any] = {}
    if quantized:
        qparams = {k: tuple(t.cpu() for t in v) for k, v in prepare_int8_params(model, img_size=img_size).items()}
        # the folded leaves stay out of the file (a read of one would put it
        # in the graph as a constant: tests/test_torch_int8_export.py looks)
        weights = {k: v for k, v in weights.items() if _read_by_int8_mirror(k)}

    def network(images, w, q=None):
        """The network's outputs on a normalized batch, from the weights
        given (and the prepared int8 kernels ``q`` of an int8 artifact)."""
        if not quantized:
            return functional_call(model, w, (images,))
        return functional_call(int8_network, {f"model.{k}": v for k, v in w.items()}, (images, q))

    def pipeline(*args):  # (weights[, qparams], images)
        images = args[-1]
        out = decode_pipeline_outputs(network(images, *args[:-1]), stride, img_size)
        return out["landmarks"].reshape(images.shape[0], -1), out["3dmm"]

    def decode(f, params_3dmm):
        return decode_3dmm_to_mesh(FlameModel(**f, parents=parents), params_3dmm, constants, img_size)

    def frames(*args):  # (weights[, qparams], frames, sizes, boxes)
        frames_u8, sizes, boxes = args[-3:]
        images, scales, paddings = preprocess_frames_device(
            frames_u8, sizes, boxes, img_size, "imagenet", resize_mode, out_dtype=model.dtype
        )
        out = decode_pipeline_outputs(network(images, *args[:-3]), stride, img_size)
        return out["landmarks"].reshape(frames_u8.shape[0], -1), out["3dmm"], scales, paddings

    Dim = torch.export.Dim
    # batches up to 65,535: cuDNN's size limits put that guard in the card's graphs
    b, bf = Dim("b", min=1, max=65535), Dim("bf", min=1, max=65535)
    fh, fw = Dim("fh", min=2, max=32767), Dim("fw", min=2, max=32767)
    static_w = {k: None for k in weights}
    static_net = (static_w, {k: (None, None, None) for k in qparams}) if quantized else (static_w,)
    static_f = {k: None for k in flame_tensors}
    n_params = sum(constants.values())
    # example extents that share no value, so that the trace ties no two dims
    ex_b, ex_h, ex_w = 3, img_size + 37, img_size + 91

    files: Dict[str, bytes] = {}
    seconds: Dict[str, float] = {}
    was_training = model.training
    model.eval()
    try:
        for dev in types:
            w = {k: v.to(dev) for k, v in weights.items()}
            f = {k: _to_device(v, dev) for k, v in flame_tensors.items()}
            u8 = torch.zeros((ex_b, ex_h, ex_w, 3), dtype=torch.uint8, device=dev)
            sizes = torch.tensor([[ex_h, ex_w]] * ex_b, dtype=torch.int32, device=dev)
            boxes = torch.tensor([[0, 0, ex_w, ex_h]] * ex_b, dtype=torch.int32, device=dev)
            net = (w, {k: tuple(t.to(dev) for t in v) for k, v in qparams.items()}) if quantized else (w,)
            if quantized:
                int8_network = _Int8Network(model, amax_tensors(quant_amax, dev))
            specs = {
                "pipeline": (pipeline, (*net, torch.zeros((2, img_size, img_size, 3), device=dev)),
                             (*static_net, {0: b})),
                "decode": (decode, (f, torch.zeros((2, n_params), device=dev)), (static_f, {0: b})),
                "frames": (frames, (*net, u8, sizes, boxes),
                           (*static_net, {0: bf, 1: fh, 2: fw}, {0: bf}, {0: bf})),
            }
            for name in PROGRAMS:
                fn, args, dynamic = specs[name]
                t0 = time.perf_counter()
                with torch.no_grad():
                    program = torch.export.export(_Program(fn), args, dynamic_shapes={"args": dynamic}, strict=False)
                _drop_dtype_asserts(program)
                program.example_inputs = None  # the weights are stored once, beside the programs
                buf = io.BytesIO()
                torch.export.save(program, buf)
                seconds[f"{name}.{dev}"] = time.perf_counter() - t0
                files[f"{name}.{dev}.pt2"] = buf.getvalue()
            del w, f, net
    finally:
        model.train(was_training)

    buf = io.BytesIO()
    torch.save({"model": weights, "qparams": qparams, "flame": flame_tensors}, buf)
    files["weights.pt"] = buf.getvalue()
    meta = {
        "format_version": FORMAT_VERSION,
        "img_size": int(img_size),
        "stride": int(stride),
        "constants": constants,
        "devices": types,
        "backbone": getattr(model, "backbone", None),
        "dtype": str(model.dtype).replace("torch.", ""),
        "resize_mode": resize_mode,
        "torch_version": torch.__version__,
        "quantized": quantized,
        "export_seconds": seconds,
    }
    files["meta.json"] = json.dumps(meta, indent=1).encode()

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED) as z:
        for name, data in files.items():
            z.writestr(name, data)
    os.replace(tmp, path)  # a reader never sees a partial file
    return path


def read_meta(path: str) -> Dict[str, Any]:
    """The artifact's ``meta.json``."""
    with zipfile.ZipFile(path) as z:
        return json.loads(z.read("meta.json"))


class ExportedFaceMeshPredictor:
    """``FaceMeshPredictor``'s entry points from one artifact, on ``device``
    ("cuda" by default, or "cpu"), which must be among the artifact's
    devices. The host work (resize, pad, normalize, readjustment to the
    original image) is the JAX package's ``ExportedFaceMeshPredictor``'s."""

    def __init__(self, path: str, device: Union[str, torch.device] = "cuda", resize_mode: Optional[str] = None):
        self.device = torch.device(device)
        with zipfile.ZipFile(path) as z:
            meta = json.loads(z.read("meta.json"))
            if meta["format_version"] > FORMAT_VERSION:
                raise ValueError(
                    f"artifact format v{meta['format_version']} is newer than this loader (v{FORMAT_VERSION})"
                )
            if self.device.type not in meta["devices"]:
                raise ValueError(
                    f"{path} was exported for {meta['devices']}, not {self.device.type!r}: "
                    f"export it with devices including {self.device.type!r}"
                )
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("device 'cuda' asked for, but no CUDA device is available")
            if self.device.index not in (None, 0):
                raise ValueError(f"the programs make their tensors on the device they were traced on, cuda:0, "
                                 f"not {self.device}")
            self._programs = {
                name: torch.export.load(io.BytesIO(z.read(f"{name}.{self.device.type}.pt2"))).module()
                for name in PROGRAMS
            }
            tensors = torch.load(io.BytesIO(z.read("weights.pt")), map_location=self.device, weights_only=True)
        self.meta = meta
        self._weights, self._flame = tensors["model"], tensors["flame"]
        self._net = (self._weights, tensors["qparams"]) if meta.get("quantized") else (self._weights,)
        self._img_size = int(meta["img_size"])
        self.flame_constants = dict(meta["constants"])
        # the frames program's mode by default, so that both preprocess paths resample alike
        self._resize_mode = resize_mode or meta["resize_mode"]
        # the fp32 network and the int8 mirror run with TF32 off, as the live
        # ones set it; the bf16 trunk under the caller's settings
        self._exact = meta["dtype"] == "float32" or bool(meta.get("quantized"))
        self._scale, self._bias = normalize_scale_bias("imagenet")

    # -- the programs --------------------------------------------------------
    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _precision(self):
        return fp32_exact() if self._exact else contextlib.nullcontext()

    @torch.inference_mode()
    def _pipeline(self, images: np.ndarray):
        with self._precision():
            return self._programs["pipeline"](*self._net, self._tensor(images))

    @torch.inference_mode()
    def _decode(self, params_3dmm: torch.Tensor):
        with fp32_exact():
            return self._programs["decode"](self._flame, params_3dmm.to(self.device))

    @torch.inference_mode()
    def _frames(self, buf: np.ndarray, sizes: np.ndarray, boxes: np.ndarray):
        with self._precision():
            return self._programs["frames"](*self._net, self._tensor(buf), self._tensor(sizes), self._tensor(boxes))

    # -- public API ------------------------------------------------------------
    def __call__(self, image: np.ndarray) -> Dict[str, Any]:
        """RGB uint8 (H, W, 3) -> prediction dict in original-image coords."""
        tensor, scale, paddings = preprocess_image_np(image, self._img_size, mode=self._resize_mode)
        landmarks, pred_3dmm = self._pipeline(tensor[None])
        landmarks = readjust_landmarks_np(landmarks.cpu().numpy()[0].reshape(-1, 2), paddings, scale)
        pred_3dmm = readjust_3dmm_np(pred_3dmm.cpu().numpy(), paddings, scale, self._img_size, self.flame_constants)
        vertices_3d, projected = self._decode(torch.from_numpy(pred_3dmm))
        return {
            "points": np.reshape(landmarks, (-1, 2)),
            "projected_vertices": projected.cpu().numpy(),
            "3d_vertices": vertices_3d[0].cpu().numpy(),
            "3dmm_params": pred_3dmm,
        }

    def predict_images(self, images, batch_size: int = 32, num_workers: int = 0, with_mesh: bool = True) -> list:
        """Images of any size -> one ``__call__`` dict each. Every chunk, the
        ragged last one included, runs through the same program, unpadded."""
        images = list(images)
        if not images:
            return []

        def prep(im):
            return preprocess_image_np(im, self._img_size, mode=self._resize_mode)

        if num_workers > 1:
            with cf.ThreadPoolExecutor(num_workers) as ex:
                prepped = list(ex.map(prep, images))
        else:
            prepped = [prep(im) for im in images]

        results = []
        for lo in range(0, len(prepped), batch_size):
            chunk = prepped[lo : lo + batch_size]
            landmarks, mm = self._pipeline(np.stack([t for t, _, _ in chunk]))
            landmarks = landmarks.cpu().numpy().reshape(len(chunk), -1, 2)
            mm = mm.cpu().numpy()
            pts = [readjust_landmarks_np(landmarks[j], pads, scale) for j, (_, scale, pads) in enumerate(chunk)]
            adj = np.concatenate([
                readjust_3dmm_np(mm[j : j + 1], pads, scale, self._img_size, self.flame_constants)
                for j, (_, scale, pads) in enumerate(chunk)
            ])
            results.extend(self._results(pts, adj, with_mesh))
        return results

    def predict_frames(self, frames, bboxes=None, batch_size: int = 32, with_mesh: bool = True,
                       frame_bucket: int = 64) -> list:
        """Full frames (+ optional [x0, y0, x1, y1] boxes) -> one ``__call__``
        dict each, "points" in full-frame coordinates. The host pastes each
        chunk into one NHWC buffer whose extents round its largest frame up
        to ``frame_bucket``; crop, resize and normalize run inside the frames
        program, which takes any batch and extents."""
        frames = list(frames)
        if not frames:
            return []
        if bboxes is None:
            bb = [(0, 0, f.shape[1], f.shape[0]) for f in frames]
        else:
            bb = [tuple(int(v) for v in b) for b in bboxes]
        results = []
        for lo in range(0, len(frames), batch_size):
            chunk, cb = frames[lo : lo + batch_size], bb[lo : lo + batch_size]
            count = len(chunk)
            buf, sizes, boxes = pack_frames_host(chunk, cb, batch_size, bucket=frame_bucket)
            lms, mm, scales, pads = (t.cpu().numpy() for t in self._frames(buf[:count], sizes[:count], boxes[:count]))
            lms = lms.reshape(count, -1, 2)
            pts, adj = [], []
            for j in range(count):
                # the boxes are clamped in the program; the same clamp gives the crop's origin
                h, w = chunk[j].shape[:2]
                x0, y0 = int(np.clip(cb[j][0], 0, w - 1)), int(np.clip(cb[j][1], 0, h - 1))
                p = pads[j].tolist()
                pts.append(readjust_landmarks_np(lms[j], p, scales[j]) + np.asarray([[x0, y0]]))
                adj.append(readjust_3dmm_np(mm[j : j + 1], p, scales[j], self._img_size, self.flame_constants))
            results.extend(self._results(pts, np.concatenate(adj), with_mesh))
        return results

    def _results(self, pts: list, adj: np.ndarray, with_mesh: bool) -> list:
        """Per-image dicts for readjusted points and 3DMM rows, with the
        decode program's mesh unless ``with_mesh`` is False."""
        if not with_mesh:
            return [{"points": np.reshape(p, (-1, 2)), "3dmm_params": adj[j : j + 1]} for j, p in enumerate(pts)]
        v3, proj = (t.cpu().numpy() for t in self._decode(torch.from_numpy(adj)))
        return [
            {"points": np.reshape(pts[j], (-1, 2)), "projected_vertices": proj[j : j + 1], "3d_vertices": v3[j],
             "3dmm_params": adj[j : j + 1]}
            for j in range(len(pts))
        ]

    def predict_batch(self, images: np.ndarray) -> Dict[str, np.ndarray]:
        """Pre-sized square inputs (B, S, S, 3), uint8 or fp32-normalized ->
        network-frame outputs (no readjustment). uint8 is normalized on the
        host as the port's normalize kernel computes it (x * scale + bias)."""
        images = np.asarray(images)
        if images.dtype == np.uint8:
            images = images.astype(np.float32) * self._scale + self._bias
        landmarks, pred_3dmm = self._pipeline(images.astype(np.float32, copy=False))
        vertices_3d, projected = self._decode(pred_3dmm)
        return {
            "points": landmarks.cpu().numpy().reshape(len(images), -1, 2),
            "projected_vertices": projected.cpu().numpy(),
            "3d_vertices": vertices_3d.cpu().numpy(),
            "3dmm_params": pred_3dmm.cpu().numpy(),
        }
