"""The train and eval steps. Mirrors ``dad3dheads_tpu/train/step.py``: one
step is forward -> LossModule over one shared FLAME decode -> the metric
panel -> (train only) backward, global-norm clipping and an optimizer update
scaled by the linear warmup and the host's LR multiplier.

The FLAME decode runs in fp32 and its blendshape product differentiates
through the hand-written backward kernel on the card. The whole step,
backward included, runs with TF32 off (``precision.fp32_exact``), whatever
the caller's settings: an fp32 model in full fp32, a bf16 model with its
trunk under autocast and its heads, the geometry and the losses in fp32, as
in inference.

With a ``mesh`` under ``torch.distributed`` (``parallel.make_mesh``), the
step is the JAX package's step on a batch sharded over the mesh's data axis:
each rank takes its share of the global batch; every train-mode BatchNorm
computes the global batch's statistics (``parallel.set_sync_bn``, which
whoever builds the distributed model calls once: the ``Trainer`` does); after the
backward the gradients are averaged over the data group
(``parallel.all_reduce_gradients``), so that clipping and the update see the
global batch's gradient; the logs are the global batch's means. Head weights
split over the model group (``parallel.shard_heads``) enter the global norm
with their shards' squares summed. A world of one (or no mesh) runs the
one-process step unchanged.

On the card the train step replays CUDA graphs (:class:`StepGraphs`): the
card then runs a step's ~3,000 kernels at its own pace, not at the pace at
which the host launches them. A graph holds the whole step (targets, forward,
losses, backward, clip, update, metric panel) with the kernels an eager step
runs, the hand-written ones among them. Whether a step replays is observed
from its input: a batch of CUDA tensors, no process group (collectives stay
out of graphs), and an optimizer with torch's ``capturable`` mode (adam,
adamw, radam on the card; lamb and sgd stay eager). The first step of each
kind (the batch's layout and the loss gates) runs eagerly, the second
captures a graph and replays it, later ones replay. Any other step, and
every step on the CPU, runs eagerly as before.

Under a profiler each eager step is a tree of stage spans
(``tracing.span``): ``dad3d.train_step`` (the eval step's
``dad3d.eval_step``) over ``dad3d.train.targets``, ``.forward``, ``.loss``,
``.backward``, ``.allreduce`` (with a mesh), ``.optimizer`` and ``.panel``.
A replayed step runs no stage on the host, so its ``dad3d.train_step`` has
no children; the span's ``graphed`` count is 1 where the step's work ran as
a graph's replay, 0 where it ran eagerly.
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from .. import assets
from ..constants import (
    FLAME_CONSTS,
    INPUT_BBOX_KEY,
    INPUT_IMAGE_KEY,
    OUTPUT_2D_LANDMARKS,
    OUTPUT_3DMM_PARAMS,
    OUTPUT_LANDMARKS_HEATMAP,
    TARGET_2D_FULL_LANDMARKS,
    TARGET_2D_LANDMARKS,
    TARGET_2D_LANDMARKS_PRESENCE,
    TARGET_3D_MODEL_VERTICES,
    TARGET_LANDMARKS_HEATMAP,
)
from ..core.flame import FlameModel
from ..core.projection import heatmap_to_keypoints, normalize_to_cube
from ..losses import LossModule, SharedFlameDecode, shared_flame_decode_raw
from ..metrics import compute_step_metrics
from ..ops import add_launches, launch_counts
from ..ops.heatmap import encode_heatmap
from ..ops.preprocess import normalize_images
from ..parallel import all_reduce_gradients, all_reduce_mean, data_group, sharded_parameters
from ..precision import fp32_exact
from ..tracing import span
from .schedulers import warmup_factor
from .state import TrainState


def _prepare_targets(
    batch: Dict[str, torch.Tensor],
    img_size: int = 256,
    heatmap_stride: int = 4,
    heatmap_radius: int = 5,
) -> Dict[str, torch.Tensor]:
    """Device-side input preparation: a batch without a heatmap gets one
    encoded from its normalized 2D landmarks (bit-equal to the host coder);
    a uint8 heatmap becomes fp32 in [0, 1]; uint8 images go through the
    normalize kernel; presence becomes fp32."""
    targets = dict(batch)
    if TARGET_LANDMARKS_HEATMAP not in targets:
        kp = targets[TARGET_2D_LANDMARKS].float() * img_size
        hm = encode_heatmap(kp, targets[TARGET_2D_LANDMARKS_PRESENCE], img_size, heatmap_stride, heatmap_radius)
        targets[TARGET_LANDMARKS_HEATMAP] = hm.permute(0, 2, 3, 1)  # (B, K, S, S) -> NHWC
    hm = targets[TARGET_LANDMARKS_HEATMAP]
    if hm.dtype == torch.uint8:
        targets[TARGET_LANDMARKS_HEATMAP] = hm.float() / 255.0
    if targets[INPUT_IMAGE_KEY].dtype == torch.uint8:
        targets[INPUT_IMAGE_KEY] = normalize_images(targets[INPUT_IMAGE_KEY].contiguous())
    targets[TARGET_2D_LANDMARKS_PRESENCE] = targets[TARGET_2D_LANDMARKS_PRESENCE].float()
    return targets


class _StepCommon:
    """What the train and eval steps share."""

    def __init__(
        self,
        loss_module: Optional[LossModule] = None,
        img_size: int = 256,
        heatmap_stride: int = 4,
        heatmap_radius: int = 5,
    ):
        self.loss_module = loss_module or LossModule()
        self.img_size = img_size
        self.heatmap_stride = heatmap_stride
        self.heatmap_radius = heatmap_radius
        self._face_idx = assets.get_flame_indices("face")
        self._face_idx_on: Dict[str, torch.Tensor] = {}

    def face_idx_on(self, device: torch.device) -> torch.Tensor:
        """The face subset's vertex indices, uploaded once per device."""
        key = str(device)
        if key not in self._face_idx_on:
            self._face_idx_on[key] = torch.as_tensor(self._face_idx, dtype=torch.int64, device=device)
        return self._face_idx_on[key]

    def forward_and_loss(self, state: TrainState, flame: FlameModel, batch, train: bool):
        with span("dad3d.train.targets"):
            targets = _prepare_targets(batch, self.img_size, self.heatmap_stride, self.heatmap_radius)
        with span("dad3d.train.forward"):
            state.model.train(train)
            outputs = state.model(targets[INPUT_IMAGE_KEY])
        with span("dad3d.train.loss"):
            shared = shared_flame_decode_raw(flame, outputs[OUTPUT_3DMM_PARAMS], FLAME_CONSTS, self.img_size)
            total, loss_dict = self.loss_module(outputs, targets, shared, state.epoch)
        return total, outputs, shared, loss_dict, targets

    @torch.no_grad()
    def metrics(self, outputs, targets, shared: SharedFlameDecode) -> Dict[str, torch.Tensor]:
        presence = targets[TARGET_2D_LANDMARKS_PRESENCE][..., None]
        if OUTPUT_2D_LANDMARKS in outputs:
            pred_norm = outputs[OUTPUT_2D_LANDMARKS]
        else:  # heatmap-only variants: the argmax decode
            hm = outputs[OUTPUT_LANDMARKS_HEATMAP]
            pred_norm = heatmap_to_keypoints(hm, self.img_size // hm.shape[1]) / self.img_size
        fi = self.face_idx_on(shared.reprojected_2d.device)
        return compute_step_metrics(
            pred_landmarks=pred_norm * self.img_size * presence,
            target_landmarks=targets[TARGET_2D_LANDMARKS] * presence * self.img_size,
            pred_heatmap_probs=torch.sigmoid(outputs[OUTPUT_LANDMARKS_HEATMAP]),
            target_heatmap=targets[TARGET_LANDMARKS_HEATMAP],
            reprojected_2d_face=shared.reprojected_2d[:, fi],
            target_full_2d_face=targets[TARGET_2D_FULL_LANDMARKS][:, fi],
            pred_vertices_norm=normalize_to_cube(shared.vertices_zero_rot[:, fi]),
            target_vertices_norm=normalize_to_cube(targets[TARGET_3D_MODEL_VERTICES][:, fi]),
            bbox=targets[INPUT_BBOX_KEY].float(),
        )


def _detached(logs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in logs.items()}


def _on_cuda(value) -> bool:
    return value.is_cuda


def graph_key(state: TrainState, batch: Dict, gates: Tuple[float, ...], group=None) -> Optional[tuple]:
    """What a CUDA graph of the train step holds fixed besides the state and
    the FLAME model: the layout (key, shape, dtype, device) of the batch's
    tensors and the loss gates. None where the step runs eagerly: under a
    process group, with an optimizer that is not capturable, or with a
    tensor off the card. The batch's other values (a loader's file names and
    indices) are not the step's to read, and stay out of the graph."""
    if group is not None or not state.optimizer.capturable:
        return None
    tensors = [(k, v) for k, v in batch.items() if isinstance(v, torch.Tensor)]
    if not tensors or not all(_on_cuda(v) for _, v in tensors):
        return None
    return tuple((k, v.shape, v.dtype, v.device) for k, v in tensors), gates


def _binding(state: TrainState, flame: FlameModel) -> tuple:
    """The objects whose tensors a graph reads and writes in place: the
    state, its model, its optimizer, the FLAME model, and the first
    parameter's optimizer tensors once the first update has made them
    (``load_state_dict`` replaces them)."""
    opt = state.optimizer.optimizer
    first = opt.state.get(state.optimizer.params[0], {})
    return (state, state.model, opt, flame, *(v for v in first.values() if isinstance(v, torch.Tensor)))


class _Captured(NamedTuple):
    """One captured step: the graph, the buffers it reads the batch from, the
    names of the logs it stacks into ``logs``, and the counts of the ops'
    kernel launches it holds (``ops.LAUNCH_COUNTERS``)."""

    graph: torch.cuda.CUDAGraph
    inputs: Dict[str, torch.Tensor]
    names: Tuple[str, ...]
    logs: torch.Tensor
    launches: Tuple[int, ...]


_SIDE_STREAMS: Dict[int, torch.cuda.Stream] = {}


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream that warms and captures train steps on ``device``, one for
    the process. cuBLAS keeps a workspace for every handle (one a thread) and
    stream it has run on, for as long as the process lives, and the
    allocator reuses a block only on the stream it was made for. So the
    workspaces of this thread and of autograd's backward thread are made
    here, by a first product and its backward on the new stream, where each
    takes a segment of its own: made during a step, they would pin a large
    freed block of that step's (4.5 GiB at resnet50's B=256)."""
    if device.index not in _SIDE_STREAMS:
        stream = torch.cuda.Stream(device)
        with torch.cuda.stream(stream):
            one = torch.ones((2, 2), device=device, requires_grad=True)
            torch.mm(one, one).sum().backward()
        _SIDE_STREAMS[device.index] = stream
    return _SIDE_STREAMS[device.index]


def _drop_on_death(graphs: "StepGraphs") -> Callable:
    """A weakref callback that drops ``graphs``' graphs, if they still exist."""
    ref = weakref.ref(graphs)

    def dropped(_) -> None:
        alive = ref()
        if alive is not None:
            alive.drop()

    return dropped


class StepGraphs:
    """The CUDA graphs of one train step (one ``build_train_step`` call).

    A graph holds fixed the addresses of all it reads and writes: the
    state's parameters, buffers, gradients and optimizer tensors, the FLAME
    model's, its own input buffers and the learning-rate factor ``scale``.
    So every graph here belongs to one binding (:func:`_binding`): a step on
    another state, model, optimizer, FLAME model or optimizer tensors drops
    them all, and so does the state's end, so that the memory they hold goes
    back with the state's. Within a binding they are keyed by
    :func:`graph_key`. The graphs share one memory pool: they never run at
    the same time, and each call copies its logs out of the pool before it
    returns."""

    def __init__(self):
        self.captured: Dict[tuple, _Captured] = {}
        self._seen: set = set()
        self._binding: tuple = ()
        self._pool = self._scale = None

    def drop(self) -> None:
        """Forget every graph and what was seen."""
        self.captured.clear()
        self._seen.clear()
        self._binding = ()
        self._pool = self._scale = None

    def plan(self, state: TrainState, flame: FlameModel, key: tuple) -> str:
        """"warm" the first time ``key`` comes (an eager step on the capture
        stream, which sets up cuDNN, cuBLAS, the allocator and the
        optimizer's state there), "capture" the second, "replay" later."""
        now, was = _binding(state, flame), tuple(ref() for ref in self._binding)
        if len(was) > len(now) or any(a is not b for a, b in zip(was, now)):
            self.drop()
            was = ()
        if len(was) < len(now):  # a new binding, or the first update's optimizer tensors
            self._binding = (weakref.ref(state, _drop_on_death(self)), *(weakref.ref(x) for x in now[1:]))
        if key in self.captured:
            return "replay"
        if key in self._seen:
            return "capture"
        self._seen.add(key)
        return "warm"

    def warm(self, run: Callable, state: TrainState, flame: FlameModel, batch: Dict, scale: float):
        """An eager step on the capture stream, at the learning-rate factor
        ``scale`` read from the device as a replay reads it."""
        device = state.optimizer.params[0].device
        if self._scale is None:
            self._scale = torch.zeros((), device=device)
        self._scale.fill_(scale)
        here, side = torch.cuda.current_stream(device), _side_stream(device)
        side.wait_stream(here)
        with torch.cuda.stream(side):
            logs = run(state, flame, batch, self._scale)
        here.wait_stream(side)
        return logs

    def capture(self, key: tuple, run: Callable, state: TrainState, flame: FlameModel, batch: Dict) -> None:
        """Captures the step into a graph of its own input buffers, and the
        logs stacked into one vector."""
        inputs = {k: torch.empty_like(v) for k, v in batch.items() if isinstance(v, torch.Tensor)}
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        side = _side_stream(self._scale.device)
        with torch.cuda.graph(graph, pool=self._pool, stream=side, capture_error_mode="thread_local"):
            logs = run(state, flame, inputs, self._scale)
            names = tuple(logs)
            stacked = torch.stack([logs[k] for k in names])
        launches = tuple(n - b for n, b in zip(launch_counts(), before))
        add_launches(tuple(-n for n in launches))  # the capture launched nothing; the replay counts them
        self.captured[key] = _Captured(graph, inputs, names, stacked, launches)

    def replay(self, key: tuple, batch: Dict, scale: float) -> Dict[str, torch.Tensor]:
        """Runs the graph of ``key`` on ``batch`` at the learning-rate factor
        ``scale``; the logs are views of one copy of the graph's, which the
        next replay leaves as they are."""
        c = self.captured[key]
        for k, buf in c.inputs.items():
            buf.copy_(batch[k])
        self._scale.fill_(scale)
        c.graph.replay()
        add_launches(c.launches)
        return dict(zip(c.names, c.logs.clone().unbind()))


def build_train_step(
    loss_module: Optional[LossModule] = None,
    img_size: int = 256,
    warmup_steps: int = 0,
    with_metrics: bool = True,
    heatmap_stride: int = 4,
    heatmap_radius: int = 5,
    mesh=None,
) -> Callable:
    """Returns ``train_step(state, flame, batch, lr_mult=1.0) -> logs``,
    which updates ``state`` in place. ``lr_mult`` is the host's multiplier
    (plateau and epoch schedule); the linear warmup comes from
    ``state.step``. Logs are 0-d device tensors: ``loss``, the weighted
    losses, ``metrics/*`` (unless ``with_metrics`` is false, as when timing
    the step alone) and ``grad_norm`` (before clipping). With a distributed
    ``mesh``, ``batch`` is this rank's share of the global batch (module
    docstring). On the card the step replays CUDA graphs where it can
    (module docstring); ``train_step.graphs`` is its :class:`StepGraphs`."""
    common = _StepCommon(loss_module, img_size, heatmap_stride, heatmap_radius)
    group = data_group(mesh)
    split_heads = mesh is not None and mesh.shape["model"] > 1
    graphs = StepGraphs()

    def run(state: TrainState, flame: FlameModel, batch: Dict[str, torch.Tensor], scale) -> Dict[str, torch.Tensor]:
        """The step's device work at the learning-rate factor ``scale``."""
        state.optimizer.zero_grad()
        with fp32_exact():
            total, outputs, shared, loss_dict, targets = common.forward_and_loss(state, flame, batch, True)
            with span("dad3d.train.backward"):
                total.backward()
        if group is not None:
            with span("dad3d.train.allreduce"):
                all_reduce_gradients(state.optimizer.params, group)
        with span("dad3d.train.optimizer"):
            grad_norm = state.optimizer.step(scale, sharded_parameters(state.model) if split_heads else None)
        with span("dad3d.train.panel"):
            logs = {"loss": total, **loss_dict}
            if with_metrics:
                logs.update({f"metrics/{k}": v for k, v in common.metrics(outputs, targets, shared).items()})
            logs["grad_norm"] = grad_norm
            return _detached(logs)

    def train_step(state: TrainState, flame: FlameModel, batch: Dict[str, torch.Tensor], lr_mult: float = 1.0):
        scale = warmup_factor(state.step, warmup_steps) * float(lr_mult)
        key = graph_key(state, batch, common.loss_module.gates(state.epoch), group)
        plan = "eager" if key is None else graphs.plan(state, flame, key)
        with span("dad3d.train_step", graphed=int(plan in ("capture", "replay"))):
            if plan == "eager":
                logs = run(state, flame, batch, scale)
            elif plan == "warm":
                logs = graphs.warm(run, state, flame, batch, scale)
            else:
                if plan == "capture":
                    graphs.capture(key, run, state, flame, batch)
                logs = graphs.replay(key, batch, scale)
            state.step += 1
            return logs if group is None else all_reduce_mean(logs, group)

    train_step.graphs = graphs
    return train_step


def build_eval_step(
    loss_module: Optional[LossModule] = None,
    img_size: int = 256,
    heatmap_stride: int = 4,
    heatmap_radius: int = 5,
    mesh=None,
) -> Callable:
    """Returns ``eval_step(state, flame, batch) -> logs`` (eval mode, no
    gradients); with a distributed ``mesh`` the logs are the global batch's
    means, so that every rank takes the same decisions on them."""
    common = _StepCommon(loss_module, img_size, heatmap_stride, heatmap_radius)
    group = data_group(mesh)

    @torch.no_grad()
    def eval_step(state: TrainState, flame: FlameModel, batch: Dict[str, torch.Tensor]):
        with span("dad3d.eval_step"):
            with fp32_exact():
                total, outputs, shared, loss_dict, targets = common.forward_and_loss(state, flame, batch, False)
            with span("dad3d.train.panel"):
                logs = {"loss": total, **loss_dict}
                logs.update({f"metrics/{k}": v for k, v in common.metrics(outputs, targets, shared).items()})
            return logs if group is None else all_reduce_mean(logs, group)

    return eval_step
