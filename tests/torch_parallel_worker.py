"""One rank of a ``torch.distributed`` world for the port's parallel checks.
It imports the port and torch, never JAX.

    python tests/torch_parallel_worker.py --rank R --world W --port P \\
        --device cpu|cuda:0 --tasks bn,step,tp --work DIR

gloo on every device (two ranks may share one card, which NCCL refuses).
The process group waits at most ``--timeout`` seconds, so a rank that dies
fails the world instead of hanging it. Each task writes
``DIR/<task>_rank<R>.pt``:

- ``bn``: the port's ``BatchNorm2d`` over the group's global batch on this
  rank's half of :func:`bn_inputs`: outputs, input gradients, the
  weight and bias gradients of ``sum(y * probe)``, and the running
  statistics after two forwards; and, under a group of one rank, whether its
  running variance equals the plain ``BatchNorm2d``'s bit for bit.
- ``step``: ``--steps`` train steps of the ``spec``'s model from
  ``DIR/state.pt`` on this rank's rows of ``DIR/batch.pt`` (the global
  batch) on a data-parallel mesh: each step's logs, the state dict and the
  optimizer state after the first step, and the kernels' launches.
- ``tp``: one step with the three heads split over a (1, W) mesh's model
  group, and the same step replicated, from ``DIR/state.pt`` on all of
  ``DIR/batch.pt``: both steps' logs, the updated head weights (the split
  ones gathered), and the gathered state dict's keys and shapes.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dad3dheads_tpu_torch.core import FlameModel  # noqa: E402
from dad3dheads_tpu_torch.models import create_model  # noqa: E402
from dad3dheads_tpu_torch.models.resnet import BatchNorm2d  # noqa: E402
from dad3dheads_tpu_torch.ops import blendshapes  # noqa: E402
from dad3dheads_tpu_torch.parallel import gather_state_dict, make_mesh, set_sync_bn, shard_heads  # noqa: E402
from dad3dheads_tpu_torch.train import TrainState, build_train_step, get_optimizer  # noqa: E402

BN_B, BN_C, BN_S = 8, 6, 64


def bn_inputs(seed: int = 0):
    """(x, probe): (8, 6, 64, 64) fp32 activations whose channels' means
    reach 60 times their spreads (0.1 to 3), and a probe for the
    loss ``sum(y * probe)``."""
    rng = np.random.default_rng(seed)
    mean = np.array([0.0, 1.0, -5.0, 10.0, 30.0, 3.0], np.float32).reshape(1, BN_C, 1, 1)
    spread = np.array([1.0, 0.1, 3.0, 0.2, 0.5, 1.0], np.float32).reshape(1, BN_C, 1, 1)
    x = (rng.normal(size=(BN_B, BN_C, BN_S, BN_S)) * spread + mean).astype(np.float32)
    probe = rng.normal(size=x.shape).astype(np.float32)
    return x, probe


def bn_run(bn: BatchNorm2d, x: np.ndarray, probe: np.ndarray, device) -> dict:
    """Two train-mode forwards of ``bn`` (the first with the backward of
    ``sum(y * probe)``): y, dx, dweight, dbias, and the running statistics
    after both."""
    bn = bn.to(device).train()
    xt = torch.from_numpy(x).to(device).contiguous(memory_format=torch.channels_last).requires_grad_(True)
    y = bn(xt)
    (y * torch.from_numpy(probe).to(device)).sum().backward()
    bn(xt.detach())
    return {"y": y.detach().cpu(), "dx": xt.grad.cpu(), "dweight": bn.weight.grad.cpu(),
            "dbias": bn.bias.grad.cpu(), "running_mean": bn.running_mean.cpu(),
            "running_var": bn.running_var.cpu()}


def _bn_task(args, rank: int, world: int, device) -> dict:
    x, probe = bn_inputs()
    b = BN_B // world
    rows = slice(rank * b, (rank + 1) * b)
    mesh = make_mesh([device] * world)
    out = bn_run(set_sync_bn(BatchNorm2d(BN_C), mesh.data_group), x[rows], probe[rows], device)
    singles = [dist.new_group([r]) for r in range(world)]  # collective: every rank makes each
    alone = set_sync_bn(BatchNorm2d(BN_C), singles[rank])
    plain = BatchNorm2d(BN_C)
    out["single_rank_group_is_local"] = alone.sync_group is None
    out["single_rank_running_var_equal"] = torch.equal(
        bn_run(alone, x[rows], probe[rows], device)["running_var"],
        bn_run(plain, x[rows], probe[rows], device)["running_var"])
    return out


def _state(spec: dict, work: str, device):
    model = create_model(spec["model"])
    model.load_state_dict(torch.load(os.path.join(work, "state.pt")))
    return model.to(device)


def _launches() -> dict:
    return {"blend_shapes_fused": blendshapes.blend_shapes_fused.launches,
            "blend_shapes_fused_backward": blendshapes.blend_shapes_fused_backward.launches}


def _step_task(args, rank: int, world: int, device, spec: dict) -> dict:
    mesh = make_mesh([device] * world)
    batch = torch.load(os.path.join(args.work, "batch.pt"))
    b = next(iter(batch.values())).shape[0] // world
    i = mesh.data_index()
    local = {k: v[i * b : (i + 1) * b].to(device) for k, v in batch.items()}
    model = set_sync_bn(_state(spec, args.work, device), mesh.data_group)
    state = TrainState(model, get_optimizer(spec["optimizer"], model.parameters(),
                                            gradient_clip_val=spec["clip"]))
    step = build_train_step(img_size=spec["img_size"], warmup_steps=spec["warmup"], mesh=mesh)
    flame = FlameModel.load(device=device)
    blendshapes.blend_shapes_fused.launches = blendshapes.blend_shapes_fused_backward.launches = 0
    logs, first = [], None
    for _ in range(args.steps):
        logs.append({k: float(v) for k, v in step(state, flame, local).items()})
        if first is None:
            first = {"state_dict": {k: v.cpu() for k, v in model.state_dict().items()},
                     "optimizer": state.optimizer.state_dict()}
    return {"logs": logs, **first, "launches": _launches()}


def _tp_task(args, rank: int, world: int, device, spec: dict) -> dict:
    batch = {k: v.to(device) for k, v in torch.load(os.path.join(args.work, "batch.pt")).items()}
    flame = FlameModel.load(device=device)
    heads = [f"{h}.logit_image.{i}.weight" for h in ("shape", "pose", "landmarks") for i in (0, 3)]
    out = {}
    for name, mesh in (("replicated", None), ("split", make_mesh([device] * world, model=world))):
        model = _state(spec, args.work, device)
        if mesh is not None:
            shard_heads(model, mesh)
            out["shard_shapes"] = {k: tuple(v.shape) for k, v in model.state_dict().items() if k in heads}
        state = TrainState(model, get_optimizer(spec["optimizer"], model.parameters(),
                                                gradient_clip_val=spec["clip"]))
        step = build_train_step(img_size=spec["img_size"], warmup_steps=spec["warmup"], mesh=mesh)
        blendshapes.blend_shapes_fused.launches = blendshapes.blend_shapes_fused_backward.launches = 0
        out[f"{name}_logs"] = {k: float(v) for k, v in step(state, flame, batch).items()}
        out[f"{name}_launches"] = _launches()
        sd = gather_state_dict(model) if mesh is not None else model.state_dict()
        out[f"{name}_heads"] = {k: sd[k].cpu() for k in heads}
        out[f"{name}_layout"] = {k: tuple(v.shape) for k, v in sd.items()}
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class World:
    """``world`` ranks of this script on ``tasks``, started at once (the
    caller may work meanwhile); :meth:`results` waits for them."""

    def __init__(self, tasks: str, work: str, world: int = 2, device: str = "cpu", spec: dict | None = None,
                 steps: int = 1):
        import subprocess

        self.tasks, self.work, self.world = tasks.split(","), work, world
        port = free_port()
        self.procs = [
            subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r), "--world", str(world),
                              "--port", str(port), "--device", device, "--tasks", tasks, "--work", work,
                              "--spec", json.dumps(spec or {}), "--steps", str(steps)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]

    def results(self, timeout: float = 300.0) -> list:
        """Each rank's outputs, ``[{task: out}, ...]``. Every rank is waited
        for at most ``timeout`` seconds and killed after; a rank that fails
        raises with its output."""
        logs = []
        try:
            for p in self.procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            self.stop()
        for r, (p, log) in enumerate(zip(self.procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} exited with {p.returncode}:\n{log[-4000:]}")
        return [{t: torch.load(os.path.join(self.work, f"{t}_rank{r}.pt")) for t in self.tasks}
                for r in range(self.world)]

    def stop(self) -> None:
        """Kill the ranks that are still running and reap them."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--tasks", default="bn")
    ap.add_argument("--work", required=True)
    ap.add_argument("--spec", default="{}", help="JSON: model, optimizer, clip, warmup, img_size")
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--timeout", type=float, default=60.0)
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cpu":
        torch.set_num_threads(2)  # beside other test processes
    else:
        torch.cuda.set_device(device)
        torch.backends.cudnn.deterministic = True  # the tasks compare two runs of one step
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{args.port}", rank=args.rank,
                            world_size=args.world, timeout=datetime.timedelta(seconds=args.timeout))
    spec = json.loads(args.spec)
    try:
        for task in args.tasks.split(","):
            if task == "bn":
                out = _bn_task(args, args.rank, args.world, device)
            elif task == "step":
                out = _step_task(args, args.rank, args.world, device, spec)
            elif task == "tp":
                out = _tp_task(args, args.rank, args.world, device, spec)
            else:
                raise KeyError(task)
            torch.save(out, os.path.join(args.work, f"{task}_rank{args.rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
