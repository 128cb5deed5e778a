"""Training CLI. Port of ``dad3dheads_tpu/cli/train.py``: compose the config,
snapshot it into a timestamped experiment dir, build the loaders, fit,
evaluate the best checkpoint, export the inference weights.

Usage:
  python -m dad3dheads_tpu_torch.cli.train --config configs/train.yaml \\
      [--synthetic N_STEPS] [--device cuda] [--resume] [key=value overrides...]
  torchrun --nproc_per_node N -m dad3dheads_tpu_torch.cli.train distributed=true ...

Without ``--synthetic`` it trains on the on-disk dataset of the config's
``train`` and ``val`` entries through ``FlameDataset`` and ``DataLoader``
(``num_workers``, ``worker_mode``, ``train_percent``, ``val_percent``).
``--synthetic`` trains on self-consistent FLAME batches generated on the
device (no dataset needed): N steps per epoch, and N // 4 (at least one)
validation batches from another seed.

``distributed=true`` initialises ``torch.distributed`` from torchrun's
environment (``parallel.init_distributed``: NCCL on ``cuda:LOCAL_RANK``,
gloo with ``--device cpu``; a failed rendezvous fails the run) and builds the
config's ``mesh`` (default ``{data: -1, model: 1}``: every rank on the data
axis) over every rank's device. Each data row's loader yields its share of
the global ``batch_size`` (a model column sees its row's share, replicated;
the state is not sharded); the synthetic loader generates the global batch
from its seed and keeps the row's slice. Rank 0 makes the experiment dir and
writes every file. Without it, one device, and a mesh that is not (1, 1)
raises.
"""

from __future__ import annotations

import argparse
import logging
from typing import Any, Dict, Iterator

import torch

logger = logging.getLogger("dad3d.train")


class SyntheticLoader:
    """Iterable of ``steps`` synthetic batches, generated on ``device`` from
    a generator seeded with ``seed`` at every pass (each epoch sees the same
    batches, as the JAX loader's fixed key gives)."""

    def __init__(self, flame, embedding, batch_size: int, img_size: int, steps: int, seed: int = 0,
                 device: torch.device | str = "cuda", row: int = 0, rows: int = 1):
        if batch_size % rows:
            raise ValueError(f"global batch size {batch_size} must be divisible by the {rows} data rows")
        self.flame, self.embedding = flame, embedding
        self.batch_size, self.img_size, self.steps, self.seed = batch_size, img_size, steps, seed
        self.device = torch.device(device)
        self.row, self.rows = row, rows

    def __iter__(self) -> Iterator[dict]:
        """Each global batch, or its ``row``-th of ``rows`` slices."""
        from ..data.synthetic import synthetic_batch

        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        b = self.batch_size // self.rows
        for _ in range(self.steps):
            batch = synthetic_batch(gen, self.flame, self.embedding, self.batch_size, self.img_size)
            yield batch if self.rows == 1 else {k: v[self.row * b : (self.row + 1) * b] for k, v in batch.items()}


def build_loaders(config: Dict[str, Any], row: int = 0, rows: int = 1):
    """The train and val ``DataLoader``s of the config's ``train`` and ``val``
    datasets: ``batch_size``, ``num_workers``, ``worker_mode`` ("thread",
    clamped to the CPU count, or "process", spawned persistent workers), and
    the leading ``train_percent`` / ``val_percent`` of each index; each
    yields the ``row``-th of ``rows`` shares of every global batch."""
    from ..data.dataset import DataLoader, FlameDataset

    batch_size = int(config.get("batch_size", 64))
    num_workers = int(config.get("num_workers", 8))
    worker_mode = str(config.get("worker_mode", "thread"))
    train_ds = FlameDataset.from_config(config["train"])
    val_ds = FlameDataset.from_config({**config["val"], "train_mode": False})
    frac = float(config.get("train_percent", 1.0))
    if frac < 1.0:
        train_ds.data = train_ds.data[: max(1, int(len(train_ds.data) * frac))]
    vfrac = float(config.get("val_percent", 1.0))
    if vfrac < 1.0:
        val_ds.data = val_ds.data[: max(1, int(len(val_ds.data) * vfrac))]
    shard = {"process_index": row, "process_count": rows}
    return (
        DataLoader(train_ds, batch_size, shuffle=True, num_workers=num_workers, worker_mode=worker_mode, **shard),
        DataLoader(val_ds, batch_size, shuffle=False, num_workers=num_workers, worker_mode=worker_mode, **shard),
    )


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s - %(message)s")
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="configs/train.yaml")
    ap.add_argument("--synthetic", type=int, default=0, help="train on N synthetic steps per epoch")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("overrides", nargs="*", help="dotted key=value config overrides")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from ..core.flame import FlameModel
    from ..core.landmarks import LandmarkEmbedding
    from ..parallel import DATA_AXIS, MODEL_AXIS, init_distributed, make_mesh
    from ..train.config import load_config, prepare_experiment_dir
    from ..train.loop import Trainer

    config = load_config(args.config, args.overrides)
    if config.get("export_aot", False):  # refused before training, not after it
        from .export import check_exportable

        check_exportable((config.get("model") or {}).get("backbone", "resnet50"))
    distributed = bool(config.get("distributed"))
    device = init_distributed(args.device) if distributed else torch.device(args.device)
    try:
        mesh_cfg = config.get("mesh") or {}
        data = int(mesh_cfg.get(DATA_AXIS, -1))
        mesh = make_mesh(None if distributed else [device], data=None if data == -1 else data,
                         model=int(mesh_cfg.get(MODEL_AXIS, 1)))
        # rank 0 names (and snapshots the config into) the experiment dir
        holder = [prepare_experiment_dir(config) if not distributed or dist.get_rank() == 0 else None]
        if distributed:
            dist.broadcast_object_list(holder, src=0)
            config["experiment_dir"] = holder[0]
            logger.info("rank %d of %d on %s, mesh %s", dist.get_rank(), dist.get_world_size(), device, mesh.shape)
        logger.info("experiment dir: %s", config["experiment_dir"])
        row, rows = mesh.data_index(), mesh.shape[DATA_AXIS]
        flame = FlameModel.load(device=device)
        if args.synthetic:
            embedding = LandmarkEmbedding.load(device=device)
            batch_size = int(config.get("batch_size", 8))
            img_size = int(config.get("img_size", 256))
            train_loader = SyntheticLoader(flame, embedding, batch_size, img_size, args.synthetic, 0, device,
                                           row, rows)
            val_loader = SyntheticLoader(flame, embedding, batch_size, img_size, max(args.synthetic // 4, 1), 1,
                                         device, row, rows)
        else:
            train_loader, val_loader = build_loaders(config, row, rows)
        Trainer(config, train_loader, val_loader, flame=flame, device=device,
                mesh=mesh if distributed else None).fit(resume=args.resume)
    finally:
        if distributed:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
