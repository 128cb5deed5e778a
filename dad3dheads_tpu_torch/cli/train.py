"""Training CLI. Port of ``dad3dheads_tpu/cli/train.py``: compose the config,
snapshot it into a timestamped experiment dir, build the loaders, fit,
evaluate the best checkpoint, export the inference weights.

Usage:
  python -m dad3dheads_tpu_torch.cli.train --config configs/train.yaml \\
      [--synthetic N_STEPS] [--device cuda] [--resume] [key=value overrides...]

Without ``--synthetic`` it trains on the on-disk dataset of the config's
``train`` and ``val`` entries through ``FlameDataset`` and ``DataLoader``
(``num_workers``, ``worker_mode``, ``train_percent``, ``val_percent``).
``--synthetic`` trains on self-consistent FLAME batches generated on the
device (no dataset needed): N steps per epoch, and N // 4 (at least one)
validation batches from another seed. One device: the config's ``mesh`` and
``distributed`` keys are not used.
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
                 device: torch.device | str = "cuda"):
        self.flame, self.embedding = flame, embedding
        self.batch_size, self.img_size, self.steps, self.seed = batch_size, img_size, steps, seed
        self.device = torch.device(device)

    def __iter__(self) -> Iterator[dict]:
        from ..data.synthetic import synthetic_batch

        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        for _ in range(self.steps):
            yield synthetic_batch(gen, self.flame, self.embedding, self.batch_size, self.img_size)


def build_loaders(config: Dict[str, Any]):
    """The train and val ``DataLoader``s of the config's ``train`` and ``val``
    datasets: ``batch_size``, ``num_workers``, ``worker_mode`` ("thread",
    clamped to the CPU count, or "process", spawned persistent workers), and
    the leading ``train_percent`` / ``val_percent`` of each index."""
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
    return (
        DataLoader(train_ds, batch_size, shuffle=True, num_workers=num_workers, worker_mode=worker_mode),
        DataLoader(val_ds, batch_size, shuffle=False, num_workers=num_workers, worker_mode=worker_mode),
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

    from ..core.flame import FlameModel
    from ..core.landmarks import LandmarkEmbedding
    from ..train.config import load_config, prepare_experiment_dir
    from ..train.loop import Trainer

    config = load_config(args.config, args.overrides)
    prepare_experiment_dir(config)
    logger.info("experiment dir: %s", config["experiment_dir"])
    device = torch.device(args.device)
    ignored = [k for k in ("mesh", "distributed") if config.get(k)]
    if ignored:
        logger.info("one device (%s): config keys %s are not used (torch.distributed is ROADMAP queue 1, "
                    "'Parallel')", device, ignored)
    flame = FlameModel.load(device=device)
    if args.synthetic:
        embedding = LandmarkEmbedding.load(device=device)
        batch_size = int(config.get("batch_size", 8))
        img_size = int(config.get("img_size", 256))
        train_loader = SyntheticLoader(flame, embedding, batch_size, img_size, args.synthetic, 0, device)
        val_loader = SyntheticLoader(flame, embedding, batch_size, img_size, max(args.synthetic // 4, 1), 1,
                                     device)
    else:
        train_loader, val_loader = build_loaders(config)
    Trainer(config, train_loader, val_loader, flame=flame, device=device).fit(resume=args.resume)


if __name__ == "__main__":
    main()
