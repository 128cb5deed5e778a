"""Training CLI. Port of ``dad3dheads_tpu/cli/train.py``: compose the config,
snapshot it into a timestamped experiment dir, build the loaders, fit,
evaluate the best checkpoint, export the inference weights.

Usage:
  python -m dad3dheads_tpu_torch.cli.train --config configs/train.yaml \\
      --synthetic N_STEPS [--device cuda] [--resume] [key=value overrides...]

``--synthetic`` trains on self-consistent FLAME batches generated on the
device (no dataset needed): N steps per epoch, and N // 4 (at least one)
validation batches from another seed. The dataset loaders (``FlameDataset``)
are not ported yet. One device: the config's ``mesh`` and ``distributed``
keys are not used.
"""

from __future__ import annotations

import argparse
import logging
from typing import Iterator

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
                    "item 13)", device, ignored)
    if not args.synthetic:
        raise NotImplementedError(
            "training on the dataset needs the FlameDataset loaders, the next slice of the port (ROADMAP "
            "queue 1, item 8); use --synthetic N"
        )

    flame = FlameModel.load(device=device)
    embedding = LandmarkEmbedding.load(device=device)
    batch_size = int(config.get("batch_size", 8))
    img_size = int(config.get("img_size", 256))
    train_loader = SyntheticLoader(flame, embedding, batch_size, img_size, args.synthetic, 0, device)
    val_loader = SyntheticLoader(flame, embedding, batch_size, img_size, max(args.synthetic // 4, 1), 1, device)
    Trainer(config, train_loader, val_loader, flame=flame, device=device).fit(resume=args.resume)


if __name__ == "__main__":
    main()
