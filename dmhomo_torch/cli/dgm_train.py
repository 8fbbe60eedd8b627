"""DGM diffusion training on the card (reference: accelerate launch DGM/demo.py).

Conditions come from a condition cache dir (``ConditionCache``: conditions.npy
and classes.npy) or, for smoke runs, from synthetic homographies
(--synthetic N).  Checkpoints land in --results as ``model-<step>.pt`` in
the reference layout (they load in ``dgm_sample --torch-ckpt``); --resume
continues from the newest.

Examples:
  python -m dmhomo_torch.cli.dgm_train --conditions cache_dir --steps 112500 \\
      --batch-size 128 --lr 5e-4 --accum 8
  python -m dmhomo_torch.cli.dgm_train --synthetic 256 --accum 8 --steps 50
  python -m dmhomo_torch.cli.dgm_train --synthetic 8 --dim 8 --dim-mults 1,2 \\
      --image-size 16 --batch-size 4 --accum 2 --steps 3 --device cpu

Runs on ``cuda`` (raises without a card) unless ``--device cpu``.  The
weights start random, drawn from --seed.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np


def cache_condition_batches(cache_dir: str, batch_size: int, seed: int = 0):
    """Endless (conditions, classes) batches drawn from a condition cache."""
    from dmhomo_torch.data.conditions import ConditionCache

    cache = ConditionCache(cache_dir)
    rng = np.random.default_rng(seed)
    while True:
        yield cache.batch(rng.integers(0, len(cache), (batch_size,)))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--conditions", type=str, default=None, help="ConditionCache dir")
    parser.add_argument("--synthetic", type=int, default=0, help="use N synthetic conditions")
    parser.add_argument("--steps", type=int, default=112_500)
    parser.add_argument("--batch-size", type=int, default=128, help="global batch")
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--dim", type=int, default=64)
    parser.add_argument("--dim-mults", type=str, default="1,2,4,8",
                        help="comma-separated UNet stage multipliers")
    parser.add_argument("--image-size", type=int, default=256)
    parser.add_argument("--num-classes", type=int, default=5)
    parser.add_argument("--timesteps", type=int, default=1000)
    parser.add_argument("--s-step", type=int, default=32)
    parser.add_argument("--accum", type=int, default=1, help="microbatches per step")
    parser.add_argument("--remat", action="store_true",
                        help="recompute UNet blocks in the backward (bigger microbatches)")
    parser.add_argument("--no-bf16", action="store_true")
    parser.add_argument("--results", type=str, default="results/dgm")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--save-every", type=int, default=500)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    if not (args.conditions or args.synthetic):
        parser.error("need --conditions or --synthetic")

    from dmhomo_torch.data.conditions import synthetic_condition_batches
    from dmhomo_torch.diffusion.gaussian import DiffusionConfig
    from dmhomo_torch.models.unet import UNetConfig
    from dmhomo_torch.train.config import DGMTrainConfig
    from dmhomo_torch.train.dgm_trainer import DGMTrainer

    cfg = DGMTrainConfig(
        unet=UNetConfig(dim=args.dim, num_classes=args.num_classes,
                        dim_mults=tuple(int(m) for m in args.dim_mults.split(",")),
                        remat=args.remat),
        diffusion=DiffusionConfig(image_size=args.image_size, timesteps=args.timesteps,
                                  sampling_timesteps=args.s_step, objective="pred_x0",
                                  loss_type="l1"),
        train_batch_size=args.batch_size, lr=args.lr, train_num_steps=args.steps,
        gradient_accumulate_every=args.accum, save_every=args.save_every,
        results_dir=args.results, seed=args.seed, bf16=not args.no_bf16)
    trainer = DGMTrainer(cfg, device=args.device)
    trainer.init_state()
    if args.resume:
        trainer.load()
    if args.conditions:
        batches = cache_condition_batches(args.conditions, args.batch_size, args.seed)
    else:
        batches = synthetic_condition_batches(args.synthetic, args.image_size, args.batch_size,
                                              args.num_classes, args.seed)
    last = trainer.train(batches, num_steps=args.steps)
    path = trainer.save()
    return {"checkpoint": path, "step": trainer.step,
            "loss": None if last is None else float(last["loss"])}


if __name__ == "__main__":
    main()
