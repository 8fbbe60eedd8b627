"""DGM diffusion training on the card (reference: accelerate launch DGM/demo.py).

Conditions come from a condition cache dir (``ConditionCache``: conditions.npy
and classes.npy) or, for smoke runs, from synthetic homographies
(--synthetic N).  Checkpoints land in --results as ``model-<step>.pt`` in
the reference layout (they load in ``dgm_sample --ckpt``); --resume
continues from the newest.  At each checkpoint milestone whose step
--preview-every divides (0: every milestone) the EMA samples a held-out
condition batch (at most 16, taken before training) into
``<results>/previews/sample-<step>.png`` and logs its masked photometric
error; --no-preview skips that.  --fuse-steps K runs up to K steps per
host call (``DGMTrainer.train_steps``: on the card one CUDA graph replay
per step), chunks ending at the milestones.

Examples:
  python -m dmhomo_torch.cli.dgm_train --conditions cache_dir --steps 112500 \\
      --batch-size 128 --lr 5e-4 --accum 8
  python -m dmhomo_torch.cli.dgm_train --synthetic 256 --accum 8 --steps 50
  python -m dmhomo_torch.cli.dgm_train --synthetic 8 --dim 8 --dim-mults 1,2 \\
      --image-size 16 --batch-size 4 --accum 2 --steps 3 --device cpu
  python -m dmhomo_torch.cli.dgm_train --synthetic 64 --accum 4 --steps 1000 \\
      --fuse-steps 10 --save-every 500 --preview-every 1000

Runs on ``cuda`` (raises without a card) unless ``--device cpu``.  The
weights start random, drawn from --seed.

Data-parallel over N cards: ``torchrun --nproc_per_node N -m
dmhomo_torch.cli.dgm_train ...`` (``nccl``; ``gloo`` with ``--device
cpu``).  --batch-size stays the global batch: every rank draws the same
global batches as one process would and takes its rows of each microbatch
(``accum * N`` must divide it); the diffusion noise comes from seed + 1 +
rank.  Only rank 0 writes checkpoints and previews; every rank samples the
same held-out batch.  ``--fuse-steps`` above 1 captures the step's
collectives, which needs ``nccl``.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np


def cache_condition_batches(cache_dir: str, batch_size: int, seed: int = 0, index: int = 0,
                            size: int = 1, accum: int = 1):
    """Endless (conditions, classes) batches drawn from a condition cache:
    of each global batch of ``batch_size``, data index ``index``'s rows
    of ``size`` (``parallel/mesh.py::shard_batch``; all of them on one
    process), read alone."""
    from dmhomo_torch.data.conditions import ConditionCache
    from dmhomo_torch.parallel.mesh import shard_batch

    cache = ConditionCache(cache_dir)
    rng = np.random.default_rng(seed)
    while True:
        idx = rng.integers(0, len(cache), (batch_size,))
        yield cache.batch(shard_batch(idx, index, size, accum) if size > 1 else idx)


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
    parser.add_argument("--fuse-steps", type=int, default=1,
                        help="optimizer steps per host call (a CUDA graph replay each)")
    parser.add_argument("--preview-every", type=int, default=0,
                        help="sample an EMA preview grid every N steps "
                             "(0 = at every checkpoint milestone)")
    parser.add_argument("--no-preview", action="store_true",
                        help="skip milestone preview sampling")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    if not (args.conditions or args.synthetic):
        parser.error("need --conditions or --synthetic")

    from dmhomo_torch.data.conditions import synthetic_condition_batches
    from dmhomo_torch.diffusion.gaussian import DiffusionConfig
    from dmhomo_torch.models.unet import UNetConfig
    from dmhomo_torch.parallel.distributed import local_device, maybe_initialize_distributed
    from dmhomo_torch.parallel.mesh import shard_batch
    from dmhomo_torch.train.config import DGMTrainConfig
    from dmhomo_torch.train.dgm_trainer import DGMTrainer

    maybe_initialize_distributed(device=args.device)
    device = local_device(args.device)

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
    trainer = DGMTrainer(cfg, device=device)
    trainer.init_state()
    if args.resume:
        trainer.load()
    mesh = trainer.mesh
    if args.conditions:  # this data index's rows of each global batch, read alone
        batches = cache_condition_batches(args.conditions, args.batch_size, args.seed,
                                          mesh.data_index, mesh.data, args.accum)
    else:
        batches = synthetic_condition_batches(args.synthetic, args.image_size, args.batch_size,
                                              args.num_classes, args.seed)

    # milestone previews (the reference Trainer samples a grid every
    # save_and_sample_every): the first global condition batch is held out
    # so that successive previews compare; save_preview logs the error
    on_milestone = None
    if not args.no_preview:
        if args.conditions:
            pv_cond, pv_cls = next(cache_condition_batches(args.conditions, args.batch_size,
                                                           args.seed))
            next(batches)  # this rank's rows of it
        else:
            pv_cond, pv_cls = next(batches)
        n_pv = min(16, len(pv_cond))
        pv_cond, pv_cls = pv_cond[:n_pv], pv_cls[:n_pv]

        def on_milestone(tr, step):
            if args.preview_every and step % args.preview_every:
                return
            tr.save_preview(pv_cond, pv_cls, f"{args.results}/previews/sample-{step}.png")

    if not args.conditions and mesh.data > 1:  # this data index's rows of each global batch
        batches = ((shard_batch(c, mesh.data_index, mesh.data, args.accum),
                    shard_batch(k, mesh.data_index, mesh.data, args.accum)) for c, k in batches)
    last = trainer.train(batches, num_steps=args.steps, on_milestone=on_milestone,
                         fuse_steps=args.fuse_steps)
    path = trainer.save()
    return {"checkpoint": path, "step": trainer.step,
            "loss": None if last is None else float(last["loss"])}


if __name__ == "__main__":
    main()
