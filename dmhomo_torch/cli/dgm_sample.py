"""DGM training-set generation on the card (reference: python DGM/dgm_sample.py).

Each batch of conditions drives one DDIM chain through the conditional UNet
(classifier-free guidance as one doubled batch), the condition flows get
their homographies fitted (``fit_homography_to_flow``), and the pairs land
in reference-format shards (CHW uint8) under ``OUT/EXP/dataset``.
--shard-index / --num-shards slice the condition set, one process per card.

Examples:
  python -m dmhomo_torch.cli.dgm_sample --torch-ckpt DGM.pt --conditions cache \\
      --s-step 32 --bs 25 --exp generate_trainset
  python -m dmhomo_torch.cli.dgm_sample --synthetic 64 --exp smoke --batches 2
  python -m dmhomo_torch.cli.dgm_sample --synthetic 8 --dim 8 --dim-mults 1,2 \\
      --image-size 16 --s-step 4 --bs 2 --exp smoke --batches 2 --device cpu

Runs on ``cuda`` (raises without a card) unless ``--device cpu``.  Without
--torch-ckpt the weights are random, drawn from --seed.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

log = logging.getLogger("dgm_sample")


def build_sampler(dim: int = 64, dim_mults=(1, 2, 4, 8), num_classes: int = 1,
                  image_size: int = 256, s_step: int = 32, cond_scale: float = 3.0,
                  dtype=torch.bfloat16, device=None, seed: int = 0, torch_ckpt=None):
    """The shipped sampler: UNet (bf16 activations, fp32 parameters) and a
    GaussianDiffusion with T=1000, cosine betas, pred_x0, eta 1.  Weights
    from a reference DGM.pt (EMA) or drawn from ``seed``."""
    from dmhomo_torch.diffusion.gaussian import DiffusionConfig, GaussianDiffusion
    from dmhomo_torch.models.convert import load_dgm_checkpoint
    from dmhomo_torch.models.unet import UNetConfig, build_unet
    from dmhomo_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg = UNetConfig(dim=dim, num_classes=num_classes, dim_mults=tuple(dim_mults), dtype=dtype)
    model = build_unet(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    if torch_ckpt:
        step = load_dgm_checkpoint(model, torch_ckpt, use_ema=True)
        log.info("loaded reference checkpoint %s, step %d", torch_ckpt, step)
    else:
        log.warning("no checkpoint given: sampling from random weights (seed %d)", seed)
    model = model.to(dev).eval()
    return GaussianDiffusion(model, DiffusionConfig(
        image_size=image_size, timesteps=1000, sampling_timesteps=s_step,
        objective="pred_x0", cond_scale=cond_scale), device=dev)


def generate(gd, cond: torch.Tensor, classes: torch.Tensor, generator=None):
    """One batch: conditions (B, S, S, 12) in [0, 1] and classes (B,) ->
    (images (B, S, S, 6) in [0, 1], fitted homographies (B, 3, 3))."""
    from dmhomo_torch.geometry.homography import fit_homography_to_flow

    imgs = gd.sample(classes, cond[..., 7:10], cond[..., 6:7], generator=generator)
    return imgs, fit_homography_to_flow(cond[..., 10:12])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--torch-ckpt", type=str, default=None, help="reference DGM.pt")
    parser.add_argument("--conditions", type=str, default=None, help="condition cache dir")
    parser.add_argument("--synthetic", type=int, default=0, help="N synthetic conditions")
    parser.add_argument("--s-step", type=int, default=32)
    parser.add_argument("--bs", type=int, default=25)
    parser.add_argument("--exp", type=str, required=True)
    parser.add_argument("--shard-index", type=int, default=0)
    parser.add_argument("--num-shards", type=int, default=1)
    parser.add_argument("--batches", type=int, default=0,
                        help="0 = until the conditions run out (synthetic: 4)")
    parser.add_argument("--batches-per-shard", type=int, default=2)
    parser.add_argument("--dim", type=int, default=64)
    parser.add_argument("--dim-mults", type=str, default="1,2,4,8",
                        help="comma-separated UNet stage multipliers")
    parser.add_argument("--image-size", type=int, default=256)
    parser.add_argument("--num-classes", type=int, default=1)
    parser.add_argument("--cond-scale", type=float, default=3.0)
    parser.add_argument("--out", type=str, default="traindata")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")

    from dmhomo_torch.data.shards import save_generation_shard, shard_filename

    if args.conditions:
        from dmhomo_torch.data.conditions import ConditionCache

        cache = ConditionCache(args.conditions)
        idxs = np.arange(len(cache))[args.shard_index::args.num_shards]

        def get_batch(b):
            return cache.batch(idxs[b * args.bs:(b + 1) * args.bs])

        max_batches = len(idxs) // args.bs
    elif args.synthetic:
        from dmhomo_torch.data.conditions import synthetic_condition_batches

        batches = synthetic_condition_batches(args.synthetic, args.image_size, args.bs,
                                              args.num_classes, args.seed)

        def get_batch(b):
            return next(batches)

        max_batches = args.batches or 4
    else:
        parser.error("need --conditions or --synthetic")
    if args.batches:
        max_batches = min(max_batches, args.batches)

    gd = build_sampler(args.dim, [int(m) for m in args.dim_mults.split(",")], args.num_classes,
                       args.image_size, args.s_step, args.cond_scale, device=args.device,
                       seed=args.seed, torch_ckpt=args.torch_ckpt)
    dev = gd.schedule.betas.device
    generator = torch.Generator(device=dev).manual_seed(args.seed + args.shard_index)

    out_dir = os.path.join(args.out, args.exp, "dataset")
    os.makedirs(out_dir, exist_ok=True)
    pending, paths, part, done, total = [], [], 0, 0, 0
    t_start = time.perf_counter()

    def flush():
        path = os.path.join(out_dir, shard_filename(args.shard_index, 0, part, total))
        save_generation_shard(path, pending)
        paths.append(path)
        log.info("wrote %s (%d samples in all)", path, total)

    for b in range(max_batches):
        cond, classes = get_batch(b)
        if cond.shape[0] < args.bs:
            break
        imgs, homos = generate(gd, torch.from_numpy(np.asarray(cond)).to(dev),
                               torch.from_numpy(np.asarray(classes, np.int64)).to(dev), generator)
        imgs = imgs.float().cpu().numpy()
        imgs_u8 = (np.clip(imgs, 0, 1) * 255).astype(np.uint8).transpose(0, 3, 1, 2)
        pending.append({"imgs": imgs_u8, "homos": homos.cpu().numpy()})
        done += imgs_u8.shape[0]
        total += imgs_u8.shape[0]
        if len(pending) >= args.batches_per_shard:
            flush()
            pending, part = [], part + 1
        if b == 0:  # the first batch builds the kernels: not counted in the rate
            t_start, done = time.perf_counter(), 0
    if pending:
        flush()
    dt = time.perf_counter() - t_start
    rate = done / dt if done and dt > 0 else None
    if rate:
        log.info("throughput: %.3f samples/s at s_step=%d (first batch excluded)",
                 rate, args.s_step)
    return {"shards": paths, "samples": total, "samples_per_s": rate}


if __name__ == "__main__":
    main()
