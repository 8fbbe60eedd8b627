"""HEM estimator training on the card (reference: accelerate launch HEM/train.py).

Reads reference-format params.json experiment dirs (--model-dir), trains on
the generated per-sample npys (--samples: by default the raw pairs go to the
device, which builds the training batch; --host-pipeline builds it on the
host, as the JAX CLI's flag does) or on synthetic pairs (--synthetic N),
evaluates on the CAHomo test layout (--test-data) every train_num_steps and
keeps the best AVG.  Stage 2: a stage-2 params.json or --stage2, and
--resume --ow from stage 1.

The training batches stream through the loader with 4 worker threads and
2 batches prefetched, as the JAX CLI's; on the card each batch is handed
over in pinned memory, so its copy runs on a copy stream, overlapping the
steps before it.

Example (CPU, tiny config):
  python -m dmhomo_torch.cli.hem_train --synthetic 64 --tiny --steps 10 --device cpu

--attn picks the attention implementation as the JAX CLI's does ('auto':
the window-attention kernel on the card, the plain path on the CPU;
'fused_block': each Swin block as one whole-block kernel, forward and
backward).  The kernels take the shipped windows only: 8x8 (64 tokens) for
the window attention, 8x8 and C in 24/48/96 for the whole block.  --tiny's
window 4 (16 tokens) therefore raises on the card under every --attn; it
trains on --device cpu through the plain versions.

--fuse-steps K (default 1) runs up to K optimizer steps per host call
(HEMTrainer.train_steps), each chunk ending at the eval boundaries, as the
JAX CLI's does.  On the card each step is then one replay of a CUDA graph of
the whole step, captured at the first chunk (whose first step runs eagerly);
on the CPU the steps run one by one.

Runs on ``cuda`` (raises without a card) unless ``--device cpu``.

Data-parallel over N cards: ``torchrun --nproc_per_node N -m
dmhomo_torch.cli.hem_train ...``.  Each process takes the card LOCAL_RANK
and joins an ``nccl`` group (``gloo`` with ``--device cpu``); the batch
size of the config (``train_batch_size``) stays the global batch, of which
each rank loads its 1/N (it must divide), and each rank evaluates its 1/N
of the test set before the ranks merge their sums.  Only rank 0 writes
checkpoints.  ``--fuse-steps`` needs ``nccl`` (the graph holds the
collectives).
"""

from __future__ import annotations

import argparse
import logging
import os


def tiny_config(steps: int, stage2: bool, model_dir: str):
    """A small config with every part of the shipped architecture."""
    from dmhomo_torch.config import EstimatorConfig, SwinConfig
    from dmhomo_torch.losses.hem_losses import LossWeights
    from dmhomo_torch.train.config import HEMTrainConfig

    swin = SwinConfig(crop_size=(32, 64), embed_dim=8, depths=(1, 1, 1), layer_depth=(3, 2, 1),
                      num_heads=(2, 2, 4), window_size=4, mlp_ratio=2.0)
    return HEMTrainConfig(
        estimator=EstimatorConfig(ori_size=(40, 72), swin=swin),
        loss=LossWeights(sup=1.0, nll=1.0) if stage2 else LossWeights(nll=1.0),
        train_batch_size=8, train_num_steps=max(steps, 1), model_dir=model_dir)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model-dir", type=str, default=None, help="dir with params.json")
    parser.add_argument("--samples", type=str, default=None, help="per-sample npy dir")
    parser.add_argument("--test-data", type=str, default=None, help="CAHomo test set dir")
    parser.add_argument("--synthetic", type=int, default=0, help="train on N synthetic pairs")
    parser.add_argument("--stage2", action="store_true")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--ow", action="store_true",
                        help="with --resume: weights only (fresh optimizer and LR staircase)")
    parser.add_argument("--restore-dir", type=str, default=None, help="checkpoint dir to resume")
    parser.add_argument("--torch-ckpt", type=str, default=None, help="init from a HEM .pth")
    parser.add_argument("--steps", type=int, default=0, help="total steps (default: epochs)")
    parser.add_argument("--tiny", action="store_true", help="tiny config")
    parser.add_argument("--host-pipeline", action="store_true",
                        help="with --samples: build the gray and flow batches on the host "
                             "instead of from the raw pairs on the device")
    parser.add_argument("--fuse-steps", type=int, default=1,
                        help="optimizer steps per host call (a CUDA graph of the step on "
                             "the card)")
    parser.add_argument("--attn", type=str, default=None,
                        choices=("auto", "xla", "pallas", "fused_block"),
                        help="attention impl (default: the config's 'auto' = the "
                             "window-attention kernel on the card, plain on the CPU)")
    parser.add_argument("--out", type=str, default="experiments/hem")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")

    import numpy as np

    from dmhomo_torch.config import Params
    from dmhomo_torch.data.hem_data import (
        CAHomoTestDataset,
        HEMTrainDataset,
        SyntheticHomoPairs,
    )
    from dmhomo_torch.data.loader import DataLoader, cycle
    from dmhomo_torch.parallel.distributed import (
        local_device,
        maybe_initialize_distributed,
        rank_and_world,
    )
    from dmhomo_torch.train.config import HEMTrainConfig
    from dmhomo_torch.train.hem_trainer import HEMTrainer

    maybe_initialize_distributed(device=args.device)
    device = local_device(args.device)
    rank, world = rank_and_world()
    if args.tiny:
        cfg = tiny_config(args.steps, args.stage2, args.out)
    elif args.model_dir:
        cfg = HEMTrainConfig.from_params(Params(os.path.join(args.model_dir, "params.json")),
                                         model_dir=args.out)
    elif args.stage2:
        cfg = HEMTrainConfig.stage2(model_dir=args.out)
    else:
        cfg = HEMTrainConfig(model_dir=args.out)
    if args.attn:
        import dataclasses

        cfg = dataclasses.replace(cfg, attn_impl=args.attn)

    if cfg.train_batch_size % world:
        raise ValueError(f"the global batch {cfg.train_batch_size} does not split over "
                         f"{world} ranks")
    crop, ori, rho = cfg.estimator.crop_size, cfg.estimator.ori_size, cfg.rho
    if args.samples:
        # the crop starts: each rank draws its own (seed + rank)
        train_ds = HEMTrainDataset(args.samples, crop_size=crop, ori_size=ori, rho=rho,
                                   rng=np.random.default_rng(args.seed + rank),
                                   device_pipeline=not args.host_pipeline)
    elif args.synthetic:
        train_ds = SyntheticHomoPairs(n=args.synthetic, crop_size=crop, ori_size=ori,
                                      rho=min(rho, 3), seed=args.seed)
    else:
        parser.error("need --samples or --synthetic")
    # each rank its rows of every global batch (the loader's shard)
    train_dl = DataLoader(train_ds, batch_size=cfg.train_batch_size // world, seed=args.seed,
                          shard_index=rank, num_shards=world, num_workers=4,
                          pin_memory=device.type == "cuda")
    steps_per_epoch = max(len(train_ds) // cfg.train_batch_size, 1)  # alike on every rank
    eval_dl = None
    if args.test_data:
        eval_dl = DataLoader(CAHomoTestDataset(args.test_data, crop_size=crop),
                             batch_size=cfg.eval_batch_size, shuffle=False, drop_last=False,
                             shard_index=rank, num_shards=world)

    trainer = HEMTrainer(cfg, steps_per_epoch=steps_per_epoch, device=device)
    trainer.init_state(args.seed)
    if args.torch_ckpt:
        from dmhomo_torch.models.convert import load_hem_checkpoint, load_reference_state_dict

        load_reference_state_dict(trainer.model, load_hem_checkpoint(args.torch_ckpt))
        trainer.logger.info(f"initialized from {args.torch_ckpt}")
    if args.resume:
        trainer.load(root=args.restore_dir or cfg.model_dir, tag="latest", weights_only=args.ow)

    total = args.steps or cfg.num_epochs * steps_per_epoch
    trainer.train_and_evaluate(cycle(train_dl), eval_loader=eval_dl, total_steps=total,
                               log_every=max(1, min(100, total)), fuse_steps=args.fuse_steps)
    path = trainer.save(tag="latest")
    trainer.logger.info(f"done: step {trainer.step}, {path}")
    return trainer


if __name__ == "__main__":
    main()
