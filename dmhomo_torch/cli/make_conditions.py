"""Build the DGM condition cache on the card (the JAX package's
``cli/make_conditions.py``).

Each CAHomo training pair becomes one 12-channel condition (images, the
closed dominant-plane mask, the HSV image of the homography's flow, the
flow; ``data/conditions.py``), built in batches on the device, and the cache
is one flat (N, S, S, 12) ``conditions.npy`` beside ``classes.npy``: the
5-way scene class of each pair's CAHomo video id.

Examples:
  python -m dmhomo_torch.cli.make_conditions --trainset CAHomo/train \\
      --pseudo-labels BasesHomo_small.npy --out conditions_cache
  python -m dmhomo_torch.cli.make_conditions --synthetic 32 --out /tmp/cache
  python -m dmhomo_torch.cli.make_conditions --synthetic 6 --image-size 32 \\
      --src-hw 48,80 --out /tmp/cache --device cpu

--trainset reads the images with OpenCV, which it imports then.  Runs on
``cuda`` (raises without a card) unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import itertools
import logging

import numpy as np

log = logging.getLogger("make_conditions")


def synthetic_raw_samples(n: int, src_hw=(360, 640), seed: int = 0):
    """(img1, img2, mask, homo_f, pair_name) tuples of random uint8 images,
    a random 0/1 mask and a near-identity homography, the pair names cycling
    through the five scene classes; the JAX package's draws, in its order."""
    rng = np.random.default_rng(seed)
    h, w = src_hw
    names = ["000004", "0000032", "0000071", "000001", "000005"]  # RE LT LL SF LF
    for i in range(n):
        d = rng.normal(0, 0.005, (3, 3))
        d[2, :2] *= 1e-4
        d[2, 2] = 0.0
        img1 = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
        img2 = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
        mask = (rng.random((h, w)) > 0.3).astype(np.uint8)
        yield img1, img2, mask, np.eye(3) + d, f"{names[i % 5]}_{10000 + i}_{10002 + i}"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--trainset", type=str, default=None,
                        help="CAHomo train root (video-id dirs and the masks dir)")
    parser.add_argument("--pseudo-labels", type=str, default=None,
                        help="BasesHomo pseudo-homography dict npy")
    parser.add_argument("--masks-dir", type=str, default="HomoGAN_Bug_Masks")
    parser.add_argument("--synthetic", type=int, default=0, help="N synthetic raw pairs")
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--image-size", type=int, default=256)
    parser.add_argument("--src-hw", type=str, default="360,640")
    parser.add_argument("--limit", type=int, default=0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")

    from dmhomo_torch.data.conditions import ConditionCache, iter_cahomo_train_samples

    src_hw = tuple(int(v) for v in args.src_hw.split(","))
    if args.synthetic:
        samples = synthetic_raw_samples(args.synthetic, src_hw, args.seed)
    elif args.trainset and args.pseudo_labels:
        samples = iter_cahomo_train_samples(args.trainset, args.pseudo_labels,
                                            masks_dir=args.masks_dir)
    else:
        parser.error("need --trainset + --pseudo-labels, or --synthetic N")
    if args.limit:
        samples = itertools.islice(samples, args.limit)

    cache = ConditionCache.build(args.out, samples, image_size=args.image_size, src_hw=src_hw,
                                 device=args.device)
    counts = np.bincount(cache.classes, minlength=5)
    log.info(f"built {len(cache)} conditions -> {args.out} "
             f"(class counts RE/LT/LL/SF/LF: {counts.tolist()})")
    return cache


if __name__ == "__main__":
    main()
