"""Explode generation shards into per-sample npys (the JAX package's
``cli/make_samples.py``; reference: DGM/generate_nyps_to_single_case.py):
every pair of every shard becomes ``{index}.npy`` =
``{"img12": (6, S, S) uint8, "homo12": (3, 3)}``, which ``HEMTrainDataset``
reads.  Host only: numpy file IO.

Example:
  python -m dmhomo_torch.cli.make_samples --shards 'traindata/exp/dataset/*.npy' \\
      --out traindata/samples

The JAX CLI's --warp-check (a warp-consistency GIF per shard) is not here:
it needs an image writer and OpenCV's warpPerspective, which the card's
machine does not have.
"""

from __future__ import annotations

import argparse
import glob
import logging

log = logging.getLogger("make_samples")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--shards", type=str, required=True, help="glob of shard npys")
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--start-index", type=int, default=0)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")

    from dmhomo_torch.data.shards import explode_shards_to_samples

    paths = sorted(glob.glob(args.shards))
    if not paths:
        raise SystemExit(f"no shards match {args.shards!r}")
    n = explode_shards_to_samples(paths, args.out, start_index=args.start_index)
    log.info(f"exploded {len(paths)} shards -> {n - args.start_index} samples in {args.out}")
    return n


if __name__ == "__main__":
    main()
