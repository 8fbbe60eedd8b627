"""Explode generation shards into per-sample npys (the JAX package's
``cli/make_samples.py``; reference: DGM/generate_nyps_to_single_case.py):
every pair of every shard becomes ``{index}.npy`` =
``{"img12": (6, S, S) uint8, "homo12": (3, 3)}``, which ``HEMTrainDataset``
reads: numpy file IO on the host.

``--warp-check DIR`` writes a warp-consistency flip GIF of each shard's first
pair, ``DIR/<shard name>.gif`` (the reference's unit_test/,
generate_nyps_to_single_case.py:8-19): [img1 | img1 warped by its H] against
[img2 | img2].  The warp is cv2.warpPerspective's, computed by
``utils/viz.py::warp_check_gif`` on ``--device`` (default the card; no
OpenCV), the GIF written by ``utils/codecs.py``.

Example:
  python -m dmhomo_torch.cli.make_samples --shards 'traindata/exp/dataset/*.npy' \\
      --out traindata/samples [--warp-check unit_test]
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
    parser.add_argument("--warp-check", type=str, default=None, metavar="DIR",
                        help="write a per-shard warp-consistency flip GIF of the first sample")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where --warp-check warps (the card unless 'cpu')")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")

    from dmhomo_torch.data.shards import explode_shards_to_samples

    paths = sorted(glob.glob(args.shards))
    if not paths:
        raise SystemExit(f"no shards match {args.shards!r}")
    n = explode_shards_to_samples(paths, args.out, start_index=args.start_index)
    log.info(f"exploded {len(paths)} shards -> {n - args.start_index} samples in {args.out}")
    if args.warp_check:
        import os

        import numpy as np

        from dmhomo_torch.data.shards import load_generation_shard
        from dmhomo_torch.utils.device import resolve_device
        from dmhomo_torch.utils.viz import warp_check_gif

        device = resolve_device(args.device)
        for sp in paths:
            batch = load_generation_shard(sp)[0]
            name = os.path.splitext(os.path.basename(sp))[0]
            gif = warp_check_gif(os.path.join(args.warp_check, f"{name}.gif"), batch["imgs"][0],
                                 np.asarray(batch["homos"][0]), device=device)
            log.info(f"warp check: {gif}")
    return n


if __name__ == "__main__":
    main()
