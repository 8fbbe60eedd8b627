"""Extract the frames of CAHomo videos (the JAX package's
``cli/video_to_frames.py``; reference: python video2img.py).

Each video ``NAME.ext`` becomes ``OUT/NAME/{offset + i}.png``, frame ids
offset by +10000 as the reference numbers them (video2img.py:5-35).  Video
decoding needs OpenCV, imported when the command runs; host only.

Example:
  python -m dmhomo_torch.cli.video_to_frames --videos 'CAHomo/*.mp4' --out frames/
"""

from __future__ import annotations

import argparse
import glob
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--videos", type=str, required=True, help="glob of video files")
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--offset", type=int, default=10000)
    args = parser.parse_args(argv)

    import cv2

    from dmhomo_torch.utils.logging import get_logger

    logger = get_logger("video_to_frames")
    counts = {}
    for vid_path in sorted(glob.glob(args.videos)):
        name = os.path.splitext(os.path.basename(vid_path))[0]
        out_dir = os.path.join(args.out, name)
        os.makedirs(out_dir, exist_ok=True)
        cap = cv2.VideoCapture(vid_path)
        i = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            cv2.imwrite(os.path.join(out_dir, f"{args.offset + i}.png"), frame)
            i += 1
        cap.release()
        counts[name] = i
        logger.info(f"{name}: {i} frames")
    return counts


if __name__ == "__main__":
    main()
