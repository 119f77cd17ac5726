"""Standalone feature extraction + matching CLI (counterpart of
``pano360_tpu.features_cli``).

Extracts and matches at half resolution and writes ``matches_{name}.npz``
in the stitcher's cache format; ``--visualize I J`` also writes a match
overlay of one pair.

Usage: ``python -m pano360_tpu_torch.features_cli --path <dir>
[--detector msop] [--device cpu]``
"""
from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from pano360_tpu_torch import resolve_device
from pano360_tpu_torch.cli import load_images
from pano360_tpu_torch.pipeline import matching


def main(argv=None):
    parser = argparse.ArgumentParser(description="Extract features.")
    parser.add_argument("--path", type=str, default="../data/ppwwyyxx/CMU2",
                        help="directory with the images to process.")
    parser.add_argument("--detector", default="sift",
                        choices=["sift", "msop"])
    parser.add_argument("--visualize", nargs=2, type=int, default=None,
                        metavar=("I", "J"),
                        help="write a match-overlay image for pair (I, J).")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda).")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    name = os.path.basename(args.path)
    imgs = load_images(args.path, 2, device)   # half resolution
    kpts, matches = matching(imgs, device, detector=args.detector)
    np.savez(f"matches_{name}.npz", kpts=kpts, matches=matches)
    print(f"saved matches_{name}.npz")

    if args.visualize is not None:
        i, j = args.visualize
        md = matches.item()
        if i not in md or j not in md[i]:
            raise SystemExit(f"no match edge between images {i} and {j}")
        from pano360_tpu_torch.imageio import imwrite
        from pano360_tpu_torch.viz import match_images
        idx, _ = md[i][j]
        cent_i = np.array([imgs[i].shape[1] / 2, imgs[i].shape[0] / 2])
        cent_j = np.array([imgs[j].shape[1] / 2, imgs[j].shape[0] / 2])
        overlay = match_images(imgs[i], imgs[j],
                               kpts[i][idx[:, 0]] + cent_i,
                               kpts[j][idx[:, 1]] + cent_j)
        out = f"matches_{name}_{i}_{j}.png"
        imwrite(out, overlay)
        print(f"saved {out} ({len(idx)} inlier matches)")


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
