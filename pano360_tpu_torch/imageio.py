"""Host-side image I/O (counterpart of ``pano360_tpu.imageio``).

PIL is imported inside ``imread``/``imwrite`` only: the GPU machine has
no PIL, and ``chip_smoke.py`` drives the pipeline with in-memory images.
Images are uint8 BGR at the disk boundary (the cv2 convention).
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

IMG_EXTS = (".jpg", ".png", ".bmp", ".JPG", ".PNG", ".BMP")


def list_images(path: str) -> List[str]:
    """Image files in a directory, sorted."""
    return sorted(os.path.join(path, f) for f in os.listdir(path)
                  if f.endswith(IMG_EXTS))


def imread(path: str) -> np.ndarray:
    """Load an image as uint8 BGR."""
    from PIL import Image
    img = np.asarray(Image.open(path).convert("RGB"))
    return img[..., ::-1].copy()


def imwrite(path: str, img: np.ndarray) -> None:
    """Save a uint8 BGR image."""
    from PIL import Image
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    Image.fromarray(img[..., ::-1]).save(path)


__all__ = ["IMG_EXTS", "list_images", "imread", "imwrite"]
