"""Image reading for the loaders: a copy of `ngf_tpu/data/image_io.py`."""

from __future__ import annotations

import numpy as np


def load_image(path: str, img_wh: tuple | None = None) -> np.ndarray:
    """Read an image to (H, W, C) float32 in [0, 1]; LANCZOS-resize to
    ``img_wh`` = (W, H) if the stored size differs (the reference resizes
    whenever downsample != 1, `InfoInv/dataLoader/blender.py:76-77`).

    Palette and grayscale images convert to RGB, or RGBA where they carry
    alpha (LA, PA), as torchvision's ToTensor sees them through PIL; the bit
    depth is normalised by the array's dtype (uint8 or uint16), not a fixed
    255.
    """
    from PIL import Image

    img = Image.open(path)
    if img.mode not in ("RGB", "RGBA"):
        img = img.convert("RGBA" if img.mode in ("LA", "PA") else "RGB")
    if img_wh is not None and img.size != tuple(img_wh):
        img = img.resize(tuple(img_wh), Image.LANCZOS)
    arr = np.asarray(img)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    elif arr.dtype == np.uint16:
        arr = arr.astype(np.float32) / 65535.0
    else:
        arr = arr.astype(np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr
