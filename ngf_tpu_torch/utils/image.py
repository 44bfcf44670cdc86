"""Image output with the standard library and numpy only: an 8-bit PNG
writer (``zlib`` + ``struct``) and the JET depth colormap. The card's host
has no guaranteed ``cv2``, ``imageio`` or ``PIL``."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB array as a PNG (no row filtering)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png wants (H, W, 3) uint8, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", header))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def jet_colormap(x: np.ndarray) -> np.ndarray:
    """uint8 (...) -> (..., 3) uint8 JET in B, G, R order, as OpenCV's
    ``applyColorMap(x, COLORMAP_JET)`` returns it (to within one level)."""
    i = x.astype(np.int32) * 4
    b = np.clip(383 - np.abs(i - 255), 0, 255)
    g = np.clip(382 - np.abs(i - 510), 0, 255)
    r = np.clip(383 - np.abs(i - 765), 0, 255)
    return np.stack([b, g, r], axis=-1).astype(np.uint8)


def visualize_depth(depth: np.ndarray, minmax=None):
    """Depth -> JET uint8 image (`ngf_tpu/render/evaluation.py:23-36`,
    `InfoInv/utils.py:32-47`). Returns (image, [min, max])."""
    x = np.nan_to_num(depth)
    if minmax is None:
        pos = x[x > 0]
        mi = np.min(pos) if pos.size else 0.0
        ma = np.max(x) if x.size else 1.0
    else:
        mi, ma = minmax
    x = (x - mi) / (ma - mi + 1e-8)
    x = (255 * np.clip(x, 0, 1)).astype(np.uint8)
    return jet_colormap(x), [mi, ma]
