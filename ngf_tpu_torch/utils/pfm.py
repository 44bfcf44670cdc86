"""PFM depth-map I/O: port of `ngf_tpu/utils/pfm.py` (the read side of
`InfoInv/dataLoader/ray_utils.py:231-266`, and a writer for round trips).
Files cross between the two packages in both directions."""

from __future__ import annotations

import re

import numpy as np


def read_pfm(filename: str) -> tuple[np.ndarray, float]:
    """Read a PFM file -> (data (H, W[, 3]) with the file's bottom-up rows
    flipped top-down, scale)."""
    with open(filename, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")

        m = re.match(r"^(\d+)\s(\d+)\s*$", f.readline().decode("utf-8"))
        if not m:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, m.groups())

        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)

        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)), scale


def write_pfm(filename: str, data: np.ndarray, scale: float = 1.0) -> None:
    """Write (H, W) or (H, W, 3) data as a little-endian PFM, rows bottom-up."""
    data = np.asarray(data, np.float32)
    color = data.ndim == 3 and data.shape[-1] == 3
    if not color and data.ndim != 2:
        raise ValueError("PFM data must be (H, W) or (H, W, 3)")
    with open(filename, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write(f"{-scale}\n".encode())  # negative: little-endian
        np.flipud(data).astype("<f4").tofile(f)
