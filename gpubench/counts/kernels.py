"""Least times of the port's kernels from the shapes of the work: each
input read once and each output written once over HBM, and the
operations over the float32 rate, whichever is longer (frozen from
`chip_smoke.py`'s ``gather_bound_ms``, the K2 bound of ``backward_row``,
``coords_bound_ms`` and ``bytes_bound_ms``). The same work gets the same
count whatever kernel does it.

Published peaks of one NVIDIA H100 SXM: 3.35 TB/s of HBM, 67 TFLOP/s in
float32 outside the tensor cores (TF32 is off)."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)


def k1(n: int, shapes: list[tuple[int, int]], c: int, itemsize: int = 4) -> float:
    """One fetch of ``c`` channels of planes of ``shapes`` at ``n`` points
    each: per plane the output and the plane read once, 8 bytes of
    coordinates a point; 7 flops an output value, ~30 a point."""
    nbytes = sum(n * c * itemsize + 8 * n + h * w * c * itemsize for h, w in shapes)
    flops = len(shapes) * (7 * n * c + 30 * n)
    return bound_s(nbytes, flops)


def k2(n: int, h: int, w: int, c: int, itemsize: int = 4) -> float:
    """One plane gradient of ``c`` channels from ``n`` points: the cotangent
    and the coordinates read once, the float32 gradient's channels read
    and written once; 8 flops a value, ~30 a point."""
    return bound_s(n * c * itemsize + 8 * n + 2 * h * w * c * 4, 8 * n * c + 30 * n)


def k2c(n: int, c: int, shapes: list[tuple[int, int]], itemsize: int = 4) -> float:
    """Both gradients of a fetch of planes of ``shapes``: per plane the
    cotangent, the values and the coordinates read once, the coordinate
    gradient written once, the float32 plane gradient read and written
    once; 16 flops a value, ~60 a point."""
    P, texels = len(shapes), sum(h * w for h, w in shapes)
    return bound_s(P * (n * c * itemsize + 16 * n) + texels * c * (itemsize + 8),
                   P * (16 * n * c + 60 * n))
