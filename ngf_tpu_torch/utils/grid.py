"""Voxel-grid bookkeeping math: a numpy copy of `ngf_tpu/utils/grid.py:9-35`
(`InfoInv/utils.py:74-80`, `InfoInv/models/FieldBase.py:63-74`)."""

from __future__ import annotations

import numpy as np


def n_to_reso(n_voxels: int, bbox) -> list[int]:
    """Target voxel count -> per-axis resolution (`utils.py:74-77`)."""
    bbox = np.asarray(bbox, dtype=np.float64)
    xyz_min, xyz_max = bbox[0], bbox[1]
    voxel_size = ((xyz_max - xyz_min).prod() / n_voxels) ** (1.0 / 3.0)
    return [int(v) for v in (xyz_max - xyz_min) / voxel_size]


def cal_n_samples(reso, step_ratio: float = 0.5) -> int:
    """Per-ray sample count from resolution (`utils.py:79-80`)."""
    return int(np.linalg.norm(reso) / step_ratio)


def grid_step_size(aabb, grid_size, step_ratio: float) -> float:
    """stepSize = mean(units) * step_ratio with units = size/(grid-1)
    (`FieldBase.py:66-70`)."""
    aabb = np.asarray(aabb, dtype=np.float64)
    grid_size = np.asarray(grid_size, dtype=np.float64)
    units = (aabb[1] - aabb[0]) / (grid_size - 1)
    return float(units.mean() * step_ratio)


def grid_n_samples(aabb, step_size: float) -> int:
    """nSamples = diag/stepSize + 1 (`FieldBase.py:71-72`)."""
    aabb = np.asarray(aabb, dtype=np.float64)
    diag = float(np.sqrt(np.sum((aabb[1] - aabb[0]) ** 2)))
    return int(diag / step_size) + 1
