"""Ray filtering for training: `filter_rays_bbox` of
`ngf_tpu/train/occupancy.py:193-205`. The occupancy grid, its events and
the other filters of that module come with the occupancy slice (ROADMAP.md
queue 1, item 2)."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.rays import ray_aabb_range


def filter_rays_bbox(all_rays: np.ndarray, aabb, chunk: int = 51200) -> np.ndarray:
    """Boolean keep-mask of the (N, 6) host rays whose AABB slab test hits
    (`FieldBase.py:207-213`), computed on the host."""
    aabb_t = torch.as_tensor(np.asarray(aabb, np.float32))
    rays = torch.from_numpy(np.ascontiguousarray(all_rays, np.float32))
    keep = []
    for i in range(0, rays.shape[0], chunk):
        r = rays[i : i + chunk]
        t_min, t_max = ray_aabb_range(r[:, :3], r[:, 3:6], aabb_t)
        keep.append((t_max > t_min).numpy())
    return np.concatenate(keep) if keep else np.zeros((0,), bool)
