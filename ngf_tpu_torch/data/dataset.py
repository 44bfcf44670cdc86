"""Common dataset interface: a copy of `ngf_tpu/data/dataset.py`.

A dataset is a bag of precomputed host (numpy) ray/rgb buffers with scene
metadata; the renderer moves each chunk of rays to the device itself.
"""

from __future__ import annotations

import numpy as np


class RayDataset:
    """Precomputed per-pixel rays + colors for one split.

    Attributes (set by subclasses):
      all_rays: (N_rays, 6) float32 [origin | direction] when flat
        (``is_stack=False``), or (N_images, H*W, 6) when stacked.
      all_rgbs: (N_rays, 3) flat, or (N_images, H, W, 3) stacked.
      img_wh: (W, H) ints.
      near_far: (near, far) floats.
      white_bg: bool.
      scene_bbox: (2, 3) float32 axis-aligned scene bounds.
      is_stack: bool — per-image stacking (eval splits).
      render_path: optional (T, 4, 4) novel camera path, or None.
      directions: optional (H, W, 3) per-pixel camera-space directions
        (needed by ``evaluation_path`` to cast rays for novel poses).
      poses: optional (N_images, 4, 4) or (N_images, 3, 4) c2w matrices.
    """

    all_rays: np.ndarray
    all_rgbs: np.ndarray
    img_wh: tuple
    near_far: tuple
    white_bg: bool
    scene_bbox: np.ndarray
    is_stack: bool
    render_path = None
    directions = None
    poses = None

    @property
    def n_images(self) -> int:
        if getattr(self, "is_stack", False):
            return int(self.all_rays.shape[0])
        w, h = self.img_wh
        return int(self.all_rays.shape[0] // (w * h))

    def __len__(self) -> int:
        return int(self.all_rgbs.shape[0])

    def _finalize(self, rays_list, rgbs_list):
        """Stack or flatten the per-image buffers (`blender.py:89-97`)."""
        w, h = self.img_wh
        if self.is_stack:
            self.all_rays = np.stack(rays_list, 0).astype(np.float32)
            self.all_rgbs = (
                np.stack(rgbs_list, 0).reshape(-1, h, w, 3).astype(np.float32)
            )
        else:
            self.all_rays = np.concatenate(rays_list, 0).astype(np.float32)
            self.all_rgbs = np.concatenate(rgbs_list, 0).astype(np.float32)
