"""Analytic synthetic scene (a copy of `ngf_tpu/data/synthetic.py`): a
ground-truth radiance field rendered to images on the host, giving the
tests and benchmarks a Blender-like dataset (same conventions as
`InfoInv/dataLoader/blender.py`: white background, near/far 2-6, bbox
[-1.5, 1.5]^3) without any data on disk.

The scene is three soft Gaussian density blobs with smoothly varying
colors — compact occupancy (so the alpha-mask/compaction machinery is
exercised realistically) and exactly representable by a radiance field
(so test PSNR is a meaningful convergence signal).
"""

from __future__ import annotations

import numpy as np

from .dataset import RayDataset
from .geometry import (
    get_ray_directions_blender,
    get_rays,
    pose_spherical,
    spherical_path,
)

# Blob parameters: centers inside the unit ball, widths small enough that
# the sigma>1 iso-surface (what `updateAlphaMask` keeps) covers a compact,
# lego-like fraction of the [-1.5, 1.5]^3 bbox — measured 2.3% occupied at
# 64^3 and p99.9 ~ 250 occupied samples per ray at the 886-sample lego
# marching geometry (vs the reference lego object's few-hundred), so the
# alpha-mask stage transition compacts the workload realistically.
_CENTERS = np.array(
    [[0.24, 0.0, -0.05], [-0.18, 0.14, 0.07], [0.0, -0.17, 0.18]], np.float32
)
_WIDTHS = np.array([0.095, 0.085, 0.08], np.float32)
_AMPS = np.array([32.0, 28.0, 30.0], np.float32)
_COLORS = np.array(
    [[0.85, 0.3, 0.2], [0.2, 0.7, 0.9], [0.9, 0.8, 0.25]], np.float32
)


def _field(pts: np.ndarray):
    """Ground-truth field: (N, 3) points -> (sigma (N,), rgb (N, 3)).

    sigma is a sum of isotropic Gaussians; rgb blends each blob's base
    color by its local density share plus a gentle positional modulation,
    clipped to [0, 1].
    """
    pts = np.asarray(pts, np.float32)
    d2 = ((pts[:, None, :] - _CENTERS[None]) ** 2).sum(-1)  # (N, 3)
    comps = _AMPS * np.exp(-d2 / (2.0 * _WIDTHS ** 2))
    sigma = comps.sum(-1)
    w = comps / (sigma[:, None] + 1e-8)
    rgb = w @ _COLORS
    rgb = rgb + 0.08 * np.sin(3.0 * pts + np.array([0.0, 2.0, 4.0], np.float32))
    return sigma.astype(np.float32), np.clip(rgb, 0.0, 1.0).astype(np.float32)


def _render_rays_gt(rays_o: np.ndarray, rays_d: np.ndarray,
                    near: float = 2.0, far: float = 6.0,
                    n_samples: int = 320, chunk: int = 8192) -> np.ndarray:
    """Numerically integrate the analytic field (white background)."""
    t = np.linspace(near, far, n_samples, dtype=np.float32)
    dt = float(t[1] - t[0])
    out = np.empty((rays_o.shape[0], 3), np.float32)
    for i in range(0, rays_o.shape[0], chunk):
        o, d = rays_o[i : i + chunk], rays_d[i : i + chunk]
        pts = o[:, None, :] + d[:, None, :] * t[None, :, None]
        sigma, rgb = _field(pts.reshape(-1, 3))
        sigma = sigma.reshape(o.shape[0], n_samples)
        rgb = rgb.reshape(o.shape[0], n_samples, 3)
        alpha = 1.0 - np.exp(-sigma * dt)
        trans = np.cumprod(1.0 - alpha + 1e-10, axis=-1)
        trans = np.concatenate([np.ones_like(trans[:, :1]), trans[:, :-1]], -1)
        weight = alpha * trans
        acc = weight.sum(-1)
        out[i : i + chunk] = (weight[..., None] * rgb).sum(-2) + (1.0 - acc)[:, None]
    return out


# Each view's ground truth by camera and image size: 30 views of 128 x 128
# take about a minute of host time to render, and a process that trains
# several runs on one scene (`chip_smoke.py`) renders each view once.
_GT_CACHE: dict[tuple, np.ndarray] = {}


def _view_gt(o: np.ndarray, d: np.ndarray, c2w: np.ndarray, wh: tuple) -> np.ndarray:
    key = (np.ascontiguousarray(c2w).tobytes(), *wh)
    if key not in _GT_CACHE:
        _GT_CACHE[key] = _render_rays_gt(o, d)
    return _GT_CACHE[key].copy()


class SyntheticDataset(RayDataset):
    """Blender-convention dataset over the analytic scene.

    Train and test splits use interleaved azimuths (test views sit halfway
    between train views) at two elevations, so held-out PSNR measures true
    novel-view generalization.
    """

    def __init__(self, datadir=None, split="train", downsample=1.0,
                 is_stack=None, n_views=None, wh=None, n_vis=-1):
        del n_vis
        # The --datadir flag doubles as the scene spec:
        #   "synthetic:views=30,wh=128[,test_views=6]"
        opts = {}
        if isinstance(datadir, str) and ":" in datadir:
            for kv in datadir.split(":", 1)[1].split(","):
                if "=" in kv:
                    k, v = kv.split("=", 1)
                    opts[k.strip()] = int(v)
        if n_views is None:
            if split == "train":
                n_views = opts.get("views", 6)
            else:
                n_views = opts.get("test_views", max(2, opts.get("views", 10) // 5))
        if wh is None:
            s = int(round(opts.get("wh", 48) / downsample))
            wh = (s, s)
        w, h = wh
        self.img_wh = (int(w), int(h))
        self.split = split
        self.is_stack = (split != "train") if is_stack is None else bool(is_stack)
        self.white_bg = True
        self.near_far = (2.0, 6.0)
        self.scene_bbox = np.array([[-1.5] * 3, [1.5] * 3], np.float32)

        camera_angle_x = 0.6911112070083618  # the Blender lego fov
        focal = 0.5 * self.img_wh[0] / np.tan(0.5 * camera_angle_x)
        dirs = get_ray_directions_blender(h, w, [focal, focal])
        self.directions = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)

        # test cameras sit between train cameras (offset azimuth AND a
        # different pair of elevations), guaranteeing genuinely novel views
        if split == "train":
            offset, elevs = 0.0, (-30.0, -12.0)
        else:
            offset, elevs = 37.5, (-24.0, -17.0)
        azim = np.linspace(-180, 180, n_views, endpoint=False) + offset
        elev = np.where(np.arange(n_views) % 2 == 0, elevs[0], elevs[1])
        self.poses = np.stack(
            [pose_spherical(a, e, 4.0) for a, e in zip(azim, elev)]
        )

        rays_list, rgbs_list = [], []
        for c2w in self.poses:
            o, d = get_rays(self.directions, c2w)
            rgb = _view_gt(o, d, c2w, self.img_wh)
            rays_list.append(np.concatenate([o, d], 1))
            rgbs_list.append(rgb)
        self._finalize(rays_list, rgbs_list)

        self.render_path = spherical_path(40, phi=-30.0, radius=4.0)


def make_synthetic_dataset(split: str, n_views: int = 6,
                           wh: tuple = (48, 48)) -> SyntheticDataset:
    """Tests/bench entry: a stacked test split or a flat train split."""
    return SyntheticDataset(split=split, n_views=n_views, wh=wh)
