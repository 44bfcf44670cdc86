"""Host-side (numpy) camera and ray geometry: the part of
`ngf_tpu/data/geometry.py` that the synthetic scene, the Blender loader and
the evaluation path use (`InfoInv/dataLoader/ray_utils.py`, `nsvf.py:10-34`),
copied."""

from __future__ import annotations

import numpy as np


def _pixel_grid(h: int, w: int):
    """Pixel-center coordinates: the reference's kornia meshgrid + 0.5."""
    i, j = np.meshgrid(
        np.arange(w, dtype=np.float32) + 0.5,
        np.arange(h, dtype=np.float32) + 0.5,
        indexing="xy",
    )
    return i, j


def get_ray_directions(h: int, w: int, focal, center=None) -> np.ndarray:
    """OpenCV-convention camera rays (+z forward), (H, W, 3).

    `ray_utils.py:24-42`: x right, y down, z forward; NOT normalized.
    """
    i, j = _pixel_grid(h, w)
    cx, cy = center if center is not None else (w / 2, h / 2)
    return np.stack(
        [(i - cx) / focal[0], (j - cy) / focal[1], np.ones_like(i)], -1
    ).astype(np.float32)


def get_ray_directions_blender(h: int, w: int, focal, center=None) -> np.ndarray:
    """Blender/OpenGL-convention camera rays (-z forward), (H, W, 3).

    `ray_utils.py:45-63`: x right, y up, z backward; NOT normalized.
    """
    i, j = _pixel_grid(h, w)
    cx, cy = center if center is not None else (w / 2, h / 2)
    return np.stack(
        [(i - cx) / focal[0], -(j - cy) / focal[1], -np.ones_like(i)], -1
    ).astype(np.float32)


def get_rays(directions: np.ndarray, c2w: np.ndarray):
    """Camera-space direction grid + pose -> flat world rays.

    `ray_utils.py:66-87`: rotate directions by c2w[:3,:3], broadcast the
    camera origin. Directions are NOT re-normalized here.

    Returns (rays_o (H*W, 3), rays_d (H*W, 3)) float32.
    """
    c2w = np.asarray(c2w, np.float32)
    d = directions.reshape(-1, 3) @ c2w[:3, :3].T
    o = np.broadcast_to(c2w[:3, 3], d.shape)
    return np.ascontiguousarray(o, np.float32), d.astype(np.float32)


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """Blender-convention c2w on a sphere looking at the origin."""
    th, phi = np.deg2rad(theta_deg), np.deg2rad(phi_deg)
    c2w = np.eye(4)
    c2w[2, 3] = radius  # translate along z
    rot_phi = np.eye(4)
    rot_phi[1:3, 1:3] = [[np.cos(phi), -np.sin(phi)], [np.sin(phi), np.cos(phi)]]
    rot_th = np.eye(4)
    rot_th[0, 0] = rot_th[2, 2] = np.cos(th)
    rot_th[0, 2], rot_th[2, 0] = -np.sin(th), np.sin(th)
    flip = np.array(
        [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float64
    )
    return (flip @ rot_th @ rot_phi @ c2w).astype(np.float32)


def spherical_path(n: int = 40, phi: float = -30.0, radius: float = 4.0) -> np.ndarray:
    """Full orbit of ``n`` poses (`nsvf.py:92`)."""
    return np.stack(
        [pose_spherical(a, phi, radius) for a in np.linspace(-180, 180, n + 1)[:-1]]
    )
