"""Host-side (numpy) camera and ray geometry of the loaders: a copy of
`ngf_tpu/data/geometry.py` (`InfoInv/dataLoader/ray_utils.py` direction
grids, world rays and the NDC projection; the camera paths of the loaders,
`llff.py:81-119` spiral, `nsvf.py:10-34` spherical, `tankstemple.py:11-84`
circular look-at). It runs once at dataset-build time on the host; the
device only sees the resulting (N, 6) ray buffers.
"""

from __future__ import annotations

import numpy as np


def normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


# --------------------------------------------------------------------------
# per-pixel direction grids (`ray_utils.py:24-63`)


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
    camera origin. Directions are NOT re-normalized here (loaders that
    want unit rays normalize the grid once up front).

    Returns (rays_o (H*W, 3), rays_d (H*W, 3)) float32.
    """
    c2w = np.asarray(c2w, np.float32)
    d = directions.reshape(-1, 3) @ c2w[:3, :3].T
    o = np.broadcast_to(c2w[:3, 3], d.shape)
    return np.ascontiguousarray(o, np.float32), d.astype(np.float32)


def ndc_rays_blender(h: int, w: int, focal: float, near: float,
                     rays_o: np.ndarray, rays_d: np.ndarray):
    """Shift origins to the near plane and project to NDC
    (`ray_utils.py:90-107`, the original NeRF LLFF transform)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    sx, sy = -1.0 / (w / (2.0 * focal)), -1.0 / (h / (2.0 * focal))
    o0 = sx * rays_o[..., 0] / rays_o[..., 2]
    o1 = sy * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = sx * (rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = sy * (rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]
    return (
        np.stack([o0, o1, o2], -1).astype(np.float32),
        np.stack([d0, d1, d2], -1).astype(np.float32),
    )


# --------------------------------------------------------------------------
# LLFF pose centering + spiral path (`llff.py:17-119`)


def average_poses(poses: np.ndarray) -> np.ndarray:
    """Mean camera pose (3, 4): mean center, mean z, y via double cross."""
    center = poses[..., 3].mean(0)
    z = normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = normalize(np.cross(z, y_))
    y = np.cross(x, z)
    return np.stack([x, y, z, center], 1)


def center_poses(poses: np.ndarray, blender2opencv: np.ndarray):
    """Re-express all poses relative to the average pose (`llff.py:54-78`)."""
    poses = poses @ blender2opencv
    avg_homo = np.eye(4)
    avg_homo[:3] = average_poses(poses)
    last = np.tile(np.array([0, 0, 0, 1.0]), (len(poses), 1, 1))
    poses_homo = np.concatenate([poses, last], 1)
    centered = np.linalg.inv(avg_homo) @ poses_homo
    return centered[:, :3], avg_homo


def viewmatrix(z: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Look-along-z camera frame as a 4x4 (`llff.py:81-88`)."""
    vec2 = normalize(z)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    m = np.eye(4)
    m[:3] = np.stack([-vec0, vec1, vec2, pos], 1)
    return m


def render_path_spiral(c2w, up, rads, focal, zrate=0.5, n_rots=2, n=120):
    """Spiral of cameras around the average pose (`llff.py:91-99`)."""
    rads = np.array(list(rads) + [1.0])
    out = []
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n + 1)[:-1]:
        c = c2w[:3, :4] @ (
            np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0])
            * rads
        )
        z = normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        out.append(viewmatrix(z, up, c))
    return np.stack(out)


def get_spiral(c2ws_all: np.ndarray, near_fars: np.ndarray,
               rads_scale: float = 1.0, n_views: int = 120) -> np.ndarray:
    """Forward-facing render path (`llff.py:102-119`)."""
    c2w = average_poses(c2ws_all)
    up = normalize(c2ws_all[:, :3, 1].sum(0))
    dt = 0.75
    close, far = near_fars.min() * 0.9, near_fars.max() * 5.0
    focal = 1.0 / ((1.0 - dt) / close + dt / far)
    rads = np.percentile(np.abs(c2ws_all[:, :3, 3]), 90, 0) * rads_scale
    return render_path_spiral(c2w, up, rads, focal, zrate=0.5, n=n_views)


# --------------------------------------------------------------------------
# spherical path (blender/nsvf test orbits, `nsvf.py:10-34`)


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


# --------------------------------------------------------------------------
# circular look-at path (`tankstemple.py:11-84`)


def look_at_rotation(campos: np.ndarray, at=(0, 0, 0), up=(0, -1, 0)) -> np.ndarray:
    """Rotation whose columns are the camera x/y/z axes in world coords."""
    at = np.asarray(at, np.float64)
    up = np.asarray(up, np.float64)
    z = normalize(at - campos)
    x = normalize(np.cross(up, z))
    y = normalize(np.cross(z, x))
    return np.stack([x, y, z], 1)


def circle_path(radius: float = 3.5, h: float = 0.0, axis: str = "y",
                up=(0, -1, 0), frames: int = 200) -> np.ndarray:
    """Cameras on a circle, each looking at the origin (`tankstemple.py:
    76-84` ``gen_path(circle(...))``)."""
    out = []
    for t in range(frames):
        ang = t * (360.0 / frames) * np.pi / 180.0
        if axis == "z":
            pos = np.array([radius * np.cos(ang), radius * np.sin(ang), h])
        elif axis == "y":
            pos = np.array([radius * np.cos(ang), h, radius * np.sin(ang)])
        else:
            pos = np.array([h, radius * np.cos(ang), radius * np.sin(ang)])
        c2w = np.eye(4)
        c2w[:3, 3], c2w[:3, :3] = pos, look_at_rotation(pos, up=up)
        out.append(c2w)
    return np.stack(out).astype(np.float32)
