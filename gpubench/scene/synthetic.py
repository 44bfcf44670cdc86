"""The analytic scene of the benchmark: a frozen copy of the port's
`ngf_tpu_torch/data/synthetic.py`, rewritten to build its rays and ground
truth on the device in a few large calls.

Three soft Gaussian density blobs with smoothly varying colours, white
background, near/far 2-6, box [-1.5, 1.5]^3, cameras on a sphere of radius
4 with the Blender lego field of view. The training views sit at azimuths
spaced evenly from -180 degrees at elevations -30 / -12 alternately, the
test views 37.5 degrees further round at -24 / -17. The ground truth
integrates the field at 320 evenly spaced depths from near to far.

The scene is the same for every seed: a seed draws the weights, the
sampler's order, the jitter and which test views a render cell renders,
never the work's size. The port's copy is not imported, so that a change to
it cannot move the benchmark.
"""

from __future__ import annotations

import numpy as np
import torch

CENTERS = ((0.24, 0.0, -0.05), (-0.18, 0.14, 0.07), (0.0, -0.17, 0.18))
WIDTHS = (0.095, 0.085, 0.08)
AMPS = (32.0, 28.0, 30.0)
COLORS = ((0.85, 0.3, 0.2), (0.2, 0.7, 0.9), (0.9, 0.8, 0.25))
NEAR_FAR = (2.0, 6.0)
BBOX = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))
CAMERA_ANGLE_X = 0.6911112070083618
RADIUS = 4.0
GT_SAMPLES = 320


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """Blender-convention camera-to-world matrix on a sphere, looking at the
    origin."""
    th, phi = np.deg2rad(theta_deg), np.deg2rad(phi_deg)
    c2w = np.eye(4)
    c2w[2, 3] = radius
    rot_phi = np.eye(4)
    rot_phi[1:3, 1:3] = [[np.cos(phi), -np.sin(phi)], [np.sin(phi), np.cos(phi)]]
    rot_th = np.eye(4)
    rot_th[0, 0] = rot_th[2, 2] = np.cos(th)
    rot_th[0, 2], rot_th[2, 0] = -np.sin(th), np.sin(th)
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float64)
    return (flip @ rot_th @ rot_phi @ c2w).astype(np.float32)


def poses(split: str, n_views: int) -> np.ndarray:
    """(n, 4, 4) float32 poses of the ``train`` or ``test`` split."""
    offset, elevs = (0.0, (-30.0, -12.0)) if split == "train" else (37.5, (-24.0, -17.0))
    azim = np.linspace(-180, 180, n_views, endpoint=False) + offset
    elev = np.where(np.arange(n_views) % 2 == 0, elevs[0], elevs[1])
    return np.stack([pose_spherical(a, e, RADIUS) for a, e in zip(azim, elev)])


def directions(wh: tuple[int, int], device) -> torch.Tensor:
    """(H * W, 3) unit camera-space directions of the pixel centres,
    Blender convention (x right, y up, z backward)."""
    w, h = wh
    focal = 0.5 * w / np.tan(0.5 * CAMERA_ANGLE_X)
    i, j = np.meshgrid(np.arange(w, dtype=np.float32) + 0.5,
                       np.arange(h, dtype=np.float32) + 0.5, indexing="xy")
    d = np.stack([(i - w / 2) / focal, -(j - h / 2) / focal, -np.ones_like(i)], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(d.reshape(-1, 3)).to(device)


def view_rays(dirs: torch.Tensor, c2w: np.ndarray) -> torch.Tensor:
    """(H * W, 6) world rays [origin, direction] of one pose."""
    c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=dirs.device)
    d = dirs @ c2w[:3, :3].T
    return torch.cat([c2w[:3, 3].expand_as(d), d], dim=1)


def _field(pts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 3) points -> (sigma (...), rgb (..., 3)) of the three blobs."""
    dev = pts.device
    centers = torch.tensor(CENTERS, device=dev)
    widths = torch.tensor(WIDTHS, device=dev)
    amps = torch.tensor(AMPS, device=dev)
    d2 = ((pts[..., None, :] - centers) ** 2).sum(-1)
    comps = amps * torch.exp(-d2 / (2.0 * widths ** 2))
    sigma = comps.sum(-1)
    w = comps / (sigma[..., None] + 1e-8)
    rgb = w @ torch.tensor(COLORS, device=dev)
    rgb = rgb + 0.08 * torch.sin(3.0 * pts + torch.tensor([0.0, 2.0, 4.0], device=dev))
    return sigma, rgb.clamp(0.0, 1.0)


@torch.no_grad()
def _integrate(o: torch.Tensor, d: torch.Tensor, t: torch.Tensor, dt: float) -> torch.Tensor:
    sigma, rgb = _field(o[:, None] + d[:, None] * t[:, None])
    alpha = 1.0 - torch.exp(-sigma * dt)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    weight = alpha * trans
    return (weight[..., None] * rgb).sum(-2) + (1.0 - weight.sum(-1))[:, None]


def near_blobs(o: torch.Tensor, d: torch.Tensor, widths: float = 8.0) -> torch.Tensor:
    """(N,) whether each ray's segment from near to far passes a blob centre
    closer than ``widths`` of its widths. At 8 the others' colour is exactly
    the background's."""
    centers = torch.tensor(CENTERS, device=o.device)
    reach2 = (widths * torch.tensor(WIDTHS, device=o.device)) ** 2
    tc = ((centers - o[:, None]) * d[:, None]).sum(-1).clamp(*NEAR_FAR)
    gap2 = ((o[:, None] + d[:, None] * tc[..., None] - centers) ** 2).sum(-1)
    return (gap2 < reach2).any(-1)


@torch.no_grad()
def render_gt(rays: torch.Tensor, chunk: int = 131072) -> torch.Tensor:
    """(N, 3) ground-truth colours of (N, 6) rays of unit directions: the
    field integrated at ``GT_SAMPLES`` depths from near to far, white
    background. A ray whose segment passes no blob centre closer than 8 of
    its widths meets a density under 32 e^-32 at every sample, whose alpha
    is exactly 0 in float32, so its colour is exactly the background's
    and is not integrated."""
    dev = rays.device
    t = torch.from_numpy(np.linspace(*NEAR_FAR, GT_SAMPLES, dtype=np.float32)).to(dev)
    dt = float(t[1] - t[0])
    out = torch.ones((rays.shape[0], 3), device=dev)
    for i in range(0, rays.shape[0], chunk):
        o, d = rays[i:i + chunk, 0:3], rays[i:i + chunk, 3:6]
        near = near_blobs(o, d).nonzero().squeeze(1)
        if near.numel():
            out[i + near] = _integrate(o[near], d[near], t, dt)
    return out


@torch.no_grad()
def split_rays(split: str, n_views: int, wh: tuple[int, int], device) -> torch.Tensor:
    """(n_views * H * W, 6) rays of a split, view by view, pixels row-major."""
    dirs = directions(wh, device)
    return torch.cat([view_rays(dirs, c2w) for c2w in poses(split, n_views)])


class TrainSplit:
    """The training split as the port's trainer reads a dataset: flat host
    arrays of rays and colours with the scene's box, near/far and
    background. ``rays`` and ``rgbs`` are the device copies the benchmark
    keeps for its reference."""

    def __init__(self, n_views: int, wh: tuple[int, int], device):
        self.rays = split_rays("train", n_views, wh, device)
        self.rgbs = render_gt(self.rays)
        self.all_rays = self.rays.cpu().numpy()
        self.all_rgbs = self.rgbs.cpu().numpy()
        self.img_wh = tuple(wh)
        self.near_far = NEAR_FAR
        self.white_bg = True
        self.scene_bbox = np.asarray(BBOX, np.float32)
        self.is_stack = False
