"""Occupancy (alpha-mask) events for training: port of
`ngf_tpu/train/occupancy.py` (reference `InfoInv/models/FieldBase.py:161-223`).

- :func:`update_alpha_mask`: alpha on a dense lattice over the AABB (the
  gauge at iteration -1; later events pre-cull with the previous grid), the
  z-major (D=gz, H=gy, W=gx) layout, clip, 3x3x3 max-pool dilation,
  threshold, and the tight AABB of the surviving voxels.
- :func:`filter_rays_alpha`, :func:`occupied_samples_per_ray`,
  :func:`auto_sample_cap`: the first event's ray filter and the measured
  per-ray sample capacity.
- :func:`filter_rays_bbox`: the bbox pre-filter before training.
- :func:`shrink_box_voxels`: the gauge variant's crop box at its shrink.

The training rays stay on the device; every occupancy test is the
``occupancy_lookup`` kernel (K3) on the grid's uint8 copy (``AlphaGrid.occ``,
built once per event where the JAX package builds its parity block table).
Host-side numpy is kept where it decides an exact result: the lattice's
``linspace``, the tight bbox and the capacity subsample.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.gather import gather_rows
from ..ops.grid_sample import max_pool_3d, occupancy_lookup
from ..ops.rays import ray_aabb_range, stratified_sample
from ..render.volume import compute_alpha_grid_chunk


@dataclasses.dataclass
class AlphaGrid:
    """Binary occupancy grid with its own (frozen) AABB
    (`ngf_tpu/train/occupancy.py:36-58`).

    ``occ`` is the uint8 copy of ``volume`` that the K3 kernel reads (2 MiB
    at 128^3), made once per event."""

    volume: torch.Tensor  # (D, H, W) float32 {0, 1}, z-major
    aabb: torch.Tensor  # (2, 3) float32
    occ: torch.Tensor  # (D, H, W) uint8

    @classmethod
    def from_volume(cls, volume: torch.Tensor, aabb: torch.Tensor) -> "AlphaGrid":
        volume = volume.float().contiguous()
        return cls(volume=volume, aabb=aabb.float(), occ=(volume > 0).to(torch.uint8))

    def lookup(self, xyz: torch.Tensor) -> torch.Tensor:
        """(...) bool: the points (..., 3) lie in occupied space."""
        return occupancy_lookup(self.occ, xyz, self.aabb)


def _linspaces(grid_size) -> list[np.ndarray]:
    return [np.linspace(0.0, 1.0, g, dtype=np.float32) for g in grid_size]


def dense_grid_points(aabb, grid_size, device: torch.device | str = "cpu") -> torch.Tensor:
    """(gx, gy, gz, 3) lattice of sample positions spanning the AABB
    (`ngf_tpu/train/occupancy.py:112-118`, `FieldBase.py:165-170`): numpy's
    float32 ``linspace`` per axis, then ``aabb[0] * (1 - s) + aabb[1] * s``
    in float32 on ``device``, the same roundings as the JAX package's numpy."""
    aabb = torch.as_tensor(np.asarray(aabb, np.float32), device=device)
    lin = [torch.from_numpy(v).to(device) for v in _linspaces(grid_size)]
    s = torch.stack(torch.meshgrid(*lin, indexing="ij"), dim=-1)
    return aabb[0] * (1.0 - s) + aabb[1] * s


@torch.no_grad()
def update_alpha_mask(
    params,
    model_cfg,
    aabb,
    step_size: float,
    grid_size=(256, 256, 256),
    alpha_thres: float = 1e-4,
    prev: AlphaGrid | None = None,
    chunk: int = 256 * 256 * 8,
    device: torch.device | str = "cpu",
) -> tuple[AlphaGrid, np.ndarray]:
    """Recompute the occupancy grid (`ngf_tpu/train/occupancy.py:121-190`);
    returns (grid, new_aabb), new_aabb the tight bbox of the surviving
    voxels (the field's box when none survives). One K1 launch, and with
    ``prev`` one K3 launch, per ``chunk`` lattice points."""
    aabb_np = np.asarray(aabb, np.float32)
    aabb_t = torch.as_tensor(aabb_np, device=device)
    pts = dense_grid_points(aabb_np, grid_size, device).reshape(-1, 3)
    alpha = torch.cat([
        compute_alpha_grid_chunk(
            params, model_cfg, pts[i : i + chunk], aabb_t, step_size,
            None if prev is None else prev.occ, None if prev is None else prev.aabb,
        )
        for i in range(0, pts.shape[0], chunk)
    ]).reshape(*grid_size)

    # z-major layout, dilation, threshold (`FieldBase.py:184-191`).
    alpha_zyx = alpha.permute(2, 1, 0).contiguous().clamp(0.0, 1.0)
    binary = (max_pool_3d(alpha_zyx, 3) >= alpha_thres).to(torch.float32)

    # Tight bbox of the surviving voxels, in xyz order, on the host.
    occ = binary.cpu().numpy() > 0.5
    if occ.any():
        zi, yi, xi = np.nonzero(occ)
        lin = _linspaces(grid_size)
        xs = aabb_np[0][0] + lin[0][xi] * (aabb_np[1][0] - aabb_np[0][0])
        ys = aabb_np[0][1] + lin[1][yi] * (aabb_np[1][1] - aabb_np[0][1])
        zs = aabb_np[0][2] + lin[2][zi] * (aabb_np[1][2] - aabb_np[0][2])
        new_aabb = np.stack([
            np.array([xs.min(), ys.min(), zs.min()], np.float32),
            np.array([xs.max(), ys.max(), zs.max()], np.float32),
        ])
    else:
        new_aabb = aabb_np.copy()
    return AlphaGrid.from_volume(binary, aabb_t), new_aabb


def filter_rays_bbox(all_rays: np.ndarray, aabb, chunk: int = 51200) -> np.ndarray:
    """Boolean keep-mask of the (N, 6) host rays whose AABB slab test hits
    (`ngf_tpu/train/occupancy.py:193-205`, `FieldBase.py:207-213`), computed
    on the host."""
    aabb_t = torch.as_tensor(np.asarray(aabb, np.float32))
    rays = torch.from_numpy(np.ascontiguousarray(all_rays, np.float32))
    keep = []
    for i in range(0, rays.shape[0], chunk):
        r = rays[i : i + chunk]
        t_min, t_max = ray_aabb_range(r[:, :3], r[:, 3:6], aabb_t)
        keep.append((t_max > t_min).numpy())
    return np.concatenate(keep) if keep else np.zeros((0,), bool)


def _march(rays: torch.Tensor, aabb, near: float, far: float, step_size: float, n_samples: int):
    aabb_t = torch.as_tensor(np.asarray(aabb, np.float32), device=rays.device)
    return stratified_sample(rays[:, :3], rays[:, 3:6], aabb_t, near, far, n_samples, step_size)


@torch.no_grad()
def filter_rays_alpha(
    all_rays: torch.Tensor,
    grid: AlphaGrid,
    aabb,
    near: float,
    far: float,
    step_size: float,
    n_samples: int = 256,
    chunk: int = 51200,
) -> torch.Tensor:
    """(N,) bool keep-mask, on the rays' device, of the (N, 6) rays that
    touch occupied space at one of ``n_samples`` evaluation samples
    (`ngf_tpu/train/occupancy.py:261-285`, `FieldBase.py:214-216`). The
    trainer calls it with the default 256, not its own sample count, as the
    JAX trainer does. One K3 launch per ``chunk`` rays."""
    keep = [
        grid.lookup(_march(all_rays[i : i + chunk], aabb, near, far, step_size, n_samples)[0]).any(-1)
        for i in range(0, all_rays.shape[0], chunk)
    ]
    return torch.cat(keep) if keep else torch.zeros((0,), dtype=torch.bool, device=all_rays.device)


@torch.no_grad()
def occupied_samples_per_ray(
    all_rays: torch.Tensor,
    grid: AlphaGrid,
    aabb,
    near: float,
    far: float,
    step_size: float,
    n_samples: int,
    max_rays: int = 65536,
    chunk: int = 16384,
) -> np.ndarray:
    """Occupied in-box samples per ray over a subsample of the (N, 6) rays
    (`ngf_tpu/train/occupancy.py:208-246`): the same ``max_rays`` ids as the
    JAX package (``np.random.default_rng(0).choice`` on the host), gathered
    on the device with one ``gather_rows`` launch; one K3 launch per
    ``chunk`` rays. Returns the (n,) int64 counts on the host."""
    rays = all_rays
    if rays.shape[0] > max_rays:
        idx = np.random.default_rng(0).choice(rays.shape[0], max_rays, replace=False)
        rays = gather_rows(rays, torch.from_numpy(idx).to(rays.device))
    counts = []
    for i in range(0, rays.shape[0], chunk):
        pts, _, inb = _march(rays[i : i + chunk], aabb, near, far, step_size, n_samples)
        counts.append((grid.lookup(pts) & inb).sum(-1))
    if not counts:
        return np.zeros((0,), np.int64)
    return torch.cat(counts).cpu().numpy()


def auto_sample_cap(
    counts: np.ndarray, n_samples: int, quantile: float = 0.999, margin: float = 1.1
) -> int:
    """Capacity covering ``quantile`` of rays fully, with headroom, rounded
    up to a multiple of 32, within [32, n_samples]
    (`ngf_tpu/train/occupancy.py:249-258`)."""
    if counts.size == 0:
        return n_samples
    q = float(np.quantile(counts, quantile))
    cap = int(np.ceil(q * margin / 32.0) * 32)
    return int(np.clip(cap, 32, n_samples))


def shrink_box_voxels(aabb, new_aabb, grid_size) -> tuple[np.ndarray, np.ndarray]:
    """Voxel crop box [t_l, b_r) of the shrink event, in float64 as the JAX
    package computes it (`ngf_tpu/train/occupancy.py:288-298`,
    `TriPlane/models/Field.py:117-124`): t_l = round((new_min - min) / units),
    b_r = min(round((new_max - min) / units) + 1, grid), units =
    size / (grid - 1)."""
    aabb = np.asarray(aabb, np.float64)
    new_aabb = np.asarray(new_aabb, np.float64)
    grid_size = np.asarray(grid_size, np.int64)
    units = (aabb[1] - aabb[0]) / (grid_size - 1)
    t_l = np.round(np.round((new_aabb[0] - aabb[0]) / units)).astype(np.int64)
    b_r = np.round((new_aabb[1] - aabb[0]) / units).astype(np.int64) + 1
    b_r = np.minimum(b_r, grid_size)
    return t_l, b_r
