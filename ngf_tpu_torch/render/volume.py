"""Dense-masked volume rendering of tri-plane fields, evaluation path.

Port of `ngf_tpu/render/volume.py:57-132,375-508` (reference
`InfoInv/models/FieldBase.py:228-282`): every sample is evaluated densely and
invalid contributions are zeroed by masks, which composites to the same
outputs as the reference's ragged boolean indexing. The optional
``sample_cap`` compaction keeps the first ``sample_cap`` valid samples per
ray in marching order (a stable argsort).

Only the dense path (``group_size == 0``) is ported; training's jitter and
random background come with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..fields.triplane import (
    TriPlaneConfig,
    triplane_density,
    triplane_gauge,
    triplane_project,
    triplane_rgb,
)
from ..ops.compositing import raw2alpha
from ..ops.grid_sample import grid_sample_3d
from ..ops.rays import stratified_sample


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static rendering configuration (`ngf_tpu/render/volume.py:57-110`):
    the fields of the dense evaluation path. The JAX package's ``rgb_cap``
    and ``mask_stride`` come with the training slice that sets them."""

    aabb: tuple[tuple[float, float, float], tuple[float, float, float]]
    near: float = 2.0
    far: float = 6.0
    n_samples: int = 443
    step_size: float = 0.01
    distance_scale: float = 25.0
    ray_march_weight_thres: float = 1e-4
    white_bg: bool = True
    sample_cap: int = 0  # 0 = dense (no compaction)
    group_size: int = 0  # grouped path: not ported yet

    def aabb_tensor(self, device) -> torch.Tensor:
        return torch.tensor(self.aabb, dtype=torch.float32, device=device)


def normalize_coord(xyz: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """Map AABB coords to [-1, 1] (`InfoInv/models/FieldBase.py:88-89`)."""
    inv_size = 2.0 / (aabb[1] - aabb[0])
    return (xyz - aabb[0]) * inv_size - 1.0


def _compact(order_key: torch.Tensor, cap: int, *arrays: torch.Tensor):
    """Stable-sort samples so valid ones (key 0) come first; keep ``cap``
    (`ngf_tpu/render/volume.py:119-132`)."""
    order = torch.argsort(order_key, dim=-1, stable=True)[..., :cap]
    outs = []
    for a in arrays:
        idx = order if a.dim() == order.dim() else order[..., None].expand(-1, -1, a.shape[-1])
        outs.append(torch.gather(a, 1, idx))
    return outs


def render_rays(
    params: Any,
    model_cfg: TriPlaneConfig,
    rcfg: RenderConfig,
    rays: torch.Tensor,
    *,
    iteration: int = 0,
    alpha_volume: torch.Tensor | None = None,
    alpha_aabb: torch.Tensor | None = None,
    sample_fn=None,
) -> dict[str, torch.Tensor]:
    """Render a chunk of rays for evaluation
    (`ngf_tpu/render/volume.py:375-508` with ``is_train=False``).

    Args:
      rays: (N, 6) [origin, unit direction], on the params' device.
      iteration: drives the gauge schedule.
      alpha_volume: optional (D, H, W) occupancy grid, z-major; samples with
        trilinear alpha == 0 are culled (`FieldBase.py:238-244`).
      alpha_aabb: (2, 3) AABB of the alpha volume (defaults to the field's).
      sample_fn: optional ``(plane, coords, name) -> feats`` replacing
        ``grid_sample_2d`` for every plane fetch.

    Returns:
      dict with 'rgb_map' (N, 3), 'depth_map' (N,) and 'acc_map' (N,).
    """
    if rcfg.group_size > 0:
        raise NotImplementedError(
            "group_size > 0 (grouped compaction) is not ported yet: see "
            "ROADMAP.md queue 1, item 2, 'Occupancy events and the grouped path'"
        )
    aabb = rcfg.aabb_tensor(rays.device)
    rays_o, viewdirs = rays[:, 0:3], rays[:, 3:6]

    pts, z_vals, valid = stratified_sample(
        rays_o, viewdirs, aabb, rcfg.near, rcfg.far, rcfg.n_samples, rcfg.step_size
    )
    # Forward differences with a trailing zero (`FieldBase.py:235`).
    dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1], torch.zeros_like(z_vals[:, :1])], dim=-1)

    if alpha_volume is not None:
        # Trilinear occupancy lookup (`ngf_tpu/render/volume.py:42-54,449-452`).
        a_aabb = aabb if alpha_aabb is None else alpha_aabb
        alphas = grid_sample_3d(alpha_volume[..., None], normalize_coord(pts, a_aabb))[..., 0]
        valid = valid & (alphas > 0)

    if rcfg.sample_cap and rcfg.sample_cap < rcfg.n_samples:
        order_key = (~valid).to(torch.int32)
        pts, z_vals, dists, valid = _compact(order_key, rcfg.sample_cap, pts, z_vals, dists, valid)

    n, s = z_vals.shape
    vmask = valid.to(pts.dtype)

    xy, yz, xz = triplane_project(normalize_coord(pts, aabb))
    xy, yz, xz = triplane_gauge(params, model_cfg, xy, yz, xz, iteration, sample_fn)

    sigma = triplane_density(params, model_cfg, xy, yz, xz, sample_fn) * vmask
    _, weight, _ = raw2alpha(sigma, dists * rcfg.distance_scale)
    acc_map = weight.sum(dim=-1)

    # rgb only where the blend weight clears the threshold (`FieldBase.py:261-265`).
    rgb_mask = (weight > rcfg.ray_march_weight_thres).to(pts.dtype)
    views = viewdirs[:, None, :].expand(n, s, 3)
    rgb = triplane_rgb(params, model_cfg, xy, yz, xz, views, sample_fn) * rgb_mask[..., None]
    rgb_map = (weight[..., None] * rgb).sum(dim=-2)

    if rcfg.white_bg:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    rgb_map = rgb_map.clamp(0.0, 1.0)

    depth_map = (weight * z_vals).sum(dim=-1)
    # As `ngf_tpu/render/volume.py:503-506` has it: the last ray component
    # (the z of the direction) fills the missed transmittance.
    depth_map = depth_map + (1.0 - acc_map) * rays[..., -1]
    return {"rgb_map": rgb_map, "depth_map": depth_map, "acc_map": acc_map}
