"""Dense-masked volume rendering of tri-plane fields, for evaluation and
training.

Port of `ngf_tpu/render/volume.py:57-132,375-508` (reference
`InfoInv/models/FieldBase.py:228-282`): every sample is evaluated densely and
invalid contributions are zeroed by masks, which composites to the same
outputs as the reference's ragged boolean indexing. The optional
``sample_cap`` compaction keeps the first ``sample_cap`` valid samples per
ray in marching order (a stable argsort). Training passes a
``torch.Generator`` for the per-ray jitter and the random background.

Only the dense path (``group_size == 0``) is ported, without ``rgb_cap`` or
``mask_stride``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from ..fields.triplane import (
    TriPlaneConfig,
    triplane_density,
    triplane_density_and_rgbfeat,
    triplane_gauge,
    triplane_project,
    triplane_rgb,
    triplane_rgb_from_feats,
)
from ..ops.compositing import raw2alpha
from ..ops.grid_sample import grid_sample_3d
from ..ops.rays import stratified_sample


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static rendering configuration (`ngf_tpu/render/volume.py:57-110`):
    the fields of the dense path. ``rgb_cap`` and ``mask_stride`` are
    carried for the trainer's configuration; only their defaults (0, 1) are
    ported."""

    aabb: tuple[tuple[float, float, float], tuple[float, float, float]]
    near: float = 2.0
    far: float = 6.0
    n_samples: int = 443
    step_size: float = 0.01
    distance_scale: float = 25.0
    ray_march_weight_thres: float = 1e-4
    white_bg: bool = True
    sample_cap: int = 0  # 0 = dense (no compaction)
    rgb_cap: int = 0  # top-K shading: not ported yet
    mask_stride: int = 1  # strided occupancy lookup: not ported yet
    group_size: int = 0  # grouped path: not ported yet

    def aabb_tensor(self, device) -> torch.Tensor:
        return _aabb_tensor(self.aabb, torch.device(device))


@functools.lru_cache(maxsize=16)
def _aabb_tensor(aabb, device: torch.device) -> torch.Tensor:
    """One read-only copy of each box per device, so that a train step
    copies nothing from the host for it. Made outside inference mode, so a
    training render may use a box that an evaluation made first."""
    with torch.inference_mode(False):
        return torch.tensor(aabb, dtype=torch.float32, device=device)


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
    generator: torch.Generator | None = None,
) -> dict[str, torch.Tensor]:
    """Render a chunk of rays (`ngf_tpu/render/volume.py:375-508`).

    Args:
      rays: (N, 6) [origin, unit direction], on the params' device.
      iteration: drives the gauge schedule.
      alpha_volume: optional (D, H, W) occupancy grid, z-major; samples with
        trilinear alpha == 0 are culled (`FieldBase.py:238-244`).
      alpha_aabb: (2, 3) AABB of the alpha volume (defaults to the field's).
      sample_fn: optional ``(plane, coords, name) -> feats`` replacing the
        gather for every plane fetch, one plane and one of the density and
        appearance channel ranges at a time; None fetches all channels of
        the three planes in one gather.
      generator: a training render (``is_train=True`` in the JAX package):
        one uniform jitter per ray and, when not ``white_bg``, the random
        background are drawn from it, on the rays' device. None renders
        deterministically, as evaluation does.

    Returns:
      dict with 'rgb_map' (N, 3), 'depth_map' (N,, no gradient) and
      'acc_map' (N,).
    """
    if rcfg.group_size > 0:
        raise NotImplementedError(
            "group_size > 0 (grouped compaction) is not ported yet: see "
            "ROADMAP.md queue 1, item 2, 'Occupancy events and the grouped path'"
        )
    if rcfg.rgb_cap != 0 or rcfg.mask_stride > 1:
        raise NotImplementedError(
            f"rgb_cap={rcfg.rgb_cap}, mask_stride={rcfg.mask_stride}: only dense shading "
            "and per-sample occupancy (0, 1) are ported; see ROADMAP.md queue 1, "
            "'rgb_cap and mask_stride'"
        )
    aabb = rcfg.aabb_tensor(rays.device)
    rays_o, viewdirs = rays[:, 0:3], rays[:, 3:6]

    jitter = None
    if generator is not None:
        # One uniform offset per ray (`ngf_tpu/ops/rays.py:89-90`).
        jitter = torch.rand((rays.shape[0], 1), generator=generator, device=rays.device)
    pts, z_vals, valid = stratified_sample(
        rays_o, viewdirs, aabb, rcfg.near, rcfg.far, rcfg.n_samples, rcfg.step_size, jitter
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

    # Appearance is decoded at every sample whose density is fetched, so
    # without a sampler of the caller's both come from one fetch of all
    # channels (the same values as two fetches); a ``sample_fn`` sees the
    # density and appearance fetches of each plane apart, as the JAX
    # package's dense path makes them.
    if sample_fn is None:
        sigma, rgb_feat = triplane_density_and_rgbfeat(params, model_cfg, xy, yz, xz)
    else:
        sigma = triplane_density(params, model_cfg, xy, yz, xz, sample_fn)
    sigma = sigma * vmask
    _, weight, _ = raw2alpha(sigma, dists * rcfg.distance_scale)
    acc_map = weight.sum(dim=-1)

    # rgb only where the blend weight clears the threshold (`FieldBase.py:261-265`).
    rgb_mask = (weight > rcfg.ray_march_weight_thres).to(pts.dtype)
    views = viewdirs[:, None, :].expand(n, s, 3)
    if sample_fn is None:
        rgb = triplane_rgb_from_feats(params, model_cfg, rgb_feat, views)
    else:
        rgb = triplane_rgb(params, model_cfg, xy, yz, xz, views, sample_fn)
    rgb = rgb * rgb_mask[..., None]
    rgb_map = (weight[..., None] * rgb).sum(dim=-2)

    if rcfg.white_bg:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    elif generator is not None:
        # A white background for the whole batch with probability 1/2
        # (`ngf_tpu/render/volume.py:494-499`, `FieldBase.py:270`).
        mix = (torch.rand((), generator=generator, device=rays.device) < 0.5).to(rgb_map.dtype)
        rgb_map = rgb_map + mix * (1.0 - acc_map[..., None])
    rgb_map = rgb_map.clamp(0.0, 1.0)

    depth_map = (weight * z_vals).sum(dim=-1)
    # As `ngf_tpu/render/volume.py:503-506` has it: the last ray component
    # (the z of the direction) fills the missed transmittance.
    depth_map = (depth_map + (1.0 - acc_map) * rays[..., -1]).detach()
    return {"rgb_map": rgb_map, "depth_map": depth_map, "acc_map": acc_map}
