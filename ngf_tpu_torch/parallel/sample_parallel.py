"""Sample-axis parallelism for the volume renderer: port of
`ngf_tpu/parallel/sample_parallel.py`.

Rays are split over the mesh's 'data' axis (the caller passes this rank's
slice) and each ray's samples over its 'sample' axis. The dependency across
shards is the transmittance: a shard's T_k is the product of the earlier
shards' totals times its own exclusive product. So each rank evaluates the
field on its slice of samples, K5's shard mode gives its total t_end, one
exchange over the sample group gathers every shard's totals, the exclusive
product over the shard index gives this shard's t0, K5 composites from t0,
and one sum over the sample group reduces the partial colour, acc and depth
(:func:`~ngf_tpu_torch.parallel.collectives.psum_replicated`); the
background, the clip and the depth fill follow on the sums. Dense and
masked: no compaction, no occupancy grid, as in the JAX package.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..fields.triplane import (
    TriPlaneConfig,
    triplane_density_and_rgbfeat,
    triplane_gauge,
    triplane_project,
    triplane_rgb_from_feats,
)
from ..ops.compositing import composite_shard
from ..ops.grid_sample import normalize_coord
from ..ops.rays import ray_aabb_tmin
from ..render import volume
from .collectives import all_gather_totals, psum_replicated
from .mesh import Mesh


def exclusive_prefix(totals: torch.Tensor, index: int) -> torch.Tensor:
    """The product of rows ``[0, index)`` of the (m, n) totals, as
    `ngf_tpu/parallel/sample_parallel.py:106-109` masks them: every row is
    a factor (1 where it does not count), so every row gets a gradient and
    every rank's backward reaches the exchange."""
    m = totals.shape[0]
    keep = (torch.arange(m, device=totals.device) < index).to(totals.dtype)[:, None]
    factors = totals * keep + (1.0 - keep)
    t0 = factors[0]
    for j in range(1, m):
        t0 = t0 * factors[j]
    return t0


def render_rays_sp(
    params: Any,
    model_cfg: TriPlaneConfig,
    rcfg: volume.RenderConfig,
    rays: torch.Tensor,
    mesh: Mesh,
    *,
    iteration: int = 0,
    generator: torch.Generator | None = None,
    rows: tuple[int, int] | None = None,
) -> dict[str, torch.Tensor]:
    """Dense masked render of this rank's rays over its slice of every
    ray's samples (`ngf_tpu/parallel/sample_parallel.py:47-139`).

    Args:
      rays: (N, 6), this rank's rays (the same on every rank of its sample
        group).
      rcfg: ``n_samples`` divisible by the mesh's 'sample' axis size; the
        shard with sample index i marches samples ``[i s, (i + 1) s)``.
      generator: a training render: one jitter per ray for the whole batch
        (``rows``, as :func:`~ngf_tpu_torch.render.volume.render_rays`), then
        the random background when not ``white_bg``, the same draws on every
        rank; None renders deterministically.

    Returns:
      dict with 'rgb_map' (N, 3), 'depth_map' (N,, no gradient) and
      'acc_map' (N,), the same on every rank of the sample group.
    """
    n_sample = mesh.n_sample
    s_total = rcfg.n_samples
    if s_total % n_sample:
        raise ValueError(f"n_samples {s_total} does not split over {n_sample} sample ranks")
    s_local = s_total // n_sample
    sidx = mesh.sample_index
    device = rays.device
    aabb = rcfg.aabb_tensor(device)
    rays_o, viewdirs = rays[:, 0:3], rays[:, 3:6]
    n = rays.shape[0]

    t_min = ray_aabb_tmin(rays_o, viewdirs, aabb, rcfg.near, rcfg.far)
    idx = sidx * s_local + torch.arange(s_local, dtype=rays.dtype, device=device)
    # One jitter per ray, identical on every sample rank (`:80-84`).
    rng = idx[None, :]
    if generator is not None:
        rng = rng + volume._jitter_rows(generator, n, device, rows)
    z = t_min[:, None] + rcfg.step_size * rng
    pts = rays_o[:, None, :] + viewdirs[:, None, :] * z[..., None]
    valid = ((pts >= aabb[0]) & (pts <= aabb[1])).all(dim=-1)
    # The last global sample's trailing-zero length: invalid (`:89`).
    valid = valid & (idx[None, :] < s_total - 1)

    xy, yz, xz = triplane_project(normalize_coord(pts, aabb))
    xy, yz, xz = triplane_gauge(params, model_cfg, xy, yz, xz, iteration)
    sigma, rgb_feat = triplane_density_and_rgbfeat(params, model_cfg, xy, yz, xz)
    sigma = sigma * valid.to(sigma.dtype)
    rgb = triplane_rgb_from_feats(params, model_cfg, rgb_feat, viewdirs[:, None, :].expand(n, s_local, 3))

    def exchange(t_end):
        return exclusive_prefix(all_gather_totals(t_end, mesh.sample_group), sidx)

    # One length for every sample, as `:98` multiplies sigma by it.
    dist = float(np.float32(rcfg.step_size * rcfg.distance_scale))
    y, acc, depth = composite_shard(sigma, dist, rgb, z, rcfg.ray_march_weight_thres, exchange)
    sums = psum_replicated(torch.cat([y, acc[:, None], depth[:, None]], dim=1), mesh.sample_group)
    y, acc, depth = sums[:, :3], sums[:, 3], sums[:, 4].detach()

    bg = volume._background(rcfg.white_bg, generator, device)
    if bg is not None:
        y = y + bg * (1.0 - acc[:, None])
    # jnp.clip: maximum then minimum, half the gradient at a bound.
    rgb_map = torch.minimum(torch.maximum(y, y.new_zeros(())), y.new_ones(()))
    depth = (depth + (1.0 - acc) * rays[:, -1]).detach()
    return {"rgb_map": rgb_map, "depth_map": depth, "acc_map": acc}
