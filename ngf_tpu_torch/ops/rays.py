"""Ray-AABB clipping, fixed-step sampling along rays, NeuTex cube ray
generation (plain, bounded by end points, and importance-refined),
inverse-CDF sampling, and the NDC helpers of forward-facing scenes.

Port of `ngf_tpu/ops/rays.py` (references
`InfoInv/models/FieldBase.py:118-137`, `UV-Mapping/model/renderer.py:13-173,271-345`,
`InfoInv/dataLoader/ray_utils.py:9-21,90-107,129-171,269-275`). Randomness is
injected: the caller passes the uniform draws where the JAX functions take
a key (``sample_pdf`` draws from the global generator when given none),
and evaluation passes none.
"""

from __future__ import annotations

import torch


def _safe_dirs(rays_d: torch.Tensor) -> torch.Tensor:
    # Exactly-zero direction components become 1e-6 (`FieldBase.py:122`).
    return torch.where(rays_d == 0, torch.full_like(rays_d, 1e-6), rays_d)


def ray_aabb_tmin(
    rays_o: torch.Tensor, rays_d: torch.Tensor, aabb: torch.Tensor, near: float, far: float
) -> torch.Tensor:
    """Entry distance of each ray into the AABB, clamped to [near, far]
    (`ngf_tpu/ops/rays.py:19-42`). rays (N, 3), aabb (2, 3) -> (N,)."""
    vec = _safe_dirs(rays_d)
    rate_a = (aabb[1] - rays_o) / vec
    rate_b = (aabb[0] - rays_o) / vec
    t_min = torch.minimum(rate_a, rate_b).amax(dim=-1)
    return t_min.clamp(near, far)


def ray_aabb_range(
    rays_o: torch.Tensor, rays_d: torch.Tensor, aabb: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Unclamped slab test (t_min, t_max); a ray hits the box iff
    t_max > t_min (`ngf_tpu/ops/rays.py:45-56`)."""
    vec = _safe_dirs(rays_d)
    rate_a = (aabb[1] - rays_o) / vec
    rate_b = (aabb[0] - rays_o) / vec
    t_min = torch.minimum(rate_a, rate_b).amax(dim=-1)
    t_max = torch.maximum(rate_a, rate_b).amin(dim=-1)
    return t_min, t_max


def stratified_sample(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    aabb: torch.Tensor,
    near: float,
    far: float,
    n_samples: int,
    step_size: float,
    jitter: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-step samples from the AABB entry point
    (`ngf_tpu/ops/rays.py:59-94`): z = t_min + step_size * (arange(S) + u).

    Args:
      rays_o, rays_d: (N, 3).
      jitter: optional (N, 1) per-ray offsets u in [0, 1) (one per ray, not
        per sample, as at train time in the reference); None at eval.

    Returns:
      pts (N, S, 3), z_vals (N, S), and the in-AABB mask (N, S).
    """
    t_min = ray_aabb_tmin(rays_o, rays_d, aabb, near, far)
    rng = torch.arange(n_samples, dtype=rays_o.dtype, device=rays_o.device)[None, :]
    if jitter is not None:
        rng = rng + jitter
    z_vals = t_min[:, None] + step_size * rng
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    inbbox = ((pts >= aabb[0]) & (pts <= aabb[1])).all(dim=-1)
    return pts, z_vals, inbbox


def cube_ray_generation(
    campos: torch.Tensor,
    raydir: torch.Tensor,
    point_count: int,
    domain_size: float = 1.0,
    jitter: float = 0.0,
    u: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """NeuTex cube ray generation (`ngf_tpu/ops/rays.py:97-147`): slab-test
    the rays against [-domain, domain]^3, march from the entry (clamped at
    0) in steps dt = 2 * domain / S whose lengths are jittered by
    ``jitter * dt * (u - 0.5)``, and sample the segments' midpoints.

    The direction is divided by as it is, with no guard for zero
    components, as the JAX function does.

    Args:
      campos: (B, 3); raydir: (B, R, 3) unit directions.
      point_count: S.
      u: (B, R, S) uniform draws in [0, 1), or None for no jitter (as
        ``jitter`` 0).

    Returns:
      raypos (B, R, S, 3), segment_length (B, R, S), valid (B, R, S) bool,
      mid_ts (B, R, S).
    """
    t1 = (-domain_size - campos[:, None, :]) / raydir
    t2 = (domain_size - campos[:, None, :]) / raydir
    lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
    tmin = torch.maximum(lo[..., 0], torch.maximum(lo[..., 1], lo[..., 2]))
    tmax = torch.minimum(hi[..., 0], torch.minimum(hi[..., 1], hi[..., 2]))
    t_start = torch.where(tmin < tmax, tmin, torch.zeros_like(tmin)).clamp_min(0.0)

    dt = domain_size * 2.0 / point_count
    shape = (raydir.shape[0], raydir.shape[1], point_count)
    if jitter > 0.0 and u is not None:
        segment_length = dt + dt * jitter * (u - 0.5)
    else:
        segment_length = torch.full(shape, dt, dtype=raydir.dtype, device=raydir.device)
    end_ts = torch.cumsum(segment_length, dim=2)
    end_ts = torch.cat([torch.zeros_like(end_ts[..., :1]), end_ts], dim=2)
    end_ts = t_start[:, :, None] + end_ts
    mid_ts = 0.5 * (end_ts[..., :-1] + end_ts[..., 1:])
    raypos = campos[:, None, None, :] + raydir[:, :, None, :] * mid_ts[..., None]
    valid = ((raypos > -domain_size) & (raypos < domain_size)).all(dim=-1)
    return raypos, segment_length, valid, mid_ts


def cube_ray_generation_with_end(
    campos: torch.Tensor,
    raydir: torch.Tensor,
    end: torch.Tensor,
    point_count: int,
    domain_size: float = 1.0,
    jitter: float = 0.0,
    u: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`cube_ray_generation` bounded by per-ray end points
    (`ngf_tpu/ops/rays.py:150-179`, reference `renderer.py:271-345`): a
    sample whose midpoint lies past the ray's end is invalid (depth-supervised
    rendering). A direction component under 1e-12 in size sets no bound (the
    reference's plain division would give NaN and void the whole ray).

    Args:
      end: (B, R, 3) end positions per ray; the rest as
        :func:`cube_ray_generation`.
    """
    raypos, segment_length, valid, mid_ts = cube_ray_generation(
        campos, raydir, point_count, domain_size, jitter, u
    )
    ratio = torch.where(
        raydir.abs() < 1e-12,
        torch.full_like(raydir, float("inf")),
        (end - campos[:, None, :]) / torch.where(raydir == 0, torch.ones_like(raydir), raydir),
    )
    t_end = ratio.amin(dim=-1)  # (B, R)
    valid = valid & (mid_ts < t_end[:, :, None])
    return raypos, segment_length, valid, mid_ts


def refine_cube_ray_generation(
    campos: torch.Tensor,
    raydir: torch.Tensor,
    point_count: int,
    prev_ts: torch.Tensor,
    prev_weights: torch.Tensor,
    domain_size: float = 1.0,
    det: bool = True,
    u: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Importance-refined cube sampling (`ngf_tpu/ops/rays.py:182-216`,
    reference `renderer.py:144-173` with its numpy ``sample_pdf``): new
    segment ends drawn from the inverse CDF of the previous blend weights,
    sorted with the previous positions (which take no gradient), the first
    ``point_count + 1`` kept, and the segments' midpoints sampled.

    Args:
      prev_ts: (B, R, S0) previous sample positions.
      prev_weights: (B, R, S0) their blend weights.
      det: evenly spaced draws; else ``u`` (B, R, point_count + 1) uniform
        draws, or drawn from the global generator.

    Returns:
      raypos (B, R, S, 3), segment_length (B, R, S), valid (B, R, S), mid_ts.
    """
    # The reference's bins are the midpoints of prev_ts (S0 - 1) and its
    # weights the interior ones (S0 - 2) (`renderer.py:33-45`).
    bins = 0.5 * (prev_ts[..., 1:] + prev_ts[..., :-1])
    weights = prev_weights[..., 1:-1]
    new_ts = sample_pdf(bins, weights, point_count + 1, det=det, u=u)
    end_ts = torch.sort(torch.cat([new_ts, prev_ts.detach()], dim=-1), dim=-1).values[
        ..., : point_count + 1]
    segment_length = end_ts[..., 1:] - end_ts[..., :-1]
    mid_ts = 0.5 * (end_ts[..., :-1] + end_ts[..., 1:])
    raypos = campos[:, None, None, :] + raydir[:, :, None, :] * mid_ts[..., None]
    valid = ((raypos > -domain_size) & (raypos < domain_size)).all(dim=-1)
    return raypos, segment_length, valid, mid_ts


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
    det: bool = False,
    u: torch.Tensor | None = None,
) -> torch.Tensor:
    """Inverse-CDF sampling along rays (`ngf_tpu/ops/rays.py:219-271`,
    reference `InfoInv/dataLoader/ray_utils.py:129-171`): a CDF over
    ``bins`` from ``weights`` (+1e-5 each), ``n_samples`` drawn by inverse
    transform.

    Args:
      bins: (..., B + 1) bin positions.
      weights: (..., B) unnormalised weights.
      det: evenly spaced draws in [0, 1]; else ``u`` (..., n_samples)
        uniform draws, or drawn from the global generator.

    Returns:
      (..., n_samples) sample positions.
    """
    if bins.shape[-1] != weights.shape[-1] + 1:
        raise ValueError(
            f"bins must have one more entry than weights: {bins.shape[-1]} vs {weights.shape[-1]}"
        )
    weights = weights + 1e-5
    cdf = torch.cumsum(weights / weights.sum(dim=-1, keepdim=True), dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # (..., B + 1)
    shape = (*cdf.shape[:-1], n_samples)
    if det:
        u = torch.linspace(0.0, 1.0, n_samples, dtype=bins.dtype, device=bins.device).expand(shape)
    elif u is None:
        u = torch.rand(shape, dtype=bins.dtype, device=bins.device)
    u = u.contiguous()

    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (inds - 1).clamp_min(0)
    above = inds.clamp_max(cdf.shape[-1] - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def depth2dist(z_vals: torch.Tensor, cos_angle: torch.Tensor) -> torch.Tensor:
    """Depth samples -> segment lengths scaled by the ray angle, the last
    1e10 (`ngf_tpu/ops/rays.py:274-281`)."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    return dists * cos_angle[..., None]


def ndc2dist(ndc_pts: torch.Tensor, cos_angle: torch.Tensor) -> torch.Tensor:
    """Segment lengths in NDC space (`ngf_tpu/ops/rays.py:284-287`)."""
    dists = torch.linalg.norm(ndc_pts[:, 1:] - ndc_pts[:, :-1], dim=-1)
    return torch.cat([dists, 1e10 * cos_angle[..., None]], dim=-1)


def ndc_bbox(all_rays: torch.Tensor) -> torch.Tensor:
    """Bounding box (2, 3) of NDC rays' near and far endpoints
    (`ngf_tpu/ops/rays.py:290-297`)."""
    near = all_rays[..., :3].reshape(-1, 3)
    far = (all_rays[..., :3] + all_rays[..., 3:6]).reshape(-1, 3)
    lo = torch.minimum(near.amin(0), far.amin(0))
    hi = torch.maximum(near.amax(0), far.amax(0))
    return torch.stack([lo, hi])


def find_ray_generation_method(name: str):
    """Ray generation by name (`ngf_tpu/ops/rays.py:300-304`, reference
    `renderer.py:13-24`)."""
    if name == "cube":
        return cube_ray_generation
    raise RuntimeError(f"No such ray generation method: {name}")


def find_refined_ray_generation_method(name: str):
    """Refined ray generation by name (`ngf_tpu/ops/rays.py:307-311`)."""
    if name == "cube":
        return refine_cube_ray_generation
    raise RuntimeError(f"No such refined ray generation method: {name}")


def ndc_rays_blender(
    h: int, w: int, focal: float, near: float, rays_o: torch.Tensor, rays_d: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The NDC transform of forward-facing (LLFF) scenes
    (`ngf_tpu/ops/rays.py:312-333`): origins shifted to the near plane, then
    projected."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (w / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (h / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (w / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2]
    )
    d1 = -1.0 / (h / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2]
    )
    d2 = -2.0 * near / rays_o[..., 2]

    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)
