"""Volume rendering of tri-plane fields, for evaluation and training.

Port of `ngf_tpu/render/volume.py` (reference
`InfoInv/models/FieldBase.py:228-282`): every sample is evaluated densely and
invalid contributions are zeroed by masks, which composites to the same
outputs as the reference's ragged boolean indexing. Training passes a
``torch.Generator`` for the per-ray jitter and the random background.

Two paths, as in the JAX package:
- dense (``group_size == 0``): the optional ``sample_cap`` compaction keeps
  the first ``sample_cap`` valid samples per ray in marching order (a stable
  argsort);
- grouped (``group_size > 0``, the trainer's default): samples keep or drop
  in groups of G consecutive samples; the ``group_sample_compact`` kernel
  (K4) samples, queries the occupancy mask once or twice per group and
  compacts per ray in one launch, and the planes are fetched by K1.
The dense path and :func:`compute_alpha_grid_chunk` test an occupancy volume
with :func:`occupancy_lookup` (K3); with ``mask_stride`` K > 1 the dense path
queries it at the centre of each window of K samples. Both paths composite
with K5's tri-plane mode (:func:`~ngf_tpu_torch.ops.compositing.composite`):
one launch forward and, in training, one backward.

Top-K shading (``rgb_cap`` K > 0, the JAX package's fixed shading capacity):
only the K samples a ray of largest blend weight (the dense path) or the
``rgb_cap // G`` groups of largest best weight (the grouped path) are
shaded. The weights come first (K5's tri-plane mode without colour,
:func:`~ngf_tpu_torch.ops.compositing.composite_weights`), then
``torch.topk`` picks the samples, whose coordinates (then their appearance
is fetched, one K1 launch of the appearance channels) or prefetched
features (the grouped path's ``fused_fetch``) are gathered with a gradient
(``gather_group_rows``: the ``gather_rows`` kernel, backward
``scatter_rows``) and decoded, and K5's top-K colour pass
(:func:`~ngf_tpu_torch.ops.compositing.composite_topk`) adds them up.
``torch.topk`` does not promise the JAX package's order among equal
weights; equal weights that differ in the pick are 0 (a ray with fewer
than K nonzero weights), which shade nothing and take no gradient.

Tracing (`ngf_tpu_torch/utils/profiling.py`): a call is an ``ngf.render``
span of three parts, ``ngf.render.frontend`` (the jitter and K4, or the
dense sampling, K3 and compaction), ``ngf.field`` (projection, gauge, the
K1 fetch and both decoders) and ``ngf.render.composite`` (K5 and the top-K
shading). While tracing is on a call counts its ``rays``, the sample
``slots`` the field decodes, the ``kept`` samples (in the box and the
mask: the valid mask's sums, two kernels) and, in training, the ``shaded``
ones (blend weight over the threshold, three kernels).

Packing (the grouped path's training render with dense shading and no
``sample_fn``): K4's layout gives every ray ``capg`` group slots, most of
them empty. The kept groups' slot ids are read once to the host (the
call's one synchronise), their coordinates and view directions gathered
into consecutive rows (``gather_rows``), and only those rows decoded; the
decoded sigma and colour are written back into the zero-filled slot layout
(``scatter_rows``, backward ``gather_rows``) that K5 takes. Evaluation, top-K
shading and ``sample_fn`` callers decode every slot. The trainer runs the
batch and a packed render's front end on a second stream
(``front_stream``), so that reading the count does not wait for the
previous step's backward and update, which the card then runs while the
host queues the field.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
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
from ..ops.compaction import group_sample_compact
from ..ops.compositing import composite, composite_topk, composite_weights
from ..ops.gather import gather_group_rows, gather_rows, scatter_rows
from ..ops.grid_sample import normalize_coord, occupancy_lookup
from ..ops.rays import stratified_sample
from ..utils.profiling import annotate, count, enabled


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static rendering configuration (`ngf_tpu/render/volume.py:57-110`).
    ``run_len``, ``tile_q``, ``pair_gather`` and ``duo_bwd`` choose TPU
    gather formulations of the same values: every one of them fetches
    through K1 here, and only their preconditions are kept. ``fused_fetch``
    matters only to grouped top-K shading (with ``rgb_cap`` 0 both of its
    values give the same values through the one fused fetch): 1 gathers the
    shaded groups' prefetched appearance features, 0 fetches their
    appearance again at the gathered coordinates, as the JAX package's two
    branches do (with a ``sample_fn``, whose fetches take the density and
    the appearance channels apart, always the latter: the same values)."""

    aabb: tuple[tuple[float, float, float], tuple[float, float, float]]
    near: float = 2.0
    far: float = 6.0
    n_samples: int = 443
    step_size: float = 0.01
    distance_scale: float = 25.0
    ray_march_weight_thres: float = 1e-4
    white_bg: bool = True
    sample_cap: int = 0  # 0 = dense (no compaction)
    rgb_cap: int = 0  # top-K shading: the K samples of largest weight; 0 = all
    mask_stride: int = 1  # dense path: occupancy queried once a window of K samples
    group_size: int = 0  # 0 = dense path, G > 0 = grouped path
    run_len: int = 4
    tile_q: int = 2
    fused_fetch: bool = False
    pair_gather: bool = False
    duo_bwd: bool = False

    def aabb_tensor(self, device) -> torch.Tensor:
        return _aabb_tensor(self.aabb, torch.device(device))


@functools.lru_cache(maxsize=16)
def _aabb_tensor(aabb, device: torch.device) -> torch.Tensor:
    """One read-only copy of each box per device, so that a train step
    copies nothing from the host for it. Made outside inference mode, so a
    training render may use a box that an evaluation made first."""
    with torch.inference_mode(False):
        return torch.tensor(aabb, dtype=torch.float32, device=device)


def _compact(order_key: torch.Tensor, cap: int, *arrays: torch.Tensor):
    """Stable-sort samples so valid ones (key 0) come first; keep ``cap``
    (`ngf_tpu/render/volume.py:119-132`)."""
    order = torch.argsort(order_key, dim=-1, stable=True)[..., :cap]
    outs = []
    for a in arrays:
        idx = order if a.dim() == order.dim() else order[..., None].expand(-1, -1, a.shape[-1])
        outs.append(torch.gather(a, 1, idx))
    return outs


def _occupancy_bytes(volume: torch.Tensor) -> torch.Tensor:
    """The (D, H, W) uint8 volume the occupancy lookup reads: a {0, 1}
    volume of another dtype (a checkpoint's float32 mask) is tested ``> 0``."""
    if volume.dtype != torch.uint8:
        volume = (volume > 0).to(torch.uint8)
    return volume.contiguous()


def _ray_jitter(generator: torch.Generator, n: int, device) -> torch.Tensor:
    """One uniform offset per ray (`ngf_tpu/ops/rays.py:89-90`)."""
    return torch.rand((n, 1), generator=generator, device=device)


def _jitter_rows(generator: torch.Generator, n: int, device, rows) -> torch.Tensor:
    """The jitter of ``n`` rays that are rows ``[first, first + n)`` of a
    batch of ``total`` (``rows = (first, total)``; None: the whole batch):
    drawn for the whole batch and sliced, so that every rank of a parallel
    run draws the same numbers and keeps its own."""
    first, total = rows or (0, n)
    return _ray_jitter(generator, total, device)[first:first + n]


def _background(white_bg: bool, generator, device):
    """The background the composite adds times ``1 - acc``
    (`ngf_tpu/render/volume.py:347-353,494-501`): white (1), or in training
    without a white background white for the whole batch with probability
    1/2 (`FieldBase.py:270`), a 0/1 value drawn on the device; in evaluation
    without it none."""
    if white_bg:
        return 1.0
    if generator is not None:
        return (torch.rand((), generator=generator, device=device) < 0.5).to(torch.float32)
    return None


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
    rows: tuple[int, int] | None = None,
    front_stream: torch.cuda.Stream | None = None,
) -> dict[str, torch.Tensor]:
    """Render a chunk of rays (`ngf_tpu/render/volume.py:375-508`).

    Args:
      rays: (N, 6) [origin, unit direction], on the params' device.
      iteration: drives the gauge schedule.
      alpha_volume: optional (D, H, W) occupancy grid, z-major: uint8 as
        the trainer's ``AlphaGrid.occ``, or any {0, 1} tensor; samples in
        unoccupied space are culled (`FieldBase.py:238-244`).
      alpha_aabb: (2, 3) AABB of the alpha volume (defaults to the field's).
      sample_fn: optional ``(plane, coords, name) -> feats`` replacing the
        gather for every plane fetch, one plane and one of the density and
        appearance channel ranges at a time; None fetches all channels of
        the three planes in one gather.
      generator: a training render (``is_train=True`` in the JAX package):
        one uniform jitter per ray and, when not ``white_bg``, the random
        background are drawn from it, on the rays' device. None renders
        deterministically, as evaluation does.
      rows: ``(first, total)``: the rays are rows ``[first, first + N)`` of
        a batch of ``total`` whose draws are made whole on every rank of a
        data-parallel run (:func:`_jitter_rows`); None: the rays are the
        batch.
      front_stream: a packed render's front end (the jitter, K4 and the
        kept groups' ids, whose count the host reads) runs on this CUDA
        stream, which the caller keeps ordered after every write to the
        rays and the occupancy volume; the current stream then waits for
        it. Reading the count then waits for the front end alone, not for
        the work queued before it (the trainer's previous step). None: the
        current stream.

    Returns:
      dict with 'rgb_map' (N, 3), 'depth_map' (N,, no gradient) and
      'acc_map' (N,); a grouped training render adds 'shaded_groups' (N,)
      int32.
    """
    if rcfg.rgb_cap < 0:
        raise ValueError(f"rgb_cap {rcfg.rgb_cap}: the renderer takes a resolved capacity "
                         "(the trainer resolves -1 and -2)")
    kw = dict(iteration=iteration, alpha_volume=alpha_volume, alpha_aabb=alpha_aabb,
              sample_fn=sample_fn, generator=generator, rows=rows)
    with annotate("ngf.render"):
        if rcfg.group_size > 0:
            return _render_rays_grouped(params, model_cfg, rcfg, rays, front_stream=front_stream,
                                        **kw)
        return _render_rays_dense(params, model_cfg, rcfg, rays, **kw)


def join_stream(stream: torch.cuda.Stream, tensors) -> None:
    """The current stream waits for the work queued on ``stream``, and each
    of ``tensors`` made there stays allocated until the current stream's
    work queued so far is done."""
    current = torch.cuda.current_stream(stream.device)
    current.wait_stream(stream)
    for t in tensors:
        t.record_stream(current)


def _pack_map(got: torch.Tensor) -> torch.Tensor:
    """The packed layout of K4's (n, capg) ``got``: the slot ids ``ray * capg
    + j`` of the kept groups in ray order (K4 puts them at the front of each
    ray's slots, in marching order); slot 0 alone where no group is kept, so
    that every leaf still takes a gradient (zero: that slot's ``vmask`` is
    0). The kept count sizes the rows, so reading it synchronises."""
    ids = torch.nonzero(got.reshape(-1)).squeeze(1)
    return ids if ids.shape[0] else ids.new_zeros(1)


def _count_samples(n: int, slots: int, vmask: torch.Tensor) -> None:
    """The front end's counters while tracing: the rays, the sample slots
    the field decodes, and the samples in the box and the mask (two
    kernels: a sum a ray, and its add)."""
    if enabled():
        count("rays", n)
        count("slots", slots)
        count("kept", vmask.sum(-1))


def _count_shaded(weight: torch.Tensor, thres: float) -> None:
    """The samples whose blend weight clears the shading threshold, in a
    training render while tracing (three kernels: the test into a float
    buffer, a sum a ray, its add)."""
    if enabled():
        count("shaded", torch.gt(weight, thres, out=torch.empty_like(weight)).sum(-1))


def _render_rays_dense(
    params: Any,
    model_cfg: TriPlaneConfig,
    rcfg: RenderConfig,
    rays: torch.Tensor,
    *,
    iteration: int,
    alpha_volume: torch.Tensor | None,
    alpha_aabb: torch.Tensor | None,
    sample_fn,
    generator: torch.Generator | None,
    rows: tuple[int, int] | None,
) -> dict[str, torch.Tensor]:
    """The dense path (`ngf_tpu/render/volume.py:375-508`)."""
    aabb = rcfg.aabb_tensor(rays.device)
    rays_o, viewdirs = rays[:, 0:3], rays[:, 3:6]
    train = generator is not None

    with annotate("ngf.render.frontend"):
        jitter = None if not train else _jitter_rows(generator, rays.shape[0], rays.device, rows)
        pts, z_vals, valid = stratified_sample(
            rays_o, viewdirs, aabb, rcfg.near, rcfg.far, rcfg.n_samples, rcfg.step_size, jitter
        )
        # Forward differences with a trailing zero (`FieldBase.py:235`).
        dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1], torch.zeros_like(z_vals[:, :1])], dim=-1)

        if alpha_volume is not None:
            # Occupancy lookup (`ngf_tpu/render/volume.py:42-54,429-452`): K3.
            a_aabb = aabb if alpha_aabb is None else alpha_aabb
            valid = valid & _occupied(_occupancy_bytes(alpha_volume), pts, a_aabb, rcfg.mask_stride)

        if rcfg.sample_cap and rcfg.sample_cap < rcfg.n_samples:
            order_key = (~valid).to(torch.int32)
            pts, z_vals, dists, valid = _compact(order_key, rcfg.sample_cap, pts, z_vals, dists,
                                                 valid)

        n, s = z_vals.shape
        vmask = valid.to(pts.dtype)
        _count_samples(n, n * s, vmask)

    topk = 0 < rcfg.rgb_cap < s
    with annotate("ngf.field"):
        xy, yz, xz = triplane_project(normalize_coord(pts, aabb))
        xy, yz, xz = triplane_gauge(params, model_cfg, xy, yz, xz, iteration, sample_fn)
        if topk:
            # Top-K shading (`ngf_tpu/render/volume.py:473-487`): density at
            # every sample, appearance at the K samples of largest weight.
            sigma = triplane_density(params, model_cfg, xy, yz, xz, sample_fn) * vmask
        else:
            # Appearance is decoded at every sample whose density is fetched,
            # so without a sampler of the caller's both come from one fetch of
            # all channels (the same values as two fetches); a ``sample_fn``
            # sees the density and appearance fetches of each plane apart, as
            # the JAX package's dense path makes them.
            if sample_fn is None:
                sigma, rgb_feat = triplane_density_and_rgbfeat(params, model_cfg, xy, yz, xz)
            else:
                sigma = triplane_density(params, model_cfg, xy, yz, xz, sample_fn)
            sigma = sigma * vmask
            views = viewdirs[:, None, :].expand(n, s, 3)
            if sample_fn is None:
                rgb = triplane_rgb_from_feats(params, model_cfg, rgb_feat, views)
            else:
                rgb = triplane_rgb(params, model_cfg, xy, yz, xz, views, sample_fn)

    with annotate("ngf.render.composite"):
        # Decided once: K5 keeps its weights only when they are counted.
        counted = train and enabled()
        background = _background(rcfg.white_bg, generator, rays.device)
        if topk:
            w, acc_map, depth_map = composite_weights(sigma, dists * rcfg.distance_scale, z_vals,
                                                      rays[:, -1])
            top = torch.topk(w.detach(), rcfg.rgb_cap, dim=-1).indices
            rgb_map = _shade_topk(params, model_cfg, rcfg, (xy, yz, xz), None, top, 1, viewdirs,
                                  w, acc_map, background, sample_fn)
        else:
            # The composite (K5): rgb only where the blend weight clears the
            # threshold (`FieldBase.py:261-265`); as
            # `ngf_tpu/render/volume.py:503-506` has it, the last ray component
            # (the z of the direction) fills the missed transmittance of the
            # depth. The weights are kept only to count them.
            rgb_map, acc_map, depth_map, w = composite(
                sigma, dists * rcfg.distance_scale, rgb, z_vals, rays[:, -1], background,
                rcfg.ray_march_weight_thres, weights=counted)
        if counted:
            _count_shaded(w, rcfg.ray_march_weight_thres)
    return {"rgb_map": rgb_map, "depth_map": depth_map, "acc_map": acc_map}


def _occupied(volume: torch.Tensor, pts: torch.Tensor, aabb: torch.Tensor, stride: int):
    """The (n, S) occupancy test of the dense path's samples (K3). With
    ``stride`` K > 1 (`ngf_tpu/render/volume.py:429-447`) one query a window
    of K samples, at its centre sample, broadcast over the window; the tail
    window whose centre lies past the last sample takes the last centre's."""
    if stride <= 1:
        return occupancy_lookup(volume, pts, aabb)
    n, S = pts.shape[:2]
    occ = occupancy_lookup(volume, pts[:, stride // 2 :: stride], aabb)
    occ = occ.repeat_interleave(stride, dim=1)
    if occ.shape[1] < S:
        occ = torch.cat([occ, occ[:, -1:].expand(n, S - occ.shape[1])], dim=1)
    return occ[:, :S]


def _shade_topk(params, model_cfg, rcfg, coords, rgb_feat, idx, group, viewdirs, w, acc,
                background, sample_fn):
    """rgb_map of the top-K shaded samples: the (n, K / G) group ids
    ``idx`` (sample ids with ``group`` 1) pick the samples' prefetched
    appearance features ``rgb_feat`` (n, S, D) when given, else their
    coordinates (the three projections), whose appearance is fetched and
    decoded; one gather with a gradient, then K5's top-K colour pass."""
    n = idx.shape[0]
    k = idx.shape[1] * group
    views = viewdirs[:, None, :].expand(n, k, 3)
    if rgb_feat is not None:
        rgb_k = triplane_rgb_from_feats(params, model_cfg,
                                        gather_group_rows(rgb_feat, idx, group), views)
    else:
        sel = gather_group_rows(torch.cat(coords, dim=-1), idx, group)
        rgb_k = triplane_rgb(params, model_cfg, sel[..., 0:2], sel[..., 2:4], sel[..., 4:6],
                             views, sample_fn)
    return composite_topk(w, acc, idx, group, rgb_k, background, rcfg.ray_march_weight_thres)


def _check_grouped_knobs(rcfg: RenderConfig) -> None:
    """The preconditions of the JAX package's gather formulations
    (`ngf_tpu/render/volume.py:266-286`); every one fetches through K1 here."""
    G = rcfg.group_size
    if rcfg.pair_gather:
        if G % 2:
            raise ValueError("pair_gather requires an even group_size")
    elif rcfg.duo_bwd:
        if G % 2:
            raise ValueError("duo_bwd requires an even group_size")
    elif rcfg.tile_q > 0 and rcfg.run_len > 1 and G % rcfg.run_len:
        raise ValueError(
            f"tiled runs require group_size % run_len == 0, got {G} % {rcfg.run_len}"
        )


def _render_rays_grouped(
    params: Any,
    model_cfg: TriPlaneConfig,
    rcfg: RenderConfig,
    rays: torch.Tensor,
    *,
    iteration: int,
    alpha_volume: torch.Tensor | None,
    alpha_aabb: torch.Tensor | None,
    sample_fn,
    generator: torch.Generator | None,
    rows: tuple[int, int] | None,
    front_stream: torch.cuda.Stream | None = None,
) -> dict[str, torch.Tensor]:
    """The group-compacted path (`ngf_tpu/render/volume.py:170-372`).

    The same masked-compute semantics as the dense path, with the JAX
    package's differences: samples keep or drop in groups of G consecutive
    samples, at most ``ceil(sample_cap / G)`` groups a ray (all with
    ``sample_cap`` 0); the trailing-zero dist is folded into the valid mask,
    so every dist is the constant ``step_size``; the occupancy mask is
    queried at two points a group (its quarter and three-quarter samples)
    for an even G >= 4, else at its centre sample. The front end, from the
    rays to the kept samples' coordinates, is one K4 launch
    (``group_sample_compact``: sampling, occupancy test, compaction) after
    the jitter draw; the fetches are one K1 launch.
    """
    _check_grouped_knobs(rcfg)
    aabb = rcfg.aabb_tensor(rays.device)
    viewdirs = rays[:, 3:6]
    n = rays.shape[0]
    S, G = rcfg.n_samples, rcfg.group_size
    ng = -(-S // G)
    cap = rcfg.sample_cap if rcfg.sample_cap else S
    capg = min(ng, -(-cap // G))
    train = generator is not None
    kg = min(capg, max(1, rcfg.rgb_cap // G)) if rcfg.rgb_cap else capg
    topk = kg < capg
    pack = train and not topk and sample_fn is None
    front = front_stream if pack else None

    with annotate("ngf.render.frontend"):
        with torch.cuda.stream(front):  # None: the current stream
            jitter = None if not train else _jitter_rows(generator, n, rays.device, rows)
            volume = None if alpha_volume is None else _occupancy_bytes(alpha_volume)
            _, got, z_c, vmask, xyz_n = group_sample_compact(
                rays, jitter, aabb, rcfg.near, rcfg.far, S, rcfg.step_size, G, capg, volume,
                alpha_aabb, indices=pack,
            )
            if pack:
                ids = _pack_map(got)
        if front is not None:
            join_stream(front, (z_c, vmask, xyz_n, ids))
        _count_samples(n, (ids.shape[0] if pack else n * capg) * G, vmask)

    dist = float(np.float32(rcfg.step_size * rcfg.distance_scale))
    with annotate("ngf.field"):
        if pack:
            # The kept groups' rows (m, G, 3) and their rays' view directions.
            xyz = gather_rows(xyz_n.view(n * capg, G * 3), ids).view(-1, G, 3)
            views = gather_rows(viewdirs, ids // capg)[:, None, :].expand(-1, G, 3)
        else:
            xyz, views = xyz_n, viewdirs[:, None, :].expand(n, capg * G, 3)
        xy, yz, xz = triplane_project(xyz)
        xy, yz, xz = triplane_gauge(params, model_cfg, xy, yz, xz, iteration, sample_fn)
        rgb_feat = None
        if topk:
            # Top-K shading (`volume.py:315-338`): the kg groups of largest
            # best weight; their prefetched features (``fused_fetch``), or
            # density at every sample and appearance at theirs. A
            # ``sample_fn`` sees the density and appearance fetches apart, as
            # on the other paths.
            if rcfg.fused_fetch and sample_fn is None:
                sigma, rgb_feat = triplane_density_and_rgbfeat(params, model_cfg, xy, yz, xz)
            else:
                sigma = triplane_density(params, model_cfg, xy, yz, xz, sample_fn)
        else:
            if sample_fn is None:
                sigma, rgb_feat = triplane_density_and_rgbfeat(params, model_cfg, xy, yz, xz)
                rgb = triplane_rgb_from_feats(params, model_cfg, rgb_feat, views)
            else:
                sigma = triplane_density(params, model_cfg, xy, yz, xz, sample_fn)
                rgb = triplane_rgb(params, model_cfg, xy, yz, xz, views, sample_fn)
            if pack:
                # Back into the slot layout, zeros in the empty slots.
                sigma = scatter_rows(sigma, ids, n * capg).view(n, capg * G)
                rgb = scatter_rows(rgb.reshape(-1, G * 3), ids, n * capg).view(n, capg * G, 3)
            sigma = sigma * vmask

    with annotate("ngf.render.composite"):
        background = _background(rcfg.white_bg, generator, rays.device)
        if topk:
            weight, acc_map, depth_map = composite_weights(sigma * vmask, dist, z_c, rays[:, -1])
            top_g = torch.topk(weight.detach().reshape(n, capg, G).amax(-1), kg, dim=-1).indices
            rgb_map = _shade_topk(params, model_cfg, rcfg, (xy, yz, xz), rgb_feat, top_g, G,
                                  viewdirs, weight, acc_map, background, sample_fn)
        else:
            # The composite (K5) at one float32 step length for every sample
            # (`volume.py:311`). The shading mask's ``* vmask`` is implied: a
            # culled sample has sigma 0, so w 0, which does not clear the
            # threshold.
            rgb_map, acc_map, depth_map, weight = composite(
                sigma, dist, rgb, z_c, rays[:, -1], background, rcfg.ray_march_weight_thres,
                weights=train)
        if train:
            _count_shaded(weight, rcfg.ray_march_weight_thres)
    out = {"rgb_map": rgb_map, "depth_map": depth_map, "acc_map": acc_map}
    if train:
        # Per ray, the groups whose best blend weight clears the shading
        # threshold (`volume.py:359-371`), over every kept group: the
        # statistic behind rgb_cap -2.
        best = weight.detach().reshape(n, capg, G).amax(-1)
        out["shaded_groups"] = (best > rcfg.ray_march_weight_thres).sum(-1, dtype=torch.int32)
    return out


def compute_alpha_grid_chunk(
    params: Any,
    model_cfg: TriPlaneConfig,
    xyz: torch.Tensor,
    aabb: torch.Tensor,
    step_size: float,
    alpha_volume: torch.Tensor | None = None,
    alpha_aabb: torch.Tensor | None = None,
) -> torch.Tensor:
    """Alpha 1 - exp(-sigma * step_size) at (M, 3) points
    (`ngf_tpu/render/volume.py:511-539`, `InfoInv/models/FieldBase.py:140-159`),
    the gauge at iteration -1. With a previous occupancy volume, points it
    culls get alpha 0 (K3). One K1 launch of the density channels."""
    xy, yz, xz = triplane_project(normalize_coord(xyz, aabb))
    xy, yz, xz = triplane_gauge(params, model_cfg, xy, yz, xz, -1)
    sigma = triplane_density(params, model_cfg, xy, yz, xz)
    if alpha_volume is not None:
        a_aabb = aabb if alpha_aabb is None else alpha_aabb
        mask = occupancy_lookup(_occupancy_bytes(alpha_volume), xyz, a_aabb)
        sigma = sigma * mask.to(xyz.dtype)
    return 1.0 - torch.exp(-sigma * float(np.float32(step_size)))
