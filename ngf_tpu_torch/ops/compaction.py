"""Fixed-capacity stable compaction of groups of samples: the grouped
renderer's replacement of a per-sample sort, and its whole front end.

Port of `ngf_tpu/ops/compaction.py:26-66`: samples are grouped in runs of G
consecutive samples, a group is kept iff one of its samples is valid, and
each ray keeps its first ``capg`` such groups in marching order.
:func:`group_sample_compact` is the renderer's call, from the rays to the
kept samples' depths, validity and normalised coordinates: on CUDA tensors
it launches the hand-written kernel ``group_sample_compact`` (K4,
`ngf_tpu_torch/ops/cuda_kernels.py`) once; on CPU tensors it runs
:func:`group_sample_compact_plain`, the composition of the JAX package's
grouped front end (`ngf_tpu/render/volume.py:218-264`) built from
``stratified_sample``, ``occupancy_lookup_plain``, :func:`group_compact_plain`
(itself :func:`group_compact_indices` and :func:`gather_groups`) and
``normalize_coord``. There is no fallback between the two.
"""

from __future__ import annotations

import torch

from . import cuda_kernels
from .grid_sample import normalize_coord, occupancy_lookup_plain
from .rays import stratified_sample


def group_compact_indices(gvalid: torch.Tensor, capg: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable-partition gather indices at group granularity
    (`ngf_tpu/ops/compaction.py:26-47`).

    Args:
      gvalid: (N, NG) bool, the group has a valid sample.
      capg: output capacity (groups per ray).

    Returns:
      idx (N, capg) int32, the group of each slot (0 in a pad slot), and
      got (N, capg) bool, the slot holds a group.
    """
    ng = gvalid.shape[1]
    dest = torch.cumsum(gvalid.to(torch.int32), dim=-1) - 1
    slots = torch.arange(capg, dtype=torch.int32, device=gvalid.device)
    oh = (dest[:, None, :] == slots[None, :, None]) & gvalid[:, None, :]
    iota = torch.arange(ng, dtype=torch.int32, device=gvalid.device)
    idx = (oh * iota[None, None, :]).sum(-1, dtype=torch.int32)
    return idx, oh.any(-1)


def gather_groups(x: torch.Tensor, idx: torch.Tensor, group: int) -> torch.Tensor:
    """Whole groups of ``group`` consecutive samples of an (N, S, D) payload
    at (N, capg) group indices -> (N, capg * group, D)
    (`ngf_tpu/ops/compaction.py:50-66`)."""
    n, s, d = x.shape
    if s % group:
        raise ValueError(f"{s} samples are not a multiple of group {group}")
    blocks = x.reshape(n, s // group, group * d)
    sel = torch.gather(blocks, 1, idx.long()[..., None].expand(-1, -1, group * d))
    return sel.reshape(n, idx.shape[1] * group, d)


def group_compact_plain(
    z_vals: torch.Tensor, valid: torch.Tensor, group: int, capg: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The compaction of the plain front end, as
    `ngf_tpu/render/volume.py:252-260` composes it: (idx, got, z_c, vmask)
    with z_c and vmask the (z_vals, valid) payload of the kept groups and
    vmask zero in pad slots."""
    n, s_pad = z_vals.shape
    gvalid = valid.reshape(n, s_pad // group, group).any(-1)
    idx, got = group_compact_indices(gvalid, capg)
    sel = gather_groups(torch.stack([z_vals, valid.to(z_vals.dtype)], dim=-1), idx, group)
    vmask = sel[..., 1] * got.to(sel.dtype).repeat_interleave(group, dim=1)
    return idx, got, sel[..., 0], vmask


def group_sample_compact_plain(
    rays: torch.Tensor,
    jitter: torch.Tensor | None,
    aabb: torch.Tensor,
    near: float,
    far: float,
    n_samples: int,
    step_size: float,
    group: int,
    capg: int,
    volume: torch.Tensor | None = None,
    volume_aabb: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the ``group_sample_compact`` kernel: the
    grouped front end as `ngf_tpu/render/volume.py:218-264` composes it.
    ``stratified_sample``; the last sample invalid (its trailing-zero dist
    gives alpha 0); edge padding of the depths and invalid pad samples to
    ``ng * group``; with a volume, its occupancy queried two times a group
    (the quarter and three-quarter samples, each serving half the group) for
    an even group >= 4, else once at the centre sample, at points computed
    as ``stratified_sample`` computes every sample; :func:`group_compact_plain`;
    the kept samples' points normalised with the render box.

    Returns (idx, got, z_c, vmask, xyz_n) as
    :func:`cuda_kernels.group_sample_compact` documents them."""
    rays_o, viewdirs = rays[:, 0:3], rays[:, 3:6]
    n = rays.shape[0]
    S, G = n_samples, group
    s_pad = -(-S // G) * G
    _, z_vals, valid = stratified_sample(rays_o, viewdirs, aabb, near, far, S, step_size, jitter)
    valid[:, S - 1] = False
    if s_pad > S:  # edge padding for the depths, zeros for the mask
        z_vals = torch.cat([z_vals, z_vals[:, -1:].expand(n, s_pad - S)], dim=1)
        valid = torch.cat([valid, valid.new_zeros((n, s_pad - S))], dim=1)
    if volume is not None:
        if G >= 4 and G % 2 == 0:
            zq, per = z_vals[:, G // 4 :: G // 2], G // 2
        else:
            zq, per = z_vals[:, G // 2 :: G], G
        q = rays_o[:, None, :] + viewdirs[:, None, :] * zq[..., None]
        occ = occupancy_lookup_plain(volume, q, aabb if volume_aabb is None else volume_aabb)
        valid = (valid.view(n, -1, per) & occ[..., None]).view(n, s_pad)
    idx, got, z_c, vmask = group_compact_plain(z_vals, valid, G, capg)
    pts_c = rays_o[:, None, :] + viewdirs[:, None, :] * z_c[..., None]
    return idx, got, z_c, vmask, normalize_coord(pts_c, aabb)


def group_sample_compact(
    rays: torch.Tensor,
    jitter: torch.Tensor | None,
    aabb: torch.Tensor,
    near: float,
    far: float,
    n_samples: int,
    step_size: float,
    group: int,
    capg: int,
    volume: torch.Tensor | None = None,
    volume_aabb: torch.Tensor | None = None,
    indices: bool = False,
):
    """Per ray, the first ``capg`` groups of ``group`` consecutive samples
    that hold a valid sample, in marching order, from the rays on: the
    grouped renderer's front end.

    Args:
      rays: (n, 6) [origin, direction]; jitter: (n, 1) or None.
      aabb: (2, 3) render box; near, far, n_samples, step_size as
        ``stratified_sample`` takes them.
      volume: optional (D, H, W) occupancy (uint8 on the card) with
        ``volume_aabb`` its box (None: the render box).
      indices: also return idx and got, else None for both.

    Returns:
      idx (n, capg) int32 (0 in a pad slot) and got (n, capg) bool, or None;
      z_c (n, capg * group) float32 (group 0's depths in a pad slot); vmask
      (n, capg * group) float32 (valid as 0/1, 0 in a pad slot); xyz_n
      (n, capg * group, 3) float32, the kept samples in [-1, 1] of the box.
    """
    args = (rays, jitter, aabb, near, far, n_samples, step_size, group, capg, volume, volume_aabb)
    if rays.is_cuda:
        return cuda_kernels.group_sample_compact(*args, indices=indices)
    others = [t for t in (jitter, aabb, volume, volume_aabb) if t is not None]
    if rays.device.type != "cpu" or any(t.device != rays.device for t in others):
        raise ValueError(
            f"group_sample_compact on {rays.device} with {[str(t.device) for t in others]}"
        )
    idx, got, *rest = group_sample_compact_plain(*args)
    return (idx, got, *rest) if indices else (None, None, *rest)
