"""Fixed-capacity stable compaction of groups of samples: the grouped
renderer's replacement of a per-sample sort.

Port of `ngf_tpu/ops/compaction.py:26-66`: samples are grouped in runs of G
consecutive samples, a group is kept iff one of its samples is valid, and
each ray keeps its first ``capg`` such groups in marching order.
:func:`group_compact` is the renderer's call: on CUDA tensors it launches
the hand-written kernel ``group_compact`` (K4,
`ngf_tpu_torch/ops/cuda_kernels.py`) once; on CPU tensors it runs
:func:`group_compact_plain`, built from the JAX package's two functions
:func:`group_compact_indices` and :func:`gather_groups`. There is no
fallback between the two.
"""

from __future__ import annotations

import torch

from . import cuda_kernels


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
    """Plain PyTorch version of the ``group_compact`` kernel, as
    `ngf_tpu/render/volume.py:252-260` composes it: (idx, got, z_c, vmask)
    with z_c and vmask the (z_vals, valid) payload of the kept groups and
    vmask zero in pad slots."""
    n, s_pad = z_vals.shape
    gvalid = valid.reshape(n, s_pad // group, group).any(-1)
    idx, got = group_compact_indices(gvalid, capg)
    sel = gather_groups(torch.stack([z_vals, valid.to(z_vals.dtype)], dim=-1), idx, group)
    vmask = sel[..., 1] * got.to(sel.dtype).repeat_interleave(group, dim=1)
    return idx, got, sel[..., 0], vmask


def group_compact(
    z_vals: torch.Tensor, valid: torch.Tensor, group: int, capg: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per ray, the first ``capg`` groups of ``group`` consecutive samples
    that hold a valid sample, in marching order.

    Args:
      z_vals: (n, s_pad) float32 sample depths, s_pad a multiple of group.
      valid: (n, s_pad) bool.

    Returns:
      idx (n, capg) int32 (0 in a pad slot), got (n, capg) bool,
      z_c (n, capg * group) float32 (group 0's depths in a pad slot) and
      vmask (n, capg * group) float32 (valid as 0/1, 0 in a pad slot).
    """
    if z_vals.is_cuda:
        return cuda_kernels.group_compact(z_vals, valid, group, capg)
    if z_vals.device.type != "cpu" or valid.device != z_vals.device:
        raise ValueError(f"group_compact on {z_vals.device} with valid on {valid.device}")
    return group_compact_plain(z_vals, valid, group, capg)
