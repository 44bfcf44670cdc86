"""Row gather ``out = tab[idx]`` and its backward, the row scatter: the
trainer's batch assembly, the top-K renderers' group gather, and the
packed training render's gather of its kept groups and scatter back
(:func:`scatter_rows`, whose backward is the gather).

The counterpart of the three Mosaic gather probes of `tools/probe_pallas.py`
(``take``, ``take_along``, ``scalar_ds``), which all compute this function,
of ``self.all_rays[ids]`` / ``self.all_rgbs[ids]`` in
`ngf_tpu/train/loop.py:1438-1451`, and of the top-K shading gathers of
`ngf_tpu/render/volume.py` (``gather_groups`` of the top groups, `:320-332`;
the dense path's ``take_along_axis`` of the top samples, `:480-483`). On a
CUDA tensor :func:`gather_rows` launches the hand-written kernel
``gather_rows`` and its gradient the kernel ``scatter_rows``
(`ngf_tpu_torch/ops/cuda_kernels.py`); on a CPU tensor they run the plain
versions. There is no fallback between the two.
"""

from __future__ import annotations

import torch

from . import cuda_kernels


def _rows(idx: torch.Tensor, per: int, seg: int) -> torch.Tensor:
    """The absolute rows of ids relative to segments (``per`` > 0), as
    ``take_along_axis`` reads an id of a segment of ``seg`` rows: one in
    [-seg, seg) wrapped into [0, seg), one outside it -1 (no row)."""
    if per <= 0:
        return idx
    offset = torch.arange(idx.shape[0], device=idx.device, dtype=idx.dtype) // per * seg
    inside = (idx >= -seg) & (idx < seg)
    return torch.where(inside, torch.where(idx < 0, idx + seg, idx) + offset, -1)


def gather_rows_plain(tab: torch.Tensor, idx: torch.Tensor, per: int = 0, seg: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the ``gather_rows`` kernel: ``tab[rows]``,
    a row of NaN where an id names no row of [0, R)."""
    rows = _rows(idx, per, seg)
    ok = (rows >= 0) & (rows < tab.shape[0])
    return tab[torch.where(ok, rows, 0)].masked_fill(~ok[:, None], float("nan"))


def scatter_rows_plain(src: torch.Tensor, idx: torch.Tensor, rows: int, per: int = 0,
                       seg: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the ``scatter_rows`` kernel: zeros of
    (rows, D) with ``src`` at the (distinct) rows of ``idx``; an id that
    names no row of [0, rows) is dropped."""
    out = src.new_zeros((rows, src.shape[1]))
    at = _rows(idx, per, seg)
    ok = (at >= 0) & (at < rows)
    out[at[ok]] = src[ok]
    return out


def _check_cpu(tab: torch.Tensor, idx: torch.Tensor) -> None:
    if tab.device != idx.device:
        raise ValueError(f"tab on {tab.device} but idx on {idx.device}")
    if tab.device.type != "cpu":
        raise ValueError(f"gather_rows runs on cuda or cpu, not {tab.device}")


def _scatter(src, idx, rows, per=0, seg=0):
    if src.is_cuda:
        return cuda_kernels.scatter_rows(src, idx, rows, per, seg)
    _check_cpu(src, idx)
    return scatter_rows_plain(src, idx, rows, per, seg)


def _gather(tab, idx, per, seg):
    if tab.is_cuda:  # the kernel's wrapper checks that idx is on tab's device
        return cuda_kernels.gather_rows(tab, idx, per, seg)
    _check_cpu(tab, idx)
    return gather_rows_plain(tab, idx, per, seg)


class _GatherRows(torch.autograd.Function):
    """The row gather as one autograd node; its backward is the scatter."""

    @staticmethod
    def forward(ctx, tab, idx, per, seg):
        ctx.save_for_backward(idx)
        ctx.layout = (tab.shape[0], per, seg)
        return _gather(tab, idx, per, seg)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        rows, per, seg = ctx.layout
        return _scatter(g, idx, rows, per, seg), None, None, None


def gather_rows(tab: torch.Tensor, idx: torch.Tensor, per: int = 0, seg: int = 0) -> torch.Tensor:
    """Rows ``idx`` (B,) of the (R, D) table ``tab``, as a (B, D) tensor;
    with ``per`` > 0 the ids are relative to segments of ``seg`` rows, one
    segment per ``per`` ids, as ``take_along_axis`` reads them (row b is
    ``idx[b] + (b // per) * seg``, an id in [-seg, 0) counting from the
    segment's end). A row outside [0, R), or an id outside [-seg, seg), gives
    a row of NaN. Differentiable in ``tab`` (the rows must then be
    distinct): the gradient is the scatter, which drops those rows. The trainer assembles each batch with one call
    on its (N, 9) table of rays and colours."""
    if tab.requires_grad and torch.is_grad_enabled():
        return _GatherRows.apply(tab, idx, per, seg)
    return _gather(tab, idx, per, seg)


def gather_group_rows(x: torch.Tensor, idx: torch.Tensor, group: int) -> torch.Tensor:
    """Whole groups of ``group`` consecutive samples of an (n, s, D) payload
    at (n, k) group indices -> (n, k * group, D): `ngf_tpu/ops/compaction.py:50`
    ``gather_groups`` with a gradient, as one :func:`gather_rows` of the
    (n * s / group, group * D) table at rows ``ray * s / group + id`` (one
    ``gather_rows`` launch on the card, one ``scatter_rows`` backward).
    ``group`` 1 is ``take_along_axis`` of samples. As there, an id in
    [-s / group, 0) counts from the ray's last group, and one outside
    [-s / group, s / group) gives NaN and takes no gradient. The ids of a ray
    must be distinct when ``x`` takes a gradient."""
    n, s, d = x.shape
    if s % group:
        raise ValueError(f"{s} samples are not a multiple of group {group}")
    k = idx.shape[1]
    tab = x.reshape(n * (s // group), group * d)
    out = gather_rows(tab, idx.reshape(-1), k, s // group)
    return out.view(n, k * group, d)


class _ScatterRows(torch.autograd.Function):
    """The row scatter as one autograd node; its backward is the gather at
    the same ids."""

    @staticmethod
    def forward(ctx, src, idx, rows):
        ctx.save_for_backward(idx)
        return _scatter(src, idx, rows)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return _gather(g.contiguous(), idx, 0, 0), None, None


def scatter_rows(src: torch.Tensor, idx: torch.Tensor, rows: int) -> torch.Tensor:
    """The converse of :func:`gather_rows`: an (rows, D) tensor of zeros
    with the rows of the (B, D) ``src`` at the distinct rows ``idx`` of
    [0, rows). Differentiable in ``src``: the gradient is
    :func:`gather_rows` at ``idx``. One ``scatter_rows`` launch on the card
    (a fill, then the rows) and one ``gather_rows`` backward. The packed
    training render writes its decoded rows back into the slot layout with
    it."""
    if src.requires_grad and torch.is_grad_enabled():
        return _ScatterRows.apply(src, idx, rows)
    return _scatter(src, idx, rows)
