"""Row gather ``out = tab[idx]``: the trainer's batch assembly.

The counterpart of the three Mosaic gather probes of `tools/probe_pallas.py`
(``take``, ``take_along``, ``scalar_ds``), which all compute this function,
and of ``self.all_rays[ids]`` / ``self.all_rgbs[ids]`` in
`ngf_tpu/train/loop.py:1438-1451`. On a CUDA tensor :func:`gather_rows`
launches the hand-written kernel ``gather_rows``
(`ngf_tpu_torch/ops/cuda_kernels.py`); on a CPU tensor it runs the plain
version. There is no fallback between the two.
"""

from __future__ import annotations

import torch

from . import cuda_kernels


def gather_rows_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the ``gather_rows`` kernel: ``tab[idx]``."""
    return tab[idx]


def gather_rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (B,) of the (R, D) table ``tab``, as a (B, D) tensor.
    The trainer assembles each batch with one call on its (N, 9) table of
    rays and colours."""
    if tab.is_cuda:  # the kernel's wrapper checks that idx is on tab's device
        return cuda_kernels.gather_rows(tab, idx)
    if tab.device != idx.device:
        raise ValueError(f"tab on {tab.device} but idx on {idx.device}")
    if tab.device.type != "cpu":
        raise ValueError(f"gather_rows runs on cuda or cpu, not {tab.device}")
    return gather_rows_plain(tab, idx)
