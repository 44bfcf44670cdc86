"""Alpha compositing along rays: port of `ngf_tpu/ops/compositing.py:17-46`
(reference `InfoInv/models/FieldBase.py:12-19`)."""

from __future__ import annotations

import torch


def exclusive_transmittance(alpha: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """T_i = prod_{j<i} (1 - alpha_j + 1e-10), with the reference's 1e-10
    inside the cumprod. Returns (T (..., S) with T_0 = 1, T_total (..., 1))."""
    t = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], dim=-1), dim=-1
    )
    return t[..., :-1], t[..., -1:]


def raw2alpha(
    sigma: torch.Tensor, dist: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Density and segment length -> (alpha, blend weights, background weight)."""
    alpha = 1.0 - torch.exp(-sigma * dist)
    t, t_total = exclusive_transmittance(alpha)
    return alpha, alpha * t, t_total
