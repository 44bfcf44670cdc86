"""Frequency positional encoding and the InfoInv phase-transform modulation.

Port of `ngf_tpu/ops/encoding.py:22-60` (reference
`InfoInv/models/networks.py:227-237`). For input of last dim D and F bands
the layout is coordinate-major, frequency-minor, with the whole sin block
before the whole cos block:

    [sin(x0*2^0), ..., sin(x0*2^{F-1}), sin(x1*2^0), ..., cos(x0*2^0), ...]

InfoInv multiplies plane features elementwise by this encoding, so feature
channel c is bound to one (coordinate, frequency, sin|cos) triple.
"""

from __future__ import annotations

import torch


def positional_encoding(x: torch.Tensor, freqs: int) -> torch.Tensor:
    """(..., D) -> (..., 2*D*freqs): sin block then cos block
    (`ngf_tpu/ops/encoding.py:22-35`)."""
    bands = 2.0 ** torch.arange(freqs, device=x.device, dtype=torch.float32)
    pts = (x[..., None] * bands.to(x.dtype)).reshape(*x.shape[:-1], x.shape[-1] * freqs)
    return torch.cat([torch.sin(pts), torch.cos(pts)], dim=-1)


def infoinv_modulate(feat: torch.Tensor, xyz: torch.Tensor, freqs: int) -> torch.Tensor:
    """Multiply (..., 2*3*freqs) features by PE(xyz)
    (`ngf_tpu/ops/encoding.py:38-60`, `InfoInv/models/Field.py:54-64`)."""
    pe = positional_encoding(xyz, freqs)
    if pe.shape[-1] != feat.shape[-1]:
        raise ValueError(
            f"InfoInv channel mismatch: features have {feat.shape[-1]} channels "
            f"but PE({freqs} freqs) of 3D points has {pe.shape[-1]}"
        )
    return feat * pe
