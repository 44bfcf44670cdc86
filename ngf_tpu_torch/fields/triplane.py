"""Tri-plane fields: InfoInv and learned-gauge variants.

Port of `ngf_tpu/fields/triplane.py:44-259,313-319` (reference
`InfoInv/models/Field.py`, `TriPlane/models/Field.py`). Planes are
channels-last (H, W, C). Every plane fetch goes through
:func:`ngf_tpu_torch.ops.grid_sample.grid_sample_2d`, which launches the
``bilinear_gather_2d`` CUDA kernel on the card, and its backward kernel for
the plane gradient. A fetch names its channels of the whole plane, so
neither the slice nor its gradient is copied.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..ops.encoding import infoinv_modulate
from ..ops.grid_sample import grid_sample_2d
from .decoders import (
    Params,
    apply_density_decoder,
    apply_linear,
    apply_rgb_decoder,
    init_density_decoder,
    init_linear,
    init_rgb_decoder,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TriPlaneConfig:
    """Static model configuration (`ngf_tpu/fields/triplane.py:44-88`)."""

    variant: str = "infoinv"  # 'infoinv' | 'gauge'
    plane_res: int = 256
    plane_dim: int = 96
    density_dim: int = 24
    gauge_res: int = 256
    gauge_start: int = 0
    infoinv: bool = False  # the --infoinv PE multiply
    density_pe: int = 4  # InfoInv/models/Field.py:55
    rgb_pe: int = 12  # InfoInv/models/Field.py:75
    view_pe: int = 2
    rgb_mid: int = 64
    density_mid: int = 32
    density_shift: float = -10.0
    distance_scale: float = 25.0
    init_scale: float = 0.1
    compute_dtype: str = "float32"  # or 'bfloat16'; parameters stay float32

    @property
    def rgb_dim(self) -> int:
        return self.plane_dim - self.density_dim

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @staticmethod
    def infoinv_preset(infoinv: bool = False) -> "TriPlaneConfig":
        """InfoInv subsystem defaults (`InfoInv/models/Field.py:14-24`)."""
        return TriPlaneConfig(variant="infoinv", plane_dim=96, density_dim=24, infoinv=infoinv)

    @staticmethod
    def gauge_preset(gauge_start: int = 0) -> "TriPlaneConfig":
        """TriPlane subsystem defaults (`TriPlane/models/Field.py:17-32`)."""
        return TriPlaneConfig(
            variant="gauge", plane_dim=64, density_dim=16, gauge_start=gauge_start, infoinv=False
        )


def init_triplane(
    cfg: TriPlaneConfig, gen: torch.Generator, device: torch.device | str | None = None
) -> Params:
    """Parameter tree (`ngf_tpu/fields/triplane.py:91-120`): planes ~
    init_scale * N(0, 1), gauge grids zero, decoders with torch init.
    ``gen`` must live on ``device``; None takes the generator's device."""
    device = gen.device if device is None else device
    res, dim = cfg.plane_res, cfg.plane_dim

    def plane():
        return cfg.init_scale * torch.randn((res, res, dim), generator=gen, device=device)

    params: Params = {"plane_xy": plane(), "plane_yz": plane(), "plane_xz": plane()}
    if cfg.variant == "gauge":
        g = cfg.gauge_res
        for name in ("gauge_xy", "gauge_yz", "gauge_xz"):
            params[name] = torch.zeros((g, g, 2), device=device)
        # TriPlane/models/Field.py:29-30 — a single xavier-uniform linear.
        params["density_decoder"] = init_linear(
            gen, cfg.density_dim * 3, 1, init="xavier_uniform", zero_bias=True, device=device
        )
    else:
        params["density_decoder"] = init_density_decoder(
            gen, cfg.density_dim * 3, cfg.density_mid, device=device
        )
    params["rgb_decoder"] = init_rgb_decoder(
        gen, cfg.rgb_dim * 3, view_pe=cfg.view_pe, middle_dim=cfg.rgb_mid, device=device
    )
    return params


def feature2density(feat: torch.Tensor, density_shift: float = -10.0) -> torch.Tensor:
    """softplus(feat + shift) (`InfoInv/models/Field.py:39-40`)."""
    return F.softplus(feat + density_shift)


def triplane_project(xyz: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Orthogonal projections xy, yz, xz of (..., 3) points
    (`ngf_tpu/fields/triplane.py:128-138`); xz = (x, z). Views, no copies."""
    return xyz[..., 0:2], xyz[..., 1:3], xyz[..., 0::2]


def _sampler(sample_fn):
    return (lambda p, c, name: grid_sample_2d(p, c)) if sample_fn is None else sample_fn


def triplane_gauge(
    params: Params, cfg: TriPlaneConfig, xy, yz, xz, iteration: int, sample_fn=None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Learned gauge deformation with cross-plane coupling, forward only
    (`ngf_tpu/fields/triplane.py:141-189`, `TriPlane/models/Field.py:53-75`).
    Before ``gauge_start`` the offsets are multiplied by 0."""
    if cfg.variant != "gauge":
        return xy, yz, xz
    smp = _sampler(sample_fn)
    active = float(iteration >= cfg.gauge_start)
    dxy = smp(params["gauge_xy"], xy, "gauge_xy") * active
    dyz = smp(params["gauge_yz"], yz, "gauge_yz") * active
    dxz = smp(params["gauge_xz"], xz, "gauge_xz") * active
    target_xy = torch.stack(
        [xy[..., 0] + dxy[..., 0] + dxz[..., 0], xy[..., 1] + dxy[..., 1] + dyz[..., 0]], dim=-1
    )
    target_yz = torch.stack(
        [yz[..., 0] + dyz[..., 0] + dxy[..., 1], yz[..., 1] + dyz[..., 1] + dxz[..., 1]], dim=-1
    )
    target_xz = torch.stack(
        [xz[..., 0] + dxz[..., 0] + dxy[..., 0], xz[..., 1] + dxz[..., 1] + dyz[..., 1]], dim=-1
    )
    return target_xy, target_yz, target_xz


def _plane_feats(params: Params, cfg: TriPlaneConfig, xy, yz, xz, channels: slice, sample_fn=None):
    """(`ngf_tpu/fields/triplane.py:192-211`). Coordinates stay float32
    through the sampler: a bfloat16 coordinate moves a stencil by up to half
    a texel at 256-res planes. Only the plane values run in the compute
    dtype; in float32 the whole plane reaches the sampler with the channel
    range, so a fetch's gradient lands in its channels of the plane's."""
    dt = cfg.dtype

    def sample(name, c):
        plane, ch = params[name], channels
        if plane.dtype != dt:  # the compute-dtype copy of the slice (evaluation)
            plane, ch = plane[..., ch].to(dt), slice(None)
        if sample_fn is None:
            return grid_sample_2d(plane, c, ch)
        return sample_fn(plane[..., ch], c, name)

    return sample("plane_xy", xy), sample("plane_yz", yz), sample("plane_xz", xz)


def _pe_coords(xy: torch.Tensor, yz: torch.Tensor) -> torch.Tensor:
    # InfoInv/models/Field.py:54 — xyz reassembled from the projections.
    return torch.cat([xy, yz[..., 1:]], dim=-1)


def _cast(tree: Params, cfg: TriPlaneConfig) -> Params:
    if cfg.compute_dtype == "float32":
        return tree
    dt = cfg.dtype
    if isinstance(tree, dict):
        return {k: _cast(v, cfg) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, cfg) for v in tree]
    return tree.to(dt)


def triplane_density(params: Params, cfg: TriPlaneConfig, xy, yz, xz, sample_fn=None) -> torch.Tensor:
    """Density (..., ) after the softplus shift
    (`ngf_tpu/fields/triplane.py:220-240`)."""
    fxy, fyz, fxz = _plane_feats(params, cfg, xy, yz, xz, slice(0, cfg.density_dim), sample_fn)
    if cfg.infoinv:
        xyz = _pe_coords(xy, yz)
        fxy, fyz, fxz = (infoinv_modulate(f, xyz, cfg.density_pe) for f in (fxy, fyz, fxz))
    feat = torch.cat([fxy, fyz, fxz], dim=-1)
    dec = _cast(params["density_decoder"], cfg)
    if cfg.variant == "gauge":
        raw = apply_linear(dec, feat)[..., 0]
    else:
        raw = apply_density_decoder(dec, feat)[..., 0]
    return feature2density(raw.float(), cfg.density_shift)


def triplane_rgb(
    params: Params, cfg: TriPlaneConfig, xy, yz, xz, viewdirs, sample_fn=None
) -> torch.Tensor:
    """RGB (..., 3) in float32 (`ngf_tpu/fields/triplane.py:243-259`)."""
    fxy, fyz, fxz = _plane_feats(
        params, cfg, xy, yz, xz, slice(cfg.density_dim, cfg.plane_dim), sample_fn
    )
    if cfg.infoinv:
        xyz = _pe_coords(xy, yz)
        fxy, fyz, fxz = (infoinv_modulate(f, xyz, cfg.rgb_pe) for f in (fxy, fyz, fxz))
    feat = torch.cat([fxy, fyz, fxz], dim=-1)
    rgb = apply_rgb_decoder(
        _cast(params["rgb_decoder"], cfg), feat, viewdirs.to(feat.dtype), cfg.view_pe
    )
    return rgb.float()


def density_l1(params: Params) -> torch.Tensor:
    """L1 regularizer over all three planes (`ngf_tpu/fields/triplane.py:313-319`,
    `InfoInv/models/Field.py:107-110`)."""
    return (
        params["plane_xy"].abs().mean()
        + params["plane_yz"].abs().mean()
        + params["plane_xz"].abs().mean()
    )
