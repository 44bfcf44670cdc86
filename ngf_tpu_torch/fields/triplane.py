"""Tri-plane fields: InfoInv and learned-gauge variants.

Port of `ngf_tpu/fields/triplane.py` (reference
`InfoInv/models/Field.py`, `TriPlane/models/Field.py`). Planes are
channels-last (H, W, C). A fetch takes the three planes at their three
projections in one call of :func:`ngf_tpu_torch.ops.grid_sample.grid_sample_planes`,
which launches the ``bilinear_gather_planes`` CUDA kernel once on the card
and its backward kernel for the plane gradients, and returns (..., 3, C)
features that are the decoder input as they lie. A fetch names its channels
of the whole plane, so neither the slice nor its gradient is copied. The
fused pair :func:`triplane_density_and_rgbfeat` /
:func:`triplane_rgb_from_feats` fetches all channels once and splits them
into both decoders' inputs. The learned gauge's planes are fetched at
deformed coordinates, whose gradient the fetch's backward gives too; its
events crop (:func:`shrink_planes`) and resize (:func:`upsample_planes`) the
planes to three shapes.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..ops.encoding import infoinv_modulate
from ..ops.grid_sample import grid_sample_planes, resize_bilinear_2d
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


_PLANES = ("plane_xy", "plane_yz", "plane_xz")
_GAUGES = ("gauge_xy", "gauge_yz", "gauge_xz")


def triplane_gauge(
    params: Params, cfg: TriPlaneConfig, xy, yz, xz, iteration: int, sample_fn=None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Learned gauge deformation with cross-plane coupling
    (`ngf_tpu/fields/triplane.py:141-189`, `TriPlane/models/Field.py:53-75`).
    Before ``gauge_start`` the offsets are fetched and multiplied by 0, as the
    JAX package does: the gauge grids then get a zero gradient, not none, and
    Adam counts their steps as optax does. The three (G, G, 2) gauge grids are
    fetched in one three-plane gather, or one by one through ``sample_fn``;
    the deformed coordinates carry the gradient back into them through the
    planes' fetch."""
    if cfg.variant != "gauge":
        return xy, yz, xz
    active = float(iteration >= cfg.gauge_start)
    grids, coords = [params[n] for n in _GAUGES], (xy, yz, xz)
    if sample_fn is None:
        offsets = grid_sample_planes(grids, coords)[0].unbind(-2)
    else:
        offsets = [sample_fn(g, c, n) for g, c, n in zip(grids, coords, _GAUGES)]
    dxy, dyz, dxz = (d * active for d in offsets)
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


def _plane_feats(
    params: Params, cfg: TriPlaneConfig, xy, yz, xz, channels: slice, split: int | None = None,
    sample_fn=None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Channels ``channels`` of the three planes at their projections
    (`ngf_tpu/fields/triplane.py:192-211`) as (..., 3, C) features, split at
    ``split`` as :func:`grid_sample_planes` returns them: one gather of all
    three planes, or one ``sample_fn(plane[..., channels], coords, name)``
    call per plane. Coordinates stay float32 through the sampler: a bfloat16
    coordinate moves a stencil by up to half a texel at 256-res planes. Only
    the plane values run in the compute dtype. The gather takes the whole
    float32 planes with the channel range and the compute dtype, and casts
    inside, so a fetch's gradient lands in its channels of the float32
    planes' as the kernels sum it; a ``sample_fn`` gets each plane's
    channels cast with a tracked ``.to``, as the JAX package's sampler does,
    whose backward rounds the plane gradient to the compute dtype once."""
    dt = cfg.dtype
    planes = [params[n] for n in _PLANES]
    coords = (xy, yz, xz)
    if sample_fn is None:
        return grid_sample_planes(planes, coords, channels, split, dtype=dt)
    full = torch.stack(
        [sample_fn(p[..., channels].to(dt), c, n) for p, c, n in zip(planes, coords, _PLANES)],
        dim=-2,
    )
    return (full, None) if split is None else (full[..., :split], full[..., split:])


def _pe_coords(xy: torch.Tensor, yz: torch.Tensor) -> torch.Tensor:
    # InfoInv/models/Field.py:54 — xyz reassembled from the projections.
    return torch.cat([xy, yz[..., 1:]], dim=-1)


def _decoder_input(feats: torch.Tensor, cfg: TriPlaneConfig, xyz, freqs: int) -> torch.Tensor:
    """(..., 3, C) plane features as the (..., 3C) decoder input, in the
    order of a ``cat`` of the three planes. With InfoInv, times PE(xyz): one
    encoding broadcast over the planes, element by element the product of
    the JAX package's three ``infoinv_modulate`` calls."""
    if cfg.infoinv:
        feats = infoinv_modulate(feats, xyz[..., None, :], freqs)
    return feats.reshape(*feats.shape[:-2], -1)


def _cast(tree: Params, cfg: TriPlaneConfig) -> Params:
    if cfg.compute_dtype == "float32":
        return tree
    dt = cfg.dtype
    if isinstance(tree, dict):
        return {k: _cast(v, cfg) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, cfg) for v in tree]
    return tree.to(dt)


def _density_from_feats(params: Params, cfg: TriPlaneConfig, feat: torch.Tensor) -> torch.Tensor:
    dec = _cast(params["density_decoder"], cfg)
    if cfg.variant == "gauge":
        raw = apply_linear(dec, feat)[..., 0]
    else:
        raw = apply_density_decoder(dec, feat)[..., 0]
    return feature2density(raw.float(), cfg.density_shift)


def triplane_density(params: Params, cfg: TriPlaneConfig, xy, yz, xz, sample_fn=None) -> torch.Tensor:
    """Density (..., ) after the softplus shift
    (`ngf_tpu/fields/triplane.py:220-240`)."""
    feats, _ = _plane_feats(params, cfg, xy, yz, xz, slice(0, cfg.density_dim), None, sample_fn)
    xyz = _pe_coords(xy, yz) if cfg.infoinv else None
    return _density_from_feats(params, cfg, _decoder_input(feats, cfg, xyz, cfg.density_pe))


def triplane_rgb(
    params: Params, cfg: TriPlaneConfig, xy, yz, xz, viewdirs, sample_fn=None
) -> torch.Tensor:
    """RGB (..., 3) in float32 (`ngf_tpu/fields/triplane.py:243-259`)."""
    feats, _ = _plane_feats(
        params, cfg, xy, yz, xz, slice(cfg.density_dim, cfg.plane_dim), None, sample_fn
    )
    xyz = _pe_coords(xy, yz) if cfg.infoinv else None
    return triplane_rgb_from_feats(
        params, cfg, _decoder_input(feats, cfg, xyz, cfg.rgb_pe), viewdirs
    )


def triplane_density_and_rgbfeat(
    params: Params, cfg: TriPlaneConfig, xy, yz, xz, sample_fn=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused fetch (`ngf_tpu/fields/triplane.py:262-292`): one gather of all
    plane channels per point and plane, split into the density and
    appearance decoders' inputs. Returns (density (...,), rgb_feat
    (..., 3 * rgb_dim) already InfoInv-modulated); decode rgb with
    :func:`triplane_rgb_from_feats`. Without ``sample_fn`` this is one
    launch of the gather kernel that writes both inputs in place."""
    dfeat, rfeat = _plane_feats(
        params, cfg, xy, yz, xz, slice(0, cfg.plane_dim), cfg.density_dim, sample_fn
    )
    xyz = _pe_coords(xy, yz) if cfg.infoinv else None
    sigma = _density_from_feats(params, cfg, _decoder_input(dfeat, cfg, xyz, cfg.density_pe))
    return sigma, _decoder_input(rfeat, cfg, xyz, cfg.rgb_pe)


def triplane_rgb_from_feats(
    params: Params, cfg: TriPlaneConfig, feats: torch.Tensor, viewdirs: torch.Tensor
) -> torch.Tensor:
    """RGB (..., 3) in float32 from pre-fetched, already modulated
    appearance features (`ngf_tpu/fields/triplane.py:295-303`)."""
    rgb = apply_rgb_decoder(
        _cast(params["rgb_decoder"], cfg), feats, viewdirs.to(feats.dtype), cfg.view_pe
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


@torch.no_grad()
def upsample_planes(params: Params, res) -> Params:
    """Bilinear resize of the three planes to the per-axis resolution
    ``res`` = (rx, ry, rz) (`ngf_tpu/fields/triplane.py:322-335`,
    `TriPlane/models/Field.py:108-114`): ``plane_xy`` becomes (ry, rx, C),
    ``plane_yz`` (rz, ry, C) and ``plane_xz`` (rz, rx, C). The other entries
    are kept as they are."""
    rx, ry, rz = (int(v) for v in res)
    out = dict(params)
    out["plane_xy"] = resize_bilinear_2d(params["plane_xy"], (ry, rx))
    out["plane_yz"] = resize_bilinear_2d(params["plane_yz"], (rz, ry))
    out["plane_xz"] = resize_bilinear_2d(params["plane_xz"], (rz, rx))
    return out


@torch.no_grad()
def shrink_planes(params: Params, t_l, b_r) -> Params:
    """Crop the three planes to the voxel box [t_l, b_r) of integer (x, y, z)
    voxel coordinates (`ngf_tpu/fields/triplane.py:338-350`,
    `TriPlane/models/Field.py:117-132`). The crops are contiguous copies: the
    gather kernel takes planes whose rows are W texels apart. The gauge
    grids and decoders are kept as they are."""
    t_l = [int(v) for v in t_l]
    b_r = [int(v) for v in b_r]
    out = dict(params)
    out["plane_xy"] = params["plane_xy"][t_l[1] : b_r[1], t_l[0] : b_r[0]].contiguous()
    out["plane_yz"] = params["plane_yz"][t_l[2] : b_r[2], t_l[1] : b_r[1]].contiguous()
    out["plane_xz"] = params["plane_xz"][t_l[2] : b_r[2], t_l[0] : b_r[0]].contiguous()
    return out
