"""NeuTex UV-mapping model: the gauge transform to a 2D (square) or
spherical manifold, the geometry and texture MLPs, the inverse gauge.

Port of `ngf_tpu/fields/neutex.py` (reference `UV-Mapping/model/`), the
wiring of `NeuTex.forward` (`UV-Mapping/model/model.py:11-59`):

  cube ray generation -> geometry MLP -> softplus density; gauge network
  3D -> UV (tanh / L2-normalise) -> texture MLP colour; K5 ray march with
  background and tone map (``ops.compositing.march_rays``); the inverse
  gauge on random template points for the origin loss.

Parameters are nested dicts of tensors with the JAX package's names and
(in, out) weights, so a checkpoint loads in both packages. Differences from
the JAX functions:
- Draws are injected: ``neutex_forward`` takes the jitter ``u`` and the
  template points; the caller draws them from a ``torch.Generator``.
- ``neutex_forward`` runs the 512-wide inverse network on the sample points
  (``points_inverse``) only when ``inverse`` is set (the inverse-mapping
  loss weighs more than 0; XLA drops it otherwise), and the inverse network
  on the template only when template points are given. Rendering passes
  neither.
- Tracing (`utils/profiling.py`): the span ``ngf.field`` holds the four
  networks' forward, each in its own span (``ngf.uv.geometry``,
  ``ngf.uv.gauge``, ``ngf.uv.texture``, ``ngf.uv.inverse`` for the template
  and the samples), and ``ngf.render.composite`` K5; the host counters
  ``rays``, ``slots`` (the samples decoded) and ``template`` (the template
  points through the inverse network).
- ``compute_dtype`` bfloat16: the stacks' products in bfloat16 with float32
  sums (``decoders.apply_linear``); PE, softplus, tanh / normalise,
  compositing and the losses in float32, block 1's output in bfloat16, as
  in JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.compositing import march_rays
from ..ops.encoding import positional_encoding
from ..ops.rays import cube_ray_generation
from ..utils.cubemap import (
    convert_cube_uv_to_xyz,
    generate_grid,
    icosphere,
    icosphere_mesh,
    sample_cubemap,
    sample_square,
)
from ..utils.profiling import annotate, count
from .decoders import Params, apply_linear, init_linear

LEAKY_SLOPE = 0.2
_RELU_GAIN = math.sqrt(2.0)
_LEAKY_GAIN = math.sqrt(2.0 / (1.0 + LEAKY_SLOPE ** 2))
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class NeuTexConfig:
    """Static model config (`ngf_tpu/fields/neutex.py:49-87`); the same
    fields, so a checkpoint's ``cfg`` meta reads in both packages."""

    primitive_type: str = "square"  # 'square' | 'sphere'
    sample_num: int = 64
    points_per_primitive: int = 2500
    jitter: float = 0.05
    geo_freqs: int = 10
    geo_hidden: int = 256
    geo_layers: int = 10
    tex_freqs: int = 10
    view_freqs: int = 6
    tex_width: int = 256
    tex_layers1: int = 5
    tex_layers2: int = 3
    clamp_texture: bool = False
    gauge_mid: int = 64
    gauge_hidden: int = 128
    gauge_layers: int = 2
    inverse_mid: int = 64
    inverse_hidden: int = 512
    inverse_layers: int = 2
    compute_dtype: str = "float32"  # or 'bfloat16'; parameters stay float32

    @property
    def uv_dim(self) -> int:
        return 2 if self.primitive_type == "square" else 3

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]


# ----------------------------------------------------------------- MLP stacks


def _init_stack(gen: torch.Generator, dims: list[int], gains: list[float], device) -> Params:
    return {
        "layers": [
            init_linear(gen, d0, d1, init="xavier_uniform", gain=g, zero_bias=True, device=device)
            for d0, d1, g in zip(dims[:-1], dims[1:], gains)
        ]
    }


def _cast_tree(tree: Any, dt: torch.dtype) -> Any:
    if dt == torch.float32:
        return tree
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dt) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dt) for v in tree]
    return tree.to(dt)


def _apply_stack(p: Params, x: torch.Tensor, act, dt: torch.dtype = torch.float32) -> torch.Tensor:
    # apply_linear runs in the weights' dtype, so casting the layers is the
    # whole mixed-precision story; a bfloat16 stack's output returns to
    # float32, a float32 one's keeps its input's dtype (float64 in the
    # tests' reference gradients).
    p = _cast_tree(p, dt)
    for lp in p["layers"][:-1]:
        x = act(apply_linear(lp, x))
    return _from_compute(apply_linear(p["layers"][-1], x), dt)


def _from_compute(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return x if dt == torch.float32 else x.float()


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LEAKY_SLOPE)


# ------------------------------------------------------------- gauge networks


def init_gauge_network(gen, cfg: NeuTexConfig, input_dim: int, output_dim: int, device=None) -> Params:
    """`GaugeNetwork` (`ngf_tpu/fields/neutex.py:121-129`): PE(10) input,
    mid 64, hidden 128, 2 extra layers; xavier gain 1."""
    dims = ([input_dim + 2 * input_dim * 10, cfg.gauge_mid, cfg.gauge_hidden]
            + [cfg.gauge_hidden] * cfg.gauge_layers + [output_dim])
    return _init_stack(gen, dims, [1.0] * (len(dims) - 1), device)


def apply_gauge_network(p: Params, x: torch.Tensor, dt=torch.float32) -> torch.Tensor:
    x = torch.cat([x, positional_encoding(x, 10)], dim=-1)
    return _apply_stack(p, x, torch.relu, dt)


def apply_gauge_transform(p: Params, cfg: NeuTexConfig, points: torch.Tensor) -> torch.Tensor:
    """3D -> UV: tanh for the square, L2-normalise for the sphere
    (`ngf_tpu/fields/neutex.py:137-143`)."""
    out = apply_gauge_network(p, points, cfg.dtype)
    if cfg.uv_dim == 2:
        return torch.tanh(out)
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True).clamp_min(1e-12)


def init_inverse_network(gen, cfg: NeuTexConfig, device=None) -> Params:
    """`InverseNetwork` (`ngf_tpu/fields/neutex.py:146-153`): no PE, hidden 512."""
    dims = ([cfg.uv_dim, cfg.inverse_mid, cfg.inverse_hidden]
            + [cfg.inverse_hidden] * cfg.inverse_layers + [3])
    return _init_stack(gen, dims, [1.0] * (len(dims) - 1), device)


def apply_inverse_network(p: Params, uv: torch.Tensor, dt=torch.float32) -> torch.Tensor:
    return _apply_stack(p, uv, torch.relu, dt)


def template_random_points(cfg: NeuTexConfig, n: int, gen: torch.Generator) -> torch.Tensor:
    """Random manifold samples (`ngf_tpu/fields/neutex.py:160-165`): uniform
    in [-1, 1]^2 for the square; for the sphere normal draws times 2 minus 1,
    normalised, as the JAX function has them."""
    if cfg.primitive_type == "square":
        return torch.rand((n, 2), generator=gen, device=gen.device) * 2.0 - 1.0
    pts = torch.randn((n, 3), generator=gen, device=gen.device) * 2.0 - 1.0
    return pts / torch.linalg.vector_norm(pts, dim=-1, keepdim=True).clamp_min(1e-12)


def template_regular_points(cfg: NeuTexConfig, n: int | None = None) -> np.ndarray:
    """Regular manifold samples (`ngf_tpu/fields/neutex.py:168-177`)."""
    if cfg.primitive_type == "square":
        n = n or cfg.points_per_primitive
        side = int(round(n ** 0.5))
        uv = np.stack(np.meshgrid(*([np.linspace(-1, 1, side)] * 2), indexing="ij"), axis=-1)
        return uv.reshape(-1, 2).astype(np.float32)
    return icosphere(6)


# ------------------------------------------------------------------- decoders


def init_geometry_mlp(gen, cfg: NeuTexConfig, device=None) -> Params:
    """`GeometryMlpDecoder` (`ngf_tpu/fields/neutex.py:183-188`): ReLU MLP on
    PE(xyz, 10), xavier with the ReLU gain, gain 1 on the last layer."""
    dims = [3 + 6 * cfg.geo_freqs] + [cfg.geo_hidden] * (cfg.geo_layers + 1) + [1]
    gains = [_RELU_GAIN] * (len(dims) - 2) + [1.0]
    return _init_stack(gen, dims, gains, device)


def apply_geometry_mlp(p: Params, cfg: NeuTexConfig, pts: torch.Tensor) -> dict:
    x = torch.cat([pts, positional_encoding(pts, cfg.geo_freqs)], dim=-1)
    raw = _apply_stack(p, x, torch.relu, cfg.dtype)[..., 0]
    return {"raw_density": raw, "density": F.softplus(raw)}


def init_texture_mlp(gen, cfg: NeuTexConfig, device=None) -> Params:
    """`TextureMlpDecoder` (`ngf_tpu/fields/neutex.py:197-210`): block1 on
    PE(uv), the color1 head, block2 on [h, view, PE(view)]; leaky gains."""
    w, uv = cfg.tex_width, cfg.uv_dim
    dims1 = [uv + 2 * uv * cfg.tex_freqs] + [w] * (cfg.tex_layers1 + 1)
    block1 = _init_stack(gen, dims1, [_LEAKY_GAIN] * (len(dims1) - 1), device)
    color1 = init_linear(gen, w, 3, init="xavier_uniform", gain=1.0, zero_bias=True, device=device)
    dims2 = [w + 3 + 2 * 3 * cfg.view_freqs] + [w] * (cfg.tex_layers2 + 1) + [3]
    block2 = _init_stack(gen, dims2, [_LEAKY_GAIN] * (len(dims2) - 2) + [1.0], device)
    return {"block1": block1, "color1": color1, "block2": block2}


def _apply_block1(p: Params, cfg: NeuTexConfig, uv: torch.Tensor) -> torch.Tensor:
    x = torch.cat([uv, positional_encoding(uv, cfg.tex_freqs)], dim=-1)
    # Every block1 layer ends in its activation; the output stays in the
    # compute dtype for block2 and color1 (`ngf_tpu/fields/neutex.py:217-223`).
    for lp in _cast_tree(p, cfg.dtype)["layers"]:
        x = _leaky(apply_linear(lp, x))
    return x


def apply_texture_mlp(
    p: Params,
    cfg: NeuTexConfig,
    uv: torch.Tensor,
    view_dir: torch.Tensor,
    edit_texture: torch.Tensor | None = None,
    edit_mode: int = 0,
) -> torch.Tensor:
    """`TextureMlpDecoder.forward` (`ngf_tpu/fields/neutex.py:226-278`).

    ``view_dir`` broadcasts over the sample axis. With ``edit_texture`` (a
    (6, R, R, C) cubemap for the sphere, an (H, W, C) square otherwise) the
    learned colour modulates the edited texture per ``edit_mode`` 0-4.
    """
    h = _apply_block1(p["block1"], cfg, uv)
    c1 = _from_compute(apply_linear(_cast_tree(p["color1"], cfg.dtype), h), cfg.dtype)
    color1 = torch.sigmoid(c1) if cfg.clamp_texture else F.softplus(c1)

    # The view's PE on the unbroadcast directions, then expanded: the same
    # values as the JAX function's PE of the broadcast ones.
    vp = positional_encoding(view_dir, cfg.view_freqs)
    shape = h.shape[:-1]
    x = torch.cat([h, view_dir.to(h.dtype).expand(*shape, 3),
                   vp.to(h.dtype).expand(*shape, vp.shape[-1])], dim=-1)
    c2 = _apply_stack(p["block2"], x, _leaky, cfg.dtype)
    color2 = torch.sigmoid(c2) if cfg.clamp_texture else c2
    original = color1 + color2

    if edit_texture is None:
        # maximum, as jnp.maximum: half the gradient where original is 0
        return torch.maximum(original, original.new_zeros(()))

    if cfg.primitive_type == "sphere":
        tex_color = sample_cubemap(edit_texture, uv)
    else:
        tex_color = sample_square(edit_texture, uv)
    tex_rgb = tex_color[..., :3]

    if edit_mode == 0:
        mod = (original * 8.0).clamp(0.0, 1.0)
        return tex_rgb * mod.mean(dim=-1, keepdim=True)
    if edit_mode == 1:
        base = original.clamp(0.0, 1.0)
        return torch.where((tex_color[..., 0] < 0.99)[..., None], base * tex_rgb, base)
    if edit_mode == 2:
        base = original.clamp(0.0, 1.0)
        return torch.where((tex_color[..., 0] < 0.99)[..., None],
                           base / tex_rgb.clamp_min(1e-6), base)
    if edit_mode == 3:
        base = original.clamp(0.0, 1.0)
        mask = (tex_rgb.sum(dim=-1) > 0.01)[..., None]
        mixed = 2.0 * base.mean(dim=-1, keepdim=True) * tex_rgb
        return torch.where(mask, mixed, base) + tex_rgb
    if edit_mode == 4:
        return tex_rgb.clamp(0.0, 1.0)
    raise ValueError(f"unknown edit mode {edit_mode}")


# ------------------------------------------------------------ texture export


def _view(viewdir, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(viewdir, dtype=torch.float32, device=like.device).expand(*like.shape[:-1], 3)


@torch.no_grad()
def export_texture(params: Params, cfg: NeuTexConfig, resolution: int = 512, viewdir=(0, 0, 1)):
    """The learned texture (`ngf_tpu/fields/neutex.py:284-301`): the sphere's
    (6, R, R, 3) cube faces, the square's (R, R, 3)."""
    p = params["net_texture"]
    device = p["color1"]["w"].device
    grid = torch.as_tensor(generate_grid(2, resolution), dtype=torch.float32, device=device)
    if cfg.uv_dim == 3:
        faces = []
        for face in range(6):
            xyz = convert_cube_uv_to_xyz(face, grid)
            faces.append(apply_texture_mlp(p, cfg, xyz, _view(viewdir, xyz)))
        return torch.stack(faces, dim=0)
    return apply_texture_mlp(p, cfg, grid, _view(viewdir, grid))


@torch.no_grad()
def export_sphere_equirect(params: Params, cfg: NeuTexConfig, resolution: int = 512,
                           viewdir=(0, 0, 1)):
    """Equirectangular sphere texture (`ngf_tpu/fields/neutex.py:304-317`)."""
    if cfg.uv_dim != 3:
        raise ValueError("export_sphere_equirect needs the sphere primitive")
    gx, gy = np.meshgrid(np.arange(2 * resolution), np.arange(resolution), indexing="xy")
    grid = np.stack([gx, gy], axis=-1) / np.array([2 * resolution, resolution])
    grid = grid * np.array([2 * np.pi, np.pi]) + np.array([np.pi, 0.0])
    x, y = grid[..., 0], grid[..., 1]
    xyz = np.stack([-np.sin(x) * np.sin(y), -np.cos(y), -np.cos(x) * np.sin(y)], -1).astype(np.float32)
    p = params["net_texture"]
    xyz_t = torch.as_tensor(xyz, device=p["color1"]["w"].device)
    tex = apply_texture_mlp(p, cfg, xyz_t, _view(viewdir, xyz_t))
    return tex.flip(0)


@torch.no_grad()
def coordinate_deformation(params: Params, cfg: NeuTexConfig, viewdir=(0, 0, 1),
                           icosphere_division: int = 6, square_subdiv: int = 7):
    """Mesh export through the inverse gauge (`ngf_tpu/fields/neutex.py:320-361`):
    a template mesh (icosphere / subdivided square) deformed by the inverse
    network, vertices coloured by the texture MLP. Returns numpy
    (vertices (V, 3), faces (F, 3) int32, colours (V, 3) in [0, 1])."""
    if cfg.primitive_type == "sphere":
        verts, faces = icosphere_mesh(icosphere_division)
    else:
        side = 2 ** square_subdiv + 1
        verts = np.stack(np.meshgrid(*([np.linspace(-1, 1, side)] * 2), indexing="ij"),
                         axis=-1).reshape(-1, 2).astype(np.float32)
        idx = np.arange(side * side).reshape(side, side)
        faces = np.concatenate([
            np.stack([idx[:-1, :-1].ravel(), idx[1:, :-1].ravel(), idx[:-1, 1:].ravel()], -1),
            np.stack([idx[1:, :-1].ravel(), idx[1:, 1:].ravel(), idx[:-1, 1:].ravel()], -1),
        ]).astype(np.int32)
    device = params["net_texture"]["color1"]["w"].device
    grid = torch.as_tensor(verts, dtype=torch.float32, device=device)
    vertices = apply_inverse_network(params["inverse_network"], grid)
    colors = apply_texture_mlp(params["net_texture"], cfg, grid, _view(viewdir, grid))
    return vertices.cpu().numpy(), faces, colors.clamp(0.0, 1.0).cpu().numpy()


# ----------------------------------------------------------------- full model


def init_neutex(cfg: NeuTexConfig, gen: torch.Generator, device=None) -> Params:
    """The four networks (`ngf_tpu/fields/neutex.py:367-374`), float32, drawn
    from ``gen`` on its device unless ``device`` is given."""
    return {
        "net_geometry_decoder": init_geometry_mlp(gen, cfg, device),
        "inverse_network": init_inverse_network(gen, cfg, device),
        "gauge_network": init_gauge_network(gen, cfg, 3, cfg.uv_dim, device),
        "net_texture": init_texture_mlp(gen, cfg, device),
    }


def neutex_forward(
    params: Params,
    cfg: NeuTexConfig,
    campos: torch.Tensor,
    raydir: torch.Tensor,
    background_color: torch.Tensor | None = None,
    edit_texture: torch.Tensor | None = None,
    edit_mode: int = 0,
    u: torch.Tensor | None = None,
    template: torch.Tensor | None = None,
    inverse: bool = True,
) -> dict[str, Any]:
    """`NeuTex.forward` (`ngf_tpu/fields/neutex.py:377-436`).

    Args:
      campos: (B, 3); raydir: (B, R, 3) unit directions; background_color
        (B, 3) or None.
      u: (B, R, S) uniform draws of the segment jitter (of amount
        ``cfg.jitter``), or None for none (rendering).
      template: (P, uv_dim) template points for the origin loss's inverse
        network, or None to skip it (no ``points`` output).
      inverse: also map the samples' UV back to 3D (``points_inverse``, the
        inverse-mapping loss's input).

    Returns the reference's output dict: color (B, R, 3), transmittance
    (B, R), points (1, 3, P), points_original (B, R, S, 3),
    points_inverse (B, R, S, 3), points_inverse_weights (B, R, S), uv.
    """
    ray_pos, ray_dist, ray_valid, _ = cube_ray_generation(
        campos, raydir, cfg.sample_num, 1.0, cfg.jitter, u
    )
    ray_pos = ray_pos.detach()
    count("rays", raydir.shape[0] * raydir.shape[1])
    count("slots", ray_pos.shape[0] * ray_pos.shape[1] * ray_pos.shape[2])
    out = {"points_original": ray_pos}
    with annotate("ngf.field"):
        with annotate("ngf.uv.geometry"):
            density = apply_geometry_mlp(params["net_geometry_decoder"], cfg, ray_pos)["density"]
        with annotate("ngf.uv.gauge"):
            uv = apply_gauge_transform(params["gauge_network"], cfg, ray_pos)
        with annotate("ngf.uv.texture"):
            radiance = apply_texture_mlp(params["net_texture"], cfg, uv, raydir[:, :, None, :],
                                         edit_texture=edit_texture, edit_mode=edit_mode)
        if template is not None or inverse:
            with annotate("ngf.uv.inverse"):
                if template is not None:
                    count("template", template.shape[0])
                    points_3d = apply_inverse_network(params["inverse_network"], template, cfg.dtype)
                    out["points"] = points_3d.t()[None]  # (1, 3, P), the reference's permute
                if inverse:
                    out["points_inverse"] = apply_inverse_network(params["inverse_network"], uv,
                                                                  cfg.dtype)
    with annotate("ngf.render.composite"):
        color, weight, t_total = march_rays(density, ray_valid, ray_dist, radiance[..., :3],
                                            background_color)
    out.update(color=color, transmittance=t_total, points_inverse_weights=weight, uv=uv)
    return out


def neutex_losses(
    output: dict[str, Any],
    gt_image: torch.Tensor,
    transmittance_target: torch.Tensor | None,
    weights: dict[str, float],
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Loss assembly (`ngf_tpu/fields/neutex.py:439-478`, reference
    `Model.compute_loss`)."""
    losses: dict[str, torch.Tensor] = {}
    total = torch.zeros((), device=output["color"].device)
    if weights.get("color", 0) > 0:
        losses["color"] = ((output["color"] - gt_image) ** 2).mean()
        total = total + weights["color"] * losses["color"]
    if weights.get("bg", 0) > 0:
        if transmittance_target is not None:
            losses["bg"] = ((output["transmittance"] - transmittance_target) ** 2).mean()
        else:
            losses["bg"] = torch.zeros((), device=total.device)
        total = total + weights["bg"] * losses["bg"]
    if weights.get("origin", 0) > 0:
        pts = output["points"]  # (1, 3, P)
        losses["origin"] = ((pts ** 2).sum(dim=-2) - 1.0).clamp_min(0.0).sum()
        total = total + weights["origin"] * losses["origin"]
    if weights.get("inverse_mapping", 0) > 0:
        dist = ((output["points_original"] - output["points_inverse"]) ** 2).sum(dim=-1)
        losses["inverse_mapping"] = (dist * output["points_inverse_weights"]).sum(dim=-1).mean()
        total = total + weights["inverse_mapping"] * losses["inverse_mapping"]
    losses["total"] = total
    return total, losses
