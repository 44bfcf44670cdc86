"""Plain PyTorch reference of the NeuTex UV-mapping model (`UV-Mapping/`):
its ray generation, four networks, ray march, losses and optimizer.

It follows the published description (`UV-Mapping/model/model.py:11-59`
``NeuTex.forward``, `model/gauge_fields.py`, `model/decoder.py`,
`model/renderer.py:79-141,176-247`, ``Model.compute_loss`` at
`model.py:317-350`), with no kernel, cache or batching: every layer is a
float32 product, the march a ``cumprod``, every gradient autograd's. It
imports nothing of the port and nothing of JAX; from the tri-plane
reference it takes the positional encoding, the linear layer, the TF32
rounding and the TF32 switch.

Parameters are a flat dict by '/'-joined name (``net_geometry_decoder/
layers/0/w``, ...), weights (in, out), the names of the port's checkpoints.

Float32 with TF32 off, as the configuration states. ``tf32=True`` rounds
every product's inputs to TF32 and sums in float32: the control that the
comparison has to reject.

Departures from the reference code, each as the port has it:
- One view a step, and the ray axis as the batch: ``campos`` (3,), rays
  (R, ...); the reference's ``(B, R, ...)`` with B = 1.
- The jitter ``u`` and the template points are given, not drawn inside
  (:func:`template_points` draws them as the reference's templates do).
- The inverse network maps the samples' uv back to 3D only when the
  inverse-mapping loss weighs more than 0; the reference runs it in every
  forward, where its output is unused at weight 0. `gauge_fields.py:205`'s
  ``uv.view(input_shape, -1, dim)``, which raises as written, is read as
  ``uv.view(-1, dim)``.
- The blend weights of the inverse-mapping term carry their gradient to the
  density, as the JAX package's loss does.
- The tone map's clip is ``min(max(y, 0), 1)``; the colour's rectifier
  ``max(c, 0)``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from gpubench.reference.model import linear, no_tf32, positional_encoding

LEAKY = 0.2
GAUGE_FREQS = 10
INV_GAMMA = 1.0 / 2.2
NETWORKS = ("net_geometry_decoder", "gauge_network", "net_texture", "inverse_network")


@dataclasses.dataclass(frozen=True)
class UVCfg:
    primitive: str  # 'square' | 'sphere'
    sample_num: int
    jitter: float
    geo_freqs: int
    tex_freqs: int
    view_freqs: int
    w_color: float
    w_bg: float
    w_origin: float
    w_inverse: float
    lr: float
    niter: int
    niter_decay: int
    tf32: bool = False

    @staticmethod
    def from_config(cfg: dict, tf32: bool = False) -> "UVCfg":
        a, w = cfg["args"], cfg["widths"]
        return UVCfg(primitive=a["primitive_type"], sample_num=a["sample_num"], jitter=a["jitter"],
                     geo_freqs=w["geo_freqs"], tex_freqs=w["tex_freqs"], view_freqs=w["view_freqs"],
                     w_color=a["loss_color_weight"], w_bg=a["loss_bg_weight"],
                     w_origin=a["loss_origin_weight"], w_inverse=a["loss_inverse_mapping_weight"],
                     lr=a["lr"], niter=a["niter"], niter_decay=a["niter_decay"], tf32=tf32)

    @property
    def uv_dim(self) -> int:
        return 2 if self.primitive == "square" else 3


# ------------------------------------------------------------------ layers

def _layers(p: dict, prefix: str) -> list[dict]:
    """The layers ``prefix/layers/<i>`` in order, each {'w', 'b'}."""
    out, i = [], 0
    while f"{prefix}/layers/{i}/w" in p:
        out.append({"w": p[f"{prefix}/layers/{i}/w"], "b": p[f"{prefix}/layers/{i}/b"]})
        i += 1
    return out


def _stack(layers: list[dict], x: torch.Tensor, act, tf32: bool, last_act: bool = False):
    for i, lp in enumerate(layers):
        x = linear(lp, x, tf32)
        if i < len(layers) - 1 or last_act:
            x = act(x)
    return x


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LEAKY)


def _with_pe(x: torch.Tensor, freqs: int) -> torch.Tensor:
    return torch.cat([x, positional_encoding(x, freqs)], dim=-1)


# --------------------------------------------------------------- networks

def geometry(p: dict, cfg: UVCfg, pts: torch.Tensor) -> torch.Tensor:
    """`GeometryMlpDecoder`: ReLU MLP on [x, PE(x)] -> softplus density."""
    raw = _stack(_layers(p, "net_geometry_decoder"), _with_pe(pts, cfg.geo_freqs), torch.relu,
                 cfg.tf32)
    return F.softplus(raw[..., 0])


def gauge(p: dict, cfg: UVCfg, pts: torch.Tensor) -> torch.Tensor:
    """`GaugeTransform`: ReLU MLP on [x, PE(x, 10)], then tanh onto the
    square or L2-normalised onto the sphere."""
    g = _stack(_layers(p, "gauge_network"), _with_pe(pts, GAUGE_FREQS), torch.relu, cfg.tf32)
    if cfg.uv_dim == 2:
        return torch.tanh(g)
    return g / torch.linalg.vector_norm(g, dim=-1, keepdim=True).clamp_min(1e-12)


def texture(p: dict, cfg: UVCfg, uv: torch.Tensor, view: torch.Tensor) -> torch.Tensor:
    """`TextureMlpDecoder`: block 1 on [uv, PE(uv)] (leaky ReLU after every
    layer), the view-independent softplus colour, block 2 on [h, view,
    PE(view)]; their sum rectified. ``view`` (..., 3) broadcasts over the
    samples."""
    h = _stack(_layers(p, "net_texture/block1"), _with_pe(uv, cfg.tex_freqs), _leaky, cfg.tf32,
               last_act=True)
    c1 = F.softplus(linear({"w": p["net_texture/color1/w"], "b": p["net_texture/color1/b"]}, h,
                           cfg.tf32))
    v = _with_pe(view, cfg.view_freqs).expand(*h.shape[:-1], 3 + 6 * cfg.view_freqs)
    c2 = _stack(_layers(p, "net_texture/block2"), torch.cat([h, v], dim=-1), _leaky, cfg.tf32)
    c = c1 + c2
    return torch.maximum(c, c.new_zeros(()))


def inverse(p: dict, cfg: UVCfg, uv: torch.Tensor) -> torch.Tensor:
    """`InverseNetwork` (AtlasNet-style): ReLU MLP uv -> 3D, no encoding."""
    return _stack(_layers(p, "inverse_network"), uv, torch.relu, cfg.tf32)


def template_points(gen: torch.Generator, n: int, primitive: str) -> torch.Tensor:
    """The templates' random samples: uniform on [-1, 1]^2 for the square;
    normal draws times 2 minus 1, normalised, for the sphere."""
    if primitive == "square":
        return torch.rand((n, 2), generator=gen, device=gen.device) * 2.0 - 1.0
    pts = torch.randn((n, 3), generator=gen, device=gen.device) * 2.0 - 1.0
    return pts / torch.linalg.vector_norm(pts, dim=-1, keepdim=True).clamp_min(1e-12)


# ------------------------------------------------------------------ render

def cube_rays(campos: torch.Tensor, raydir: torch.Tensor, n: int, jitter: float,
              u: torch.Tensor | None):
    """`cube_ray_generation`: the rays' entry into [-1, 1]^3 (0 from
    inside or on a miss), ``n`` segments of 2 / n jittered by ``jitter``
    times (u - 0.5) of a segment, the segments' midpoints. Returns
    (points (R, n, 3), segment lengths (R, n), inside (R, n))."""
    t1 = (-1.0 - campos) / raydir
    t2 = (1.0 - campos) / raydir
    t_in = torch.minimum(t1, t2).amax(dim=-1)
    t_out = torch.maximum(t1, t2).amin(dim=-1)
    t0 = torch.where(t_in < t_out, t_in, torch.zeros_like(t_in)).clamp_min(0.0)
    dt = 2.0 / n
    if u is None or jitter == 0.0:
        seg = torch.full((raydir.shape[0], n), dt, device=raydir.device)
    else:
        seg = dt + dt * jitter * (u - 0.5)
    ends = torch.cat([torch.zeros_like(seg[:, :1]), torch.cumsum(seg, dim=1)], dim=1) + t0[:, None]
    mid = 0.5 * (ends[:, :-1] + ends[:, 1:])
    pts = campos + raydir[:, None, :] * mid[..., None]
    inside = ((pts > -1.0) & (pts < 1.0)).all(dim=-1)
    return pts, seg, inside


def march(density, seg, inside, rgb, background):
    """`ray_march` with the background and `simple_tone_map`: alpha = 1 -
    exp(-sigma dist), transmittance the exclusive product of (1 - alpha +
    1e-10), weights alpha T, the colour plus the background times the
    transmittance past the last sample, then clip((c + 1e-5)^(1 / 2.2), 0,
    1). Returns (colour (R, 3), weights (R, n), T past the last (R,))."""
    alpha = 1.0 - torch.exp(-(density * inside.float()) * seg)
    f = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], dim=1), dim=1)
    w = alpha * f[:, :-1]
    t_last = f[:, -1]
    c = (w[..., None] * rgb).sum(dim=1) + background * t_last[:, None]
    y = (c + 1e-5) ** INV_GAMMA
    return torch.minimum(torch.maximum(y, y.new_zeros(())), y.new_ones(())), w, t_last


def forward(p: dict, cfg: UVCfg, campos, raydir, background, u, template, fault: str | None = None):
    """``NeuTex.forward`` on one view's rays: colour, transmittance, weights,
    uv, the samples, the template through the inverse network and (with an
    inverse-mapping weight) the samples' uv back in 3D. ``fault`` 'detach'
    gives the texture the uv cut from the gauge network."""
    pts, seg, inside = cube_rays(campos, raydir, cfg.sample_num, cfg.jitter, u)
    pts = pts.detach()
    density = geometry(p, cfg, pts)
    uv = gauge(p, cfg, pts)
    rgb = texture(p, cfg, uv.detach() if fault == "detach" else uv, raydir[:, None, :])
    color, w, t_last = march(density, seg, inside, rgb, background)
    out = {"color": color, "transmittance": t_last, "weights": w, "uv": uv, "points_original": pts,
           "points": inverse(p, cfg, template)}
    if cfg.w_inverse > 0:
        out["points_inverse"] = inverse(p, cfg, uv)
    return out


def losses(out: dict, cfg: UVCfg, gt, trans, fault: str | None = None):
    """``Model.compute_loss``: the colour's and the transmittance's mean
    squares, the template's squared norms past 1 summed (origin), the
    weighted squared distance of the samples from their inverse image,
    summed over a ray's samples and averaged over rays. Returns (total,
    {name: term}). ``fault`` 'no_inverse' drops the last term."""
    terms, total = {}, 0.0
    if cfg.w_color > 0:
        terms["color"] = ((out["color"] - gt) ** 2).mean()
        total = total + cfg.w_color * terms["color"]
    if cfg.w_bg > 0:
        terms["bg"] = ((out["transmittance"] - trans) ** 2).mean() if trans is not None \
            else out["color"].new_zeros(())
        total = total + cfg.w_bg * terms["bg"]
    if cfg.w_origin > 0:
        terms["origin"] = ((out["points"] ** 2).sum(dim=-1) - 1.0).clamp_min(0.0).sum()
        total = total + cfg.w_origin * terms["origin"]
    if cfg.w_inverse > 0 and fault != "no_inverse":
        d = ((out["points_original"] - out["points_inverse"]) ** 2).sum(dim=-1)
        terms["inverse_mapping"] = (d * out["weights"]).sum(dim=-1).mean()
        total = total + cfg.w_inverse * terms["inverse_mapping"]
    return total, terms


# --------------------------------------------------------------- optimizer

def lambda_rate(count: int, niter: int, niter_decay: int) -> float:
    """The 'lambda' policy: 1 through ``niter``, then linear to 0 over
    ``niter_decay``."""
    return 1.0 - max(0, count - niter) / float(niter_decay + 1)


class Adam:
    """Adam (0.9, 0.999, eps 1e-8) in one group, at ``lr`` times the
    'lambda' rate of the update count before each update. ``state``: the
    first and second moments and step count by leaf, and the update
    count (None: a new optimizer)."""

    def __init__(self, leaves: dict, cfg: UVCfg, state: dict | None = None):
        self.leaves, self.cfg = leaves, cfg
        if state is None:
            state = {"count": 0, "t": {k: 0 for k in leaves},
                     "m": {k: torch.zeros_like(v) for k, v in leaves.items()},
                     "v": {k: torch.zeros_like(v) for k, v in leaves.items()}}
        self.state = state

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        s, cfg = self.state, self.cfg
        lr = cfg.lr * lambda_rate(s["count"], cfg.niter, cfg.niter_decay)
        for k, p in self.leaves.items():
            g = grads[k]
            s["t"][k] += 1
            t = s["t"][k]
            m, v = s["m"][k], s["v"][k]
            m.lerp_(g, 0.1)
            v.mul_(0.999).addcmul_(g, g, value=0.001)
            denom = (v.sqrt() / math.sqrt(1 - 0.999 ** t)).add_(1e-8)
            p.addcdiv_(m, denom, value=-lr / (1 - 0.9 ** t))
        s["count"] += 1


def steps(states: list, batches: list, cfg: UVCfg, fault: str | None = None) -> dict:
    """One reference step from each state in ``states`` on the batch beside
    it: a state is (parameters, Adam state or None for a new optimizer),
    flat by leaf; a batch {campos (3,), raydir (R, 3), gt (R, 3),
    background (3,), trans (R,) or None, u (R, n), template (P, d)}.
    ``fault`` 'half' keeps the first half of each batch's rays; 'detach'
    and 'no_inverse' as :func:`forward` and :func:`losses`. Returns each
    step's total loss (``mse``), gradient (``g``) and change of the
    parameters (``change``), flat by leaf."""
    no_tf32()
    out = {"mse": [], "g": [], "change": []}
    for (params, adam_state), b in zip(states, batches):
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        if adam_state is not None:
            adam_state = {"count": adam_state["count"], "t": dict(adam_state["t"]),
                          "m": {k: v.clone() for k, v in adam_state["m"].items()},
                          "v": {k: v.clone() for k, v in adam_state["v"].items()}}
        raydir, gt, trans, u = b["raydir"], b["gt"], b["trans"], b["u"]
        if fault == "half":
            h = raydir.shape[0] // 2
            raydir, gt, u = raydir[:h], gt[:h], u[:h]
            trans = None if trans is None else trans[:h]
        fwd = forward(leaves, cfg, b["campos"], raydir, b["background"], u, b["template"], fault)
        total, _ = losses(fwd, cfg, gt, trans, fault)
        grads = torch.autograd.grad(total, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(leaves.items(), grads)}
        Adam(leaves, cfg, adam_state).step(grads)
        out["mse"].append(float(total.detach()))
        out["g"].append(grads)
        out["change"].append({k: leaves[k].detach() - params[k] for k in leaves})
    return out
