"""Plain PyTorch reference of the tri-plane fields, their renderer, loss,
optimizer and occupancy events (InfoInv and the learned gauge).

It follows `InfoInv/models/Field.py`, `TriPlane/models/Field.py` and
`InfoInv/models/FieldBase.py` as the port documents them, with no kernel,
cache or batching: every fetch is four indexed taps of a plane, every
composite a ``cumprod``, every gradient autograd's. It is a frozen copy of
the plain versions that the port's CPU tests hold against the JAX package
(the grouped front end, the composite, the fetch), so that later changes to
the port cannot move it. It imports nothing of the port and nothing of JAX.

Float32 with TF32 off, as the configurations state. ``tf32=True`` rounds
every matrix product's inputs to TF32 (10 mantissa bits, round to nearest)
and sums in float32, as the card's TF32 products do: the control that the
comparison has to reject.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class FieldCfg:
    variant: str  # 'infoinv' | 'gauge'
    plane_dim: int
    density_dim: int
    infoinv: bool
    density_pe: int
    rgb_pe: int
    view_pe: int
    density_shift: float
    gauge_start: int
    tf32: bool = False

    @staticmethod
    def from_config(cfg: dict, tf32: bool = False) -> "FieldCfg":
        w, a = cfg["widths"], cfg["args"]
        return FieldCfg(
            variant="gauge" if a["subsystem"] == "triplane" else "infoinv",
            plane_dim=w["plane_dim"], density_dim=w["density_dim"],
            infoinv=bool(a.get("infoinv", False)), density_pe=w["density_pe"],
            rgb_pe=w["rgb_pe"], view_pe=w["view_pe"], density_shift=a["density_shift"],
            gauge_start=a.get("gauge_start", 0), tf32=tf32,
        )


# ------------------------------------------------------------------ trees

def flatten(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """Leaves of a nested dict/list tree by '/'-joined path."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


# ------------------------------------------------------------------- maths

def no_tf32() -> None:
    """Float32 products in float32: the card's TF32 off for every product
    the reference makes (the control rounds its inputs itself)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x with its mantissa rounded to TF32's 10 bits (nearest, ties away),
    the gradient passed straight through."""
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & -8192).view(torch.float32)
    return x + (r - x).detach()


def linear(p: dict, x: torch.Tensor, tf32: bool) -> torch.Tensor:
    w = p["w"]
    if tf32:
        x, w = round_tf32(x), round_tf32(w)
    y = x @ w
    return y + p["b"] if "b" in p else y


def mlp(p: dict, x: torch.Tensor, tf32: bool) -> torch.Tensor:
    layers = p["layers"]
    for lp in layers[:-1]:
        x = torch.relu(linear(lp, x, tf32))
    return linear(layers[-1], x, tf32)


def positional_encoding(x: torch.Tensor, freqs: int) -> torch.Tensor:
    """(..., D) -> (..., 2 D F): the sin block then the cos block, each
    coordinate-major and frequency-minor."""
    bands = 2.0 ** torch.arange(freqs, device=x.device, dtype=torch.float32)
    pts = (x[..., None] * bands).reshape(*x.shape[:-1], x.shape[-1] * freqs)
    return torch.cat([torch.sin(pts), torch.cos(pts)], dim=-1)


def _unnormalize(c: torch.Tensor, size: int) -> torch.Tensor:
    return (c + 1.0) * 0.5 * (size - 1)


def _axis_patch(c: torch.Tensor, size: int):
    """(start, w0, w1) of the clipped two-texel stencil of one axis:
    align_corners=True, zero padding."""
    c = c.clamp(-2.0, size + 1.0)
    c0f = torch.floor(c)
    frac = c - c0f
    c0 = c0f.long()
    start = c0.clamp(0, size - 2)
    zero = torch.zeros_like(frac)
    w0 = torch.where(start == c0, 1.0 - frac, zero) + torch.where(start == c0 + 1, frac, zero)
    w1 = torch.where(start + 1 == c0, 1.0 - frac, zero) + torch.where(start + 1 == c0 + 1, frac, zero)
    return start, w0, w1


def sample_plane(plane: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of an (H, W, C) plane at (..., 2) coordinates in
    [-1, 1] (x indexes W, y indexes H), as ``F.grid_sample`` with
    align_corners=True and zero padding. Differentiable in both."""
    H, W, C = plane.shape
    lead = coords.shape[:-1]
    coords = coords.reshape(-1, 2)
    xs, wx0, wx1 = _axis_patch(_unnormalize(coords[:, 0], W), W)
    ys, wy0, wy1 = _axis_patch(_unnormalize(coords[:, 1], H), H)
    flat = plane.reshape(H * W, C)
    idx = ys * W + xs
    out = (flat[idx] * (wy0 * wx0)[:, None] + flat[idx + 1] * (wy0 * wx1)[:, None]
           + flat[idx + W] * (wy1 * wx0)[:, None] + flat[idx + W + 1] * (wy1 * wx1)[:, None])
    return out.reshape(*lead, C)


def normalize_coord(xyz: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    inv_size = 2.0 / (aabb[1] - aabb[0])
    return (xyz - aabb[0]) * inv_size - 1.0


# ------------------------------------------------------------------- field

_PLANES = ("plane_xy", "plane_yz", "plane_xz")
_GAUGES = ("gauge_xy", "gauge_yz", "gauge_xz")


def project(xyz: torch.Tensor):
    return xyz[..., 0:2], xyz[..., 1:3], xyz[..., 0::2]


def gauge(params, cfg: FieldCfg, xy, yz, xz, iteration: int):
    """The learned gauge's deformed projections (`TriPlane/models/Field.py:53-75`);
    before ``gauge_start`` the offsets are multiplied by 0."""
    if cfg.variant != "gauge":
        return xy, yz, xz
    active = float(iteration >= cfg.gauge_start)
    dxy, dyz, dxz = (sample_plane(params[n], c) * active for n, c in zip(_GAUGES, (xy, yz, xz)))
    return (
        torch.stack([xy[..., 0] + dxy[..., 0] + dxz[..., 0], xy[..., 1] + dxy[..., 1] + dyz[..., 0]], -1),
        torch.stack([yz[..., 0] + dyz[..., 0] + dxy[..., 1], yz[..., 1] + dyz[..., 1] + dxz[..., 1]], -1),
        torch.stack([xz[..., 0] + dxz[..., 0] + dxy[..., 0], xz[..., 1] + dxz[..., 1] + dyz[..., 1]], -1),
    )


def _features(params, cfg: FieldCfg, xy, yz, xz, lo: int, hi: int, freqs: int):
    """Channels lo:hi of the three planes as the decoder input (..., 3 (hi - lo)),
    times PE(xyz) with InfoInv."""
    feats = torch.stack([sample_plane(params[n][..., lo:hi], c)
                         for n, c in zip(_PLANES, (xy, yz, xz))], dim=-2)
    if cfg.infoinv:
        xyz = torch.cat([xy, yz[..., 1:]], dim=-1)
        feats = feats * positional_encoding(xyz, freqs)[..., None, :]
    return feats.reshape(*feats.shape[:-2], -1)


def density(params, cfg: FieldCfg, xy, yz, xz) -> torch.Tensor:
    """softplus(decoder(features) + shift)."""
    feat = _features(params, cfg, xy, yz, xz, 0, cfg.density_dim, cfg.density_pe)
    dec = params["density_decoder"]
    raw = linear(dec, feat, cfg.tf32) if cfg.variant == "gauge" else mlp(dec["mlp"], feat, cfg.tf32)
    return F.softplus(raw[..., 0] + cfg.density_shift)


def appearance(params, cfg: FieldCfg, xy, yz, xz, viewdirs) -> torch.Tensor:
    """RGB (..., 3): basis, then the MLP of [features, view, PE(view)], sigmoid."""
    feat = _features(params, cfg, xy, yz, xz, cfg.density_dim, cfg.plane_dim, cfg.rgb_pe)
    dec = params["rgb_decoder"]
    feat = linear(dec["basis"], feat, cfg.tf32)
    x = torch.cat([feat, viewdirs, positional_encoding(viewdirs, cfg.view_pe)], dim=-1)
    return torch.sigmoid(mlp(dec["mlp"], x, cfg.tf32))


# --------------------------------------------------------- rays and groups

def _safe_dirs(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d == 0, torch.full_like(d, 1e-6), d)


def ray_aabb_range(o, d, aabb):
    vec = _safe_dirs(d)
    a, b = (aabb[1] - o) / vec, (aabb[0] - o) / vec
    return torch.minimum(a, b).amax(-1), torch.maximum(a, b).amin(-1)


def stratified_sample(o, d, aabb, near, far, n_samples, step_size, jitter=None):
    """Samples z = t_min + step (arange(S) + u) from the box entry clamped to
    [near, far]: (pts (N, S, 3), z (N, S), in-box (N, S))."""
    t_min = ray_aabb_range(o, d, aabb)[0].clamp(near, far)
    rng = torch.arange(n_samples, dtype=o.dtype, device=o.device)[None, :]
    if jitter is not None:
        rng = rng + jitter
    z = t_min[:, None] + step_size * rng
    pts = o[:, None, :] + d[:, None, :] * z[..., None]
    inb = ((pts >= aabb[0]) & (pts <= aabb[1])).all(-1)
    return pts, z, inb


def occupied(volume: torch.Tensor, points: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """``grid_sample_3d(volume, points) > 0`` of a non-negative z-major
    (D, H, W) volume: one of the eight trilinear taps inside, > 0 and of
    weight > 0."""
    D, H, W = volume.shape
    c = normalize_coord(points.float(), aabb)

    def axis(v, size):
        v = _unnormalize(v, size)
        v = torch.where(v >= -2.0, v, torch.full_like(v, -2.0)).clamp(max=size + 1.0)
        f = torch.floor(v)
        return f.long(), v - f

    x0, fx = axis(c[..., 0], W)
    y0, fy = axis(c[..., 1], H)
    z0, fz = axis(c[..., 2], D)
    flat = volume.reshape(-1) > 0
    hit = torch.zeros(c.shape[:-1], dtype=torch.bool, device=c.device)
    for dz in (0, 1):
        wz, zi = (fz if dz else 1.0 - fz), z0 + dz
        for dy in (0, 1):
            wy, yi = (fy if dy else 1.0 - fy), y0 + dy
            for dx in (0, 1):
                wx, xi = (fx if dx else 1.0 - fx), x0 + dx
                inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H) & (zi >= 0) & (zi < D)
                idx = (zi.clamp(0, D - 1) * H + yi.clamp(0, H - 1)) * W + xi.clamp(0, W - 1)
                hit |= inb & (wx * wy * wz > 0) & flat[idx]
    return hit


def front_end(rays, jitter, aabb, near, far, n_samples, step_size, group, capg, volume, volume_aabb):
    """The grouped front end: samples, the last one invalid, padded to whole
    groups; the occupancy at a group's quarter and three-quarter samples
    (even groups of 4 or more) or its centre; each ray's first ``capg``
    groups that hold a valid sample. Returns (z (N, capg G), valid
    (N, capg G) float, points (N, capg G, 3) in [-1, 1] of the box)."""
    o, d = rays[:, 0:3], rays[:, 3:6]
    n, S, G = rays.shape[0], n_samples, group
    s_pad = -(-S // G) * G
    _, z, valid = stratified_sample(o, d, aabb, near, far, S, step_size, jitter)
    valid[:, S - 1] = False
    if s_pad > S:
        z = torch.cat([z, z[:, -1:].expand(n, s_pad - S)], 1)
        valid = torch.cat([valid, valid.new_zeros((n, s_pad - S))], 1)
    if volume is not None:
        zq, per = (z[:, G // 4::G // 2], G // 2) if G >= 4 and G % 2 == 0 else (z[:, G // 2::G], G)
        q = o[:, None, :] + d[:, None, :] * zq[..., None]
        valid = (valid.view(n, -1, per) & occupied(volume, q, volume_aabb)[..., None]).view(n, s_pad)
    ng = s_pad // G
    gvalid = valid.view(n, ng, G).any(-1)
    dest = torch.cumsum(gvalid.to(torch.int32), -1) - 1
    slots = torch.arange(capg, dtype=torch.int32, device=rays.device)
    oh = (dest[:, None, :] == slots[None, :, None]) & gvalid[:, None, :]
    idx = (oh * torch.arange(ng, dtype=torch.int32, device=rays.device)).sum(-1, dtype=torch.int32)
    got = oh.any(-1)
    payload = torch.stack([z, valid.to(z.dtype)], -1).reshape(n, ng, G * 2)
    sel = torch.gather(payload, 1, idx.long()[..., None].expand(-1, -1, G * 2)).reshape(n, capg * G, 2)
    z_c = sel[..., 0]
    vmask = sel[..., 1] * got.to(z.dtype).repeat_interleave(G, 1)
    pts = o[:, None, :] + d[:, None, :] * z_c[..., None]
    return z_c, vmask, normalize_coord(pts, aabb)


def blend_weights(sigma, dist):
    """w = alpha T, T the exclusive product of (1 - alpha + 1e-10)."""
    alpha = 1.0 - torch.exp(-sigma * dist)
    t = torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], -1), -1)
    return alpha * t[..., :-1]


def composite(sigma, dist, rgb, z, ray_last, background, thres):
    """Weights, shading mask w > thres, colour with background, clip with
    half the gradient at a bound, acc, depth."""
    w = blend_weights(sigma, dist)
    acc = w.sum(-1)
    mask = (w > thres).to(w.dtype)
    y = ((w * mask)[..., None] * rgb).sum(-2) + background * (1.0 - acc[..., None])
    rgb_map = torch.minimum(torch.maximum(y, y.new_zeros(())), y.new_ones(()))
    depth = ((w * z).sum(-1) + (1.0 - acc) * ray_last).detach()
    return rgb_map, depth, w, mask


@dataclasses.dataclass(frozen=True)
class RenderCfg:
    aabb: tuple
    near: float
    far: float
    n_samples: int
    step_size: float
    group: int
    capg: int
    distance_scale: float
    thres: float


def render(params, cfg: FieldCfg, rc: RenderCfg, rays, iteration, volume=None, volume_aabb=None,
           jitter=None):
    """(rgb_map (N, 3), depth (N,)) of a chunk of rays, white background."""
    aabb = torch.tensor(rc.aabb, dtype=torch.float32, device=rays.device)
    z, vmask, xyz = front_end(rays, jitter, aabb, rc.near, rc.far, rc.n_samples, rc.step_size,
                              rc.group, rc.capg, volume, volume_aabb)
    xy, yz, xz = gauge(params, cfg, *project(xyz), iteration)
    sigma = density(params, cfg, xy, yz, xz) * vmask
    views = rays[:, None, 3:6].expand(-1, z.shape[1], 3)
    rgb = appearance(params, cfg, xy, yz, xz, views)
    dist = float(np.float32(rc.step_size * rc.distance_scale))
    rgb_map, depth, _, _ = composite(sigma, dist, rgb, z, rays[:, -1], 1.0, rc.thres)
    return rgb_map, depth


@torch.no_grad()
def count_samples(params, cfg: FieldCfg, rc: RenderCfg, rays, iteration, volume=None,
                  volume_aabb=None, jitter=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(samples in the box and the mask, samples shaded) of a chunk, as
    :func:`render` counts them, from the density at the valid samples alone
    (no appearance); device scalars."""
    aabb = torch.tensor(rc.aabb, dtype=torch.float32, device=rays.device)
    z, vmask, xyz = front_end(rays, jitter, aabb, rc.near, rc.far, rc.n_samples, rc.step_size,
                              rc.group, rc.capg, volume, volume_aabb)
    sel = vmask > 0
    sigma = torch.zeros_like(z)
    if sel.any():
        sigma[sel] = density(params, cfg, *gauge(params, cfg, *project(xyz[sel]), iteration))
    w = blend_weights(sigma, float(np.float32(rc.step_size * rc.distance_scale)))
    return sel.sum(), (w > rc.thres).sum()


def density_l1(params) -> torch.Tensor:
    return sum(params[n].abs().mean() for n in _PLANES)


# --------------------------------------------------------------- optimizer

class Adam:
    """Adam (0.9, 0.99, eps 1e-8) with a base rate per leaf: planes
    ``lr_init``, gauge grids ``lr_basis / 10``, the rest ``lr_basis``, all
    times ``ratio ** (count / decay_iters)`` before each update."""

    def __init__(self, leaves: dict, lr_init, lr_basis, ratio, decay_iters, state=None):
        self.leaves = leaves
        self.base = {k: lr_init if k.startswith("plane_") else
                     lr_basis * 0.1 if k.startswith("gauge_") else lr_basis for k in leaves}
        self.ratio, self.decay_iters = ratio, decay_iters
        if state is None:
            state = {"count": 0, "m": {}, "v": {}, "t": {}}
            for k, p in leaves.items():
                state["m"][k] = torch.zeros_like(p)
                state["v"][k] = torch.zeros_like(p)
                state["t"][k] = 0
        self.state = state

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        s = self.state
        scale = self.ratio ** (s["count"] / self.decay_iters)
        for k, p in self.leaves.items():
            g = grads[k]
            s["t"][k] += 1
            t = s["t"][k]
            m, v = s["m"][k], s["v"][k]
            m.lerp_(g, 0.1)
            v.mul_(0.99).addcmul_(g, g, value=0.01)
            denom = (v.sqrt() / math.sqrt(1 - 0.99 ** t)).add_(1e-8)
            p.addcdiv_(m, denom, value=-(self.base[k] * scale) / (1 - 0.9 ** t))
        s["count"] += 1


# ------------------------------------------------------------ occupancy

def grid_points(aabb: np.ndarray, res: int, device) -> torch.Tensor:
    lin = torch.from_numpy(np.linspace(0.0, 1.0, res, dtype=np.float32)).to(device)
    s = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), -1)
    a = torch.as_tensor(np.asarray(aabb, np.float32), device=device)
    return a[0] * (1.0 - s) + a[1] * s


@torch.no_grad()
def alpha_mask(params, cfg: FieldCfg, aabb, step_len: float, res: int, thres: float,
               prev=None, chunk: int = 256 * 256 * 8):
    """The occupancy event's grid (`FieldBase.py:161-191`): alpha
    1 - exp(-sigma step) on a res^3 lattice over the box (the gauge at
    iteration -1; a previous grid culls), z-major, clipped, 3x3x3 max pool,
    >= thres. Returns (volume (D, H, W) float32, its box, the tight box of
    the surviving voxels)."""
    aabb = np.asarray(aabb, np.float32)
    device = params["plane_xy"].device
    a_t = torch.as_tensor(aabb, device=device)
    pts = grid_points(aabb, res, device).reshape(-1, 3)
    out = []
    for i in range(0, pts.shape[0], chunk):
        p = pts[i:i + chunk]
        xy, yz, xz = gauge(params, cfg, *project(normalize_coord(p, a_t)), -1)
        sigma = density(params, cfg, xy, yz, xz)
        if prev is not None:
            sigma = sigma * occupied(prev[0], p, prev[1]).to(sigma.dtype)
        out.append(1.0 - torch.exp(-sigma * float(np.float32(step_len))))
    alpha = torch.cat(out).reshape(res, res, res).permute(2, 1, 0).clamp(0.0, 1.0)
    binary = (F.max_pool3d(alpha[None, None], 3, stride=1, padding=1)[0, 0] >= thres).float()
    occ = binary.cpu().numpy() > 0.5
    if occ.any():
        zi, yi, xi = np.nonzero(occ)
        lin = np.linspace(0.0, 1.0, res, dtype=np.float32)
        lo = [aabb[0][k] + lin[ix].min() * (aabb[1][k] - aabb[0][k]) for k, ix in enumerate((xi, yi, zi))]
        hi = [aabb[0][k] + lin[ix].max() * (aabb[1][k] - aabb[0][k]) for k, ix in enumerate((xi, yi, zi))]
        box = np.stack([np.array(lo, np.float32), np.array(hi, np.float32)])
    else:
        box = aabb.copy()
    return binary, a_t, box


@torch.no_grad()
def occupied_counts(rays, volume, volume_aabb, aabb, near, far, step, n_samples, chunk=16384):
    """Occupied in-box samples per ray at the marching geometry."""
    a_t = torch.as_tensor(np.asarray(aabb, np.float32), device=rays.device)
    out = []
    for i in range(0, rays.shape[0], chunk):
        r = rays[i:i + chunk]
        pts, _, inb = stratified_sample(r[:, :3], r[:, 3:6], a_t, near, far, n_samples, step)
        out.append((occupied(volume, pts, volume_aabb) & inb).sum(-1))
    return torch.cat(out).cpu().numpy()


@torch.no_grad()
def touches(rays, volume, volume_aabb, aabb, near, far, step, n_samples=256, chunk=16384):
    """Whether each ray has an occupied sample among ``n_samples`` (the first
    event's ray filter)."""
    a_t = torch.as_tensor(np.asarray(aabb, np.float32), device=rays.device)
    out = []
    for i in range(0, rays.shape[0], chunk):
        r = rays[i:i + chunk]
        pts = stratified_sample(r[:, :3], r[:, 3:6], a_t, near, far, n_samples, step)[0]
        out.append(occupied(volume, pts, volume_aabb).any(-1))
    return torch.cat(out)


def auto_cap(counts: np.ndarray, n_samples: int) -> int:
    """The p99.9 occupied samples with 10% headroom, up to a multiple of 32,
    within [32, n_samples]."""
    if counts.size == 0:
        return n_samples
    q = float(np.quantile(counts, 0.999))
    return int(np.clip(int(np.ceil(q * 1.1 / 32.0) * 32), 32, n_samples))


def n_to_reso(n_voxels: int, bbox) -> list[int]:
    bbox = np.asarray(bbox, np.float64)
    size = bbox[1] - bbox[0]
    return [int(v) for v in size / (size.prod() / n_voxels) ** (1.0 / 3.0)]


def cal_n_samples(reso, step_ratio: float) -> int:
    return int(np.linalg.norm(reso) / step_ratio)


def step_size(aabb, grid, step_ratio: float) -> float:
    aabb = np.asarray(aabb, np.float64)
    return float(((aabb[1] - aabb[0]) / (np.asarray(grid, np.float64) - 1)).mean() * step_ratio)


def grid_n_samples(aabb, step: float) -> int:
    aabb = np.asarray(aabb, np.float64)
    return int(float(np.sqrt(np.sum((aabb[1] - aabb[0]) ** 2))) / step) + 1


def shrink_voxels(aabb, new_aabb, grid):
    """The gauge's crop box [t_l, b_r) in voxels (`TriPlane/models/Field.py:117-124`)."""
    aabb, new_aabb = np.asarray(aabb, np.float64), np.asarray(new_aabb, np.float64)
    grid = np.asarray(grid, np.int64)
    units = (aabb[1] - aabb[0]) / (grid - 1)
    t_l = np.round(np.round((new_aabb[0] - aabb[0]) / units)).astype(np.int64)
    b_r = np.minimum(np.round((new_aabb[1] - aabb[0]) / units).astype(np.int64) + 1, grid)
    return t_l, b_r


def crop_planes(params: dict, t_l, b_r) -> dict:
    """The gauge's shrink (`TriPlane/models/Field.py:125-132`): each (H, W, C)
    plane cut to the voxel box [t_l, b_r) of its two axes (W the first, H the
    second); the other leaves as they are."""
    x0, y0, z0 = (int(v) for v in t_l)
    x1, y1, z1 = (int(v) for v in b_r)
    out = dict(params)
    out["plane_xy"] = params["plane_xy"][y0:y1, x0:x1]
    out["plane_yz"] = params["plane_yz"][z0:z1, y0:y1]
    out["plane_xz"] = params["plane_xz"][z0:z1, x0:x1]
    return out


def resize_planes(params: dict, res) -> dict:
    """The gauge's upsample (`TriPlane/models/Field.py:108-114`): each plane
    resized bilinearly, align_corners=True, to the grid's sizes (rx, ry, rz)
    of its two axes; the other leaves as they are."""
    rx, ry, rz = (int(v) for v in res)
    out = dict(params)
    for name, hw in (("plane_xy", (ry, rx)), ("plane_yz", (rz, ry)), ("plane_xz", (rz, rx))):
        img = params[name].permute(2, 0, 1)[None]
        out[name] = F.interpolate(img, size=hw, mode="bilinear", align_corners=True)[0].permute(1, 2, 0)
    return out


def voxel_schedule(n_init: int, n_final: int, n_events: int) -> list[int]:
    if not n_events:
        return []
    return [int(round(v)) for v in np.exp(np.linspace(np.log(n_init), np.log(n_final), n_events))]
