"""Alpha compositing along rays: port of `ngf_tpu/ops/compositing.py`
(references `InfoInv/models/FieldBase.py:12-19`,
`UV-Mapping/model/renderer.py:7-8,176-268`).

- ``exclusive_transmittance`` / ``raw2alpha``: the tri-plane renderers'
  weights, building blocks of :func:`composite_plain`.
- :func:`composite`: what the tri-plane renderers run, their whole
  composite (weights, shading mask, colour with its background and clip,
  acc, depth) as one ``autograd.Function``: K5's tri-plane mode forward and
  backward on a CUDA tensor, on a CPU tensor :func:`composite_plain` and
  :func:`composite_backward_plain`, the same reverse scan as the kernel's.
- :func:`composite_weights` and :func:`composite_topk`: what the renderers
  run with top-K shading, K5's top-K mode: the weights, acc and depth with
  no colour (the tri-plane forward without rgb) before the K shaded samples
  are picked and decoded, then their colour pass; backward the colour
  pass's backward hands the weights' cotangent to the tri-plane backward.
  On a CPU tensor :func:`composite_plain`'s weights,
  :func:`composite_topk_plain`, :func:`composite_topk_backward_plain` and
  :func:`composite_backward_plain`.
- :func:`composite_shard`: what the sample-parallel renderer runs, one
  shard's share of the composite from a starting transmittance that an
  exchange between the shards provides: K5's shard mode (a totals launch
  and a composite launch forward, one launch backward) on a CUDA tensor, on
  a CPU tensor its plain versions :func:`composite_shard_totals_plain`,
  :func:`composite_shard_plain` and :func:`composite_shard_backward_plain`.
- :func:`ray_march_plain`: NeuTex's march, background and tone map in plain
  PyTorch with autograd through ``cumprod``: the plain version of K5.
- :func:`march_rays`: what the UV path runs, the march with its background
  and tone map as one ``autograd.Function``: the CUDA kernel K5
  (``kernels/ray_march.cu``) forward and backward on a CUDA tensor, on a CPU
  tensor the plain forward and :func:`ray_march_backward_plain`, the same
  reverse scan as the kernel's backward.
"""

from __future__ import annotations

import torch

from . import cuda_kernels

# 1/2.2 as the JAX tone map's Python-float exponent is taken in float32.
INV_GAMMA = 1.0 / 2.2


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


def _per_ray_background(background: torch.Tensor, n: int) -> torch.Tensor:
    return background.repeat_interleave(n // background.shape[0], dim=0)


def ray_march_plain(density, valid, dist, rgb=None, background=None):
    """K5's forward in plain PyTorch on (N, S) rays, as the kernel takes
    them, differentiable through autograd: NeuTex's ``ray_march`` (or,
    without ``rgb``, ``alpha_ray_march``), the background weighted by the
    transmittance past the last sample, and ``simple_tone_map``
    (`ngf_tpu/ops/compositing.py:49-95`). Returns (tone-mapped colour (N, 3)
    or None, w (N, S), T_total (N,))."""
    alpha = 1.0 - torch.exp(-(density * valid.to(density.dtype)) * dist)
    t, t_total = exclusive_transmittance(alpha)
    w, t_total = alpha * t, t_total[..., 0]
    if rgb is None:
        return None, w, t_total
    c = (rgb * w[..., None]).sum(dim=-2)
    if background is not None:
        c = c + _per_ray_background(background, c.shape[0]) * t_total[:, None]
    # clip((c + 1e-5)^(1/2.2), 0, 1), as maximum then minimum like jnp.clip:
    # half the gradient at a bound, as JAX's
    y = (c + 1e-5) ** INV_GAMMA
    return torch.minimum(torch.maximum(y, y.new_zeros(())), y.new_ones(())), w, t_total


def _clip_grad(y: torch.Tensor) -> torch.Tensor:
    lo = torch.where(y > 0, 1.0, torch.where(y == 0, 0.5, 0.0))
    m = torch.clamp_min(y, 0.0)
    hi = torch.where(m < 1, 1.0, torch.where(m == 1, 0.5, 0.0))
    return lo * hi


def ray_march_backward_plain(density, valid, dist, rgb, background, g_color, g_weight, g_t):
    """K5's backward in plain PyTorch, the kernel's reverse scan: with c_k
    the cotangent of w_k times alpha_k and f_k = 1 - alpha_k + 1e-10, R
    runs R_{S-1} = g_T, R_{k-1} = c_k + f_k R_k, and dL/dalpha_k =
    T_k (g_w_k - R_k), with no division by f_k (which is 1e-10 where alpha
    rounds to 1). Returns (d density (N, S), d rgb (N, S, 3) or None)."""
    N, S = density.shape
    v = valid.to(density.dtype)
    e = torch.exp(-(density * v * dist))
    alpha = 1.0 - e
    f = (1.0 - alpha) + 1e-10
    t_all = torch.cumprod(torch.cat([torch.ones_like(f[:, :1]), f], dim=1), dim=1)
    T, t_total = t_all[:, :-1], t_all[:, -1]
    w = alpha * T
    gw = torch.zeros_like(w) if g_weight is None else g_weight.clone()
    gT = torch.zeros_like(t_total) if g_t is None else g_t.clone()
    d_rgb = None
    if rgb is not None:
        gc = torch.zeros((N, 3), dtype=density.dtype, device=density.device)
        if g_color is not None:
            c = (w[..., None] * rgb).sum(dim=1)
            bg = None if background is None else _per_ray_background(background, N)
            if bg is not None:
                c = c + bg * t_total[:, None]
            x = c + 1e-5
            gc = g_color * _clip_grad(x ** INV_GAMMA) * (INV_GAMMA * x ** (INV_GAMMA - 1.0))
            if bg is not None:
                gT = gT + (gc * bg).sum(dim=-1)
        gw = gw + (gc[:, None, :] * rgb).sum(dim=-1)
        d_rgb = gc[:, None, :] * w[..., None]
    r_behind = torch.empty_like(w)
    R = gT
    for k in range(S - 1, -1, -1):
        r_behind[:, k] = R
        R = gw[:, k] * alpha[:, k] + f[:, k] * R
    d_density = T * (gw - r_behind) * e * dist * v
    return d_density, d_rgb


class _RayMarch(torch.autograd.Function):
    """K5 as one autograd node: (density, rgb) -> (colour, w, T_total)."""

    @staticmethod
    def forward(ctx, density, rgb, valid, dist, background):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(density, rgb, valid, dist, background)
        if density.is_cuda:
            color, w, t_total = cuda_kernels.ray_march(density, valid, dist, rgb, background)
        else:
            color, w, t_total = ray_march_plain(density, valid, dist, rgb, background)
        if color is None:
            color = density.new_zeros((density.shape[0], 0))
            ctx.mark_non_differentiable(color)
        return color, w, t_total

    @staticmethod
    def backward(ctx, g_color, g_weight, g_t):
        density, rgb, valid, dist, background = ctx.saved_tensors
        if rgb is None:
            g_color = None
        if g_color is None and g_weight is None and g_t is None:
            return None, None, None, None, None
        args = (density, valid, dist, rgb, background, g_color, g_weight, g_t)
        if density.is_cuda:
            d_density, d_rgb = cuda_kernels.ray_march_backward(*args)
        else:
            d_density, d_rgb = ray_march_backward_plain(*args)
        return d_density, d_rgb, None, None, None


def march_rays(
    density: torch.Tensor,
    valid: torch.Tensor,
    dist: torch.Tensor,
    rgb: torch.Tensor | None = None,
    background: torch.Tensor | None = None,
) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor]:
    """NeuTex's composite (`ngf_tpu/fields/neutex.py:417-423`): the ray
    march, the background weighted by the transmittance past the last
    sample, the tone map.

    Args:
      density: (B, R, S) float32; valid (B, R, S) bool; dist (B, R, S)
        float32 segment lengths (no gradient).
      rgb: (B, R, S, 3) float32 radiance, or None for the colour-free march.
      background: (B, 3) float32, or None.

    Returns:
      (colour (B, R, 3) tone-mapped, or None without rgb; blend weights
      (B, R, S); background weight T_total (B, R)). Differentiable in
      density and rgb. On the card one K5 launch each way, on the CPU the
      plain versions.
    """
    lead, S = density.shape[:-1], density.shape[-1]
    flat = lambda t: t.reshape(-1, S)  # noqa: E731
    rgb2 = None if rgb is None else rgb.reshape(-1, S, 3)
    bg = None if background is None else background.reshape(-1, 3).to(torch.float32).contiguous()
    color, w, t_total = _RayMarch.apply(flat(density), rgb2, flat(valid), flat(dist).detach(), bg)
    return (
        None if rgb is None else color.reshape(*lead, 3),
        w.reshape(*lead, S),
        t_total.reshape(lead),
    )


def composite_plain(sigma, dist, rgb, z, ray_last, background, thres: float):
    """K5's tri-plane forward in plain PyTorch: the renderers' composite
    after the field (`ngf_tpu/render/volume.py:311-358,469-505`).

    Args:
      sigma: (N, S) density times the valid mask; dist: (N, S) segment
        lengths or one number; rgb: (N, S, 3); z: (N, S) depths; ray_last:
        (N,) each ray's last component.
      background: b of ``y = sum w m rgb + b (1 - acc)``: a number, a
        0-dim tensor (the training draw), or None (nothing added).
      thres: the shading threshold, ``m = w > thres``.

    Returns:
      (rgb_map = clip(y, 0, 1) (N, 3), y (N, 3), acc (N,), depth (N,, no
      gradient), w (N, S)); differentiable through autograd, the clip as
      ``jnp.clip`` (maximum then minimum: half the gradient at a bound).
    """
    _, w, _ = raw2alpha(sigma, dist)
    acc = w.sum(dim=-1)
    mask = (w > thres).to(w.dtype)
    y = ((w * mask)[..., None] * rgb).sum(dim=-2)
    if background is not None:
        y = y + background * (1.0 - acc[..., None])
    rgb_map = torch.minimum(torch.maximum(y, y.new_zeros(())), y.new_ones(()))
    depth = ((w * z).sum(dim=-1) + (1.0 - acc) * ray_last).detach()
    return rgb_map, y, acc, depth, w


def composite_backward_plain(sigma, dist, rgb, background, thres: float, rgb_lin, g_rgb, g_acc,
                             g_w=None):
    """K5's tri-plane backward in plain PyTorch, the kernel's reverse scan
    (as :func:`ray_march_backward_plain`): from the cotangents of rgb_map
    (N, 3), acc (N,) and w (N, S) (each may be None) and the forward's y
    (``rgb_lin``), the gradients of sigma (N, S) and rgb (N, S, 3; None
    without rgb, the top-K mode's weight backward). With gw_k = g_acc -
    b sum(gy) + g_w_k + m_k gy . rgb_k, gy the colour's cotangent through
    the clip (half at a bound), R runs R_{S-1} = 0, R_{k-1} = gw_k alpha_k +
    f_k R_k and dL/dalpha_k = T_k (gw_k - R_k): no division by f_k. w and its
    mask are the forward's, bit for bit."""
    N, S = sigma.shape
    e = torch.exp(-sigma * dist)
    alpha = 1.0 - e
    t, _ = exclusive_transmittance(alpha)
    w = alpha * t
    shaded = (w > thres).to(w.dtype)
    f = (1.0 - alpha) + 1e-10
    gy = sigma.new_zeros((N, 3)) if g_rgb is None else g_rgb * _clip_grad(rgb_lin)
    ga = sigma.new_zeros((N,)) if g_acc is None else g_acc
    if background is not None:
        ga = ga - background * gy.sum(dim=-1)
    gw = ga[:, None].expand(N, S)
    if g_w is not None:
        gw = gw + g_w
    d_rgb = None
    if rgb is not None:
        gw = gw + shaded * (gy[:, None, :] * rgb).sum(dim=-1)
        d_rgb = gy[:, None, :] * (w * shaded)[..., None]
    if not isinstance(dist, torch.Tensor):
        dist = torch.full_like(sigma, dist)
    r_behind = torch.empty_like(w)
    R = sigma.new_zeros((N,))
    for k in range(S - 1, -1, -1):
        r_behind[:, k] = R
        R = gw[:, k] * alpha[:, k] + f[:, k] * R
    return t * (gw - r_behind) * e * dist, d_rgb


class _Composite(torch.autograd.Function):
    """K5's tri-plane mode as one autograd node: (sigma, rgb) -> (rgb_map,
    acc, depth, w)."""

    @staticmethod
    def forward(ctx, sigma, rgb, dist, z, ray_last, background, thres, weights):
        ctx.set_materialize_grads(False)
        if sigma.is_cuda:
            rgb_map, y, acc, depth, w = cuda_kernels.ray_march_triplane(
                sigma, dist, rgb, z, ray_last, background, thres, weights)
        else:
            rgb_map, y, acc, depth, w = composite_plain(
                sigma, dist, rgb, z, ray_last, background, thres)
            w = w if weights else None
        tensors = [t if isinstance(t, torch.Tensor) else None for t in (dist, background)]
        ctx.save_for_backward(sigma, rgb, y, *tensors)
        ctx.dist = None if tensors[0] is not None else dist
        ctx.background = None if tensors[1] is not None else background
        ctx.thres = thres
        ctx.mark_non_differentiable(depth, *([] if w is None else [w]))
        return rgb_map, acc, depth, w

    @staticmethod
    def backward(ctx, g_rgb, g_acc, g_depth, g_w):
        sigma, rgb, y, dist_t, bg_t = ctx.saved_tensors
        if g_rgb is None and g_acc is None:
            return (None,) * 8
        dist = ctx.dist if dist_t is None else dist_t
        background = ctx.background if bg_t is None else bg_t
        args = (sigma, dist, rgb, background, ctx.thres, y, g_rgb, g_acc)
        if sigma.is_cuda:
            d_sigma, d_rgb = cuda_kernels.ray_march_triplane_backward(*args)
        else:
            d_sigma, d_rgb = composite_backward_plain(*args)
        return d_sigma, d_rgb, None, None, None, None, None, None


def composite(
    sigma: torch.Tensor,
    dist: torch.Tensor | float,
    rgb: torch.Tensor,
    z: torch.Tensor,
    ray_last: torch.Tensor,
    background: torch.Tensor | float | None,
    thres: float,
    weights: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """The tri-plane renderers' composite (`ngf_tpu/render/volume.py:311-358`
    grouped, `:469-505` dense): weights, shading mask, colour with the
    background and the clip, acc and depth, in one K5 launch each way on
    the card and the plain pair on the CPU. Arguments as
    :func:`composite_plain`'s; ``dist`` and the depth inputs get no
    gradient. Returns (rgb_map (N, 3), acc (N,), depth (N,), w (N, S) when
    ``weights``, else None); differentiable in sigma and rgb."""
    if isinstance(dist, torch.Tensor):
        dist = dist.detach()
    return _Composite.apply(sigma, rgb, dist, z.detach(), ray_last.detach(), background,
                            float(thres), weights)


def _topk_samples(idx: torch.Tensor, group: int) -> torch.Tensor:
    """(N, K / G) group ids -> (N, K) sample ids: slot k's sample is
    idx[n, k // G] * G + k % G."""
    if group == 1:
        return idx
    n = idx.shape[0]
    return (idx[..., None] * group + torch.arange(group, device=idx.device)).reshape(n, -1)


def composite_topk_plain(w, acc, idx, group: int, rgb_k, background, thres: float):
    """K5's top-K colour pass in plain PyTorch: the top-K shading of
    `ngf_tpu/render/volume.py:315-353` (grouped, G the group) and `:473-501`
    (dense, G 1) after the weights are known. With slot k's sample s_k =
    idx[n, k // G] * G + k % G and m_k = (w_{s_k} > thres),
    y = sum_k m_k w_{s_k} rgb_k + b (1 - acc).

    Args:
      w: (N, S) blend weights; acc: (N,) their sum.
      idx: (N, K / G) int64 group (or sample) ids, distinct a ray.
      rgb_k: (N, K, 3) the colours of the selected samples.
      background: b as in :func:`composite_plain`; thres the threshold.

    Returns:
      (rgb_map = clip(y, 0, 1) (N, 3), y (N, 3)); differentiable through
      autograd in w, acc and rgb_k, the clip as ``jnp.clip``.
    """
    w_k = torch.gather(w, 1, _topk_samples(idx, group))
    mask = (w_k > thres).to(w_k.dtype)
    y = ((w_k * mask)[..., None] * rgb_k).sum(dim=-2)
    if background is not None:
        y = y + background * (1.0 - acc[..., None])
    return torch.minimum(torch.maximum(y, y.new_zeros(())), y.new_ones(())), y


def composite_topk_backward_plain(w, idx, group: int, rgb_k, background, thres: float, rgb_lin,
                                  g_rgb):
    """The backward of :func:`composite_topk_plain` as K5's top-K backward
    computes it: with gy the cotangent of rgb_map through the clip (half at
    a bound), the cotangent of w (N, S): m_k gy . rgb_k at the selected
    samples and 0 elsewhere; of acc (N,): -b sum(gy); of rgb_k (N, K, 3):
    gy m_k w_{s_k}. Returns (g_w, d_acc, d_rgb_k)."""
    s = _topk_samples(idx, group)
    w_k = torch.gather(w, 1, s)
    mask = (w_k > thres).to(w_k.dtype)
    gy = g_rgb * _clip_grad(rgb_lin)
    g_w = torch.zeros_like(w).scatter_(1, s, mask * (gy[:, None, :] * rgb_k).sum(dim=-1))
    d_acc = -(0.0 if background is None else background) * gy.sum(dim=-1)
    return g_w, d_acc, gy[:, None, :] * (w_k * mask)[..., None]


class _CompositeWeights(torch.autograd.Function):
    """K5's tri-plane mode without colour as one autograd node: sigma ->
    (w, acc, depth); backward the tri-plane reverse scan from the cotangents
    of w and acc."""

    @staticmethod
    def forward(ctx, sigma, dist, z, ray_last):
        ctx.set_materialize_grads(False)
        if sigma.is_cuda:
            _, _, acc, depth, w = cuda_kernels.ray_march_triplane(
                sigma, dist, None, z, ray_last, None, 0.0, weights=True)
        else:
            _, w, _ = raw2alpha(sigma, dist)
            acc = w.sum(dim=-1)
            depth = ((w * z).sum(dim=-1) + (1.0 - acc) * ray_last).detach()
        dist_t = dist if isinstance(dist, torch.Tensor) else None
        ctx.save_for_backward(sigma, dist_t)
        ctx.dist = None if dist_t is not None else dist
        ctx.mark_non_differentiable(depth)
        return w, acc, depth

    @staticmethod
    def backward(ctx, g_w, g_acc, g_depth):
        sigma, dist_t = ctx.saved_tensors
        if g_w is None and g_acc is None:
            return None, None, None, None
        dist = ctx.dist if dist_t is None else dist_t
        args = (sigma, dist, None, None, 0.0, None, None, g_acc, g_w)
        if sigma.is_cuda:
            d_sigma, _ = cuda_kernels.ray_march_triplane_backward(*args)
        else:
            d_sigma, _ = composite_backward_plain(*args)
        return d_sigma, None, None, None


class _CompositeTopK(torch.autograd.Function):
    """K5's top-K colour pass as one autograd node: (w, acc, rgb_k) ->
    rgb_map."""

    @staticmethod
    def forward(ctx, w, acc, rgb_k, idx, group, background, thres):
        ctx.set_materialize_grads(False)
        if w.is_cuda:
            rgb_map, y = cuda_kernels.ray_march_triplane_topk(
                w, acc, idx, group, rgb_k, background, thres)
        else:
            rgb_map, y = composite_topk_plain(w, acc, idx, group, rgb_k, background, thres)
        bg_t = background if isinstance(background, torch.Tensor) else None
        ctx.save_for_backward(w, rgb_k, idx, y, bg_t)
        ctx.background = None if bg_t is not None else background
        ctx.group, ctx.thres = group, thres
        return rgb_map

    @staticmethod
    def backward(ctx, g_rgb):
        w, rgb_k, idx, y, bg_t = ctx.saved_tensors
        if g_rgb is None:
            return (None,) * 7
        background = ctx.background if bg_t is None else bg_t
        args = (w, idx, ctx.group, rgb_k, background, ctx.thres, y, g_rgb)
        if w.is_cuda:
            g_w, d_acc, d_rgb = cuda_kernels.ray_march_triplane_topk_backward(*args)
        else:
            g_w, d_acc, d_rgb = composite_topk_backward_plain(*args)
        return g_w, d_acc, d_rgb, None, None, None, None


def composite_weights(
    sigma: torch.Tensor, dist: torch.Tensor | float, z: torch.Tensor, ray_last: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The first half of the top-K composite: blend weights w (N, S), acc
    (N,) and depth (N,, no gradient; filled with ``ray_last`` as
    :func:`composite` fills it) of sigma (N, S), differentiable in sigma
    through w and acc. On the card one K5 tri-plane launch without rgb each
    way (its backward takes the cotangent of w), on the CPU the plain pair."""
    if isinstance(dist, torch.Tensor):
        dist = dist.detach()
    return _CompositeWeights.apply(sigma, dist, z.detach(), ray_last.detach())


def composite_topk(
    w: torch.Tensor,
    acc: torch.Tensor,
    idx: torch.Tensor,
    group: int,
    rgb_k: torch.Tensor,
    background: torch.Tensor | float | None,
    thres: float,
) -> torch.Tensor:
    """The second half of the top-K composite: rgb_map (N, 3) from the K
    shaded samples' colours rgb_k (N, K, 3) at the (N, K / G) group ids
    ``idx`` (sample ids with ``group`` 1), with :func:`composite_weights`'
    w and acc, as :func:`composite_topk_plain` defines it. Differentiable in
    w, acc and rgb_k. On the card one K5 top-K launch each way, on the CPU
    the plain pair."""
    return _CompositeTopK.apply(w, acc, rgb_k, idx, int(group), background, float(thres))


def composite_shard_totals_plain(sigma: torch.Tensor, dist) -> torch.Tensor:
    """K5's shard-mode totals in plain PyTorch: t_end = prod_k (1 - alpha_k
    + 1e-10) over the shard's samples (`ngf_tpu/parallel/sample_parallel.py:
    99-103`). sigma (N, S); dist (N, S) or a number. Returns (N,)."""
    _, t_total = exclusive_transmittance(1.0 - torch.exp(-sigma * dist))
    return t_total[:, 0]


def composite_shard_plain(sigma, dist, rgb, z, t0, thres: float):
    """K5's shard-mode composite in plain PyTorch: one shard's share of the
    sample-parallel composite (`ngf_tpu/parallel/sample_parallel.py:105-117`)
    from its starting transmittance t0 (N,): w = (alpha T) t0 in the JAX
    package's order, m = w > thres, and the partial sums, with no
    background, clip or depth fill.

    Returns:
      (y = sum m w rgb (N, 3), acc = sum w (N,), depth = sum w z (N,),
      local (N, 4): sum m alpha T rgb and sum alpha T, from which the
      gradient of t0 follows without a pass over the samples, w (N, S)).
    """
    alpha = 1.0 - torch.exp(-sigma * dist)
    t, _ = exclusive_transmittance(alpha)
    wl = alpha * t
    w = wl * t0[:, None]
    mask = (w > thres).to(w.dtype)
    y = ((w * mask)[..., None] * rgb).sum(dim=-2)
    local = torch.cat([((wl * mask)[..., None] * rgb).sum(dim=-2), wl.sum(dim=-1, keepdim=True)], -1)
    return y, w.sum(dim=-1), (w * z).sum(dim=-1), local, w


def composite_shard_backward_plain(sigma, dist, rgb, t0, thres: float, g_y, g_acc, g_tend):
    """K5's shard-mode backward in plain PyTorch, the kernel's reverse scan:
    from the cotangents of y (N, 3), acc (N,) and t_end (N,) (each may be
    None), the gradients of sigma (N, S), rgb (N, S, 3) and t0 (N,). With
    gw_k = g_acc + m_k g_y . rgb_k the cotangent of w_k, the cotangent of
    alpha_k T_k is t0 gw_k, R runs R_{S-1} = g_tend, R_{k-1} = t0 gw_k
    alpha_k + f_k R_k and dL/dalpha_k = T_k (t0 gw_k - R_k); dL/dt0 =
    sum_k gw_k alpha_k T_k. No division by t0 or f_k (t0 is 0 behind opaque
    shards, f_k 1e-10 where alpha rounds to 1). w and its mask are the
    forward's, bit for bit."""
    N, S = sigma.shape
    e = torch.exp(-sigma * dist)
    alpha = 1.0 - e
    t, _ = exclusive_transmittance(alpha)
    wl = alpha * t
    w = wl * t0[:, None]
    shaded = (w > thres).to(w.dtype)
    gy = sigma.new_zeros((N, 3)) if g_y is None else g_y
    ga = sigma.new_zeros((N,)) if g_acc is None else g_acc
    gw = ga[:, None] + shaded * (gy[:, None, :] * rgb).sum(dim=-1)
    d_rgb = gy[:, None, :] * (w * shaded)[..., None]
    d_t0 = (gw * wl).sum(dim=-1)
    gw = gw * t0[:, None]
    f = (1.0 - alpha) + 1e-10
    if not isinstance(dist, torch.Tensor):
        dist = torch.full_like(sigma, dist)
    r_behind = torch.empty_like(w)
    R = sigma.new_zeros((N,)) if g_tend is None else g_tend
    for k in range(S - 1, -1, -1):
        r_behind[:, k] = R
        R = gw[:, k] * alpha[:, k] + f[:, k] * R
    return t * (gw - r_behind) * e * dist, d_rgb, d_t0


class _ShardState:
    """What a shard's two autograd nodes share: the composite's inputs, and
    the cotangents of y and acc, which its backward hands to the totals'
    backward."""

    def __init__(self, dist, thres: float):
        self.dist, self.thres = dist, thres
        self.t0 = self.g_y = self.g_acc = None


class _ShardTotals(torch.autograd.Function):
    """(sigma, rgb) -> t_end: forward K5's totals launch; backward the
    shard's one backward launch, run last (every cotangent of the shard has
    reached it: t_end's from the exchange, y's and acc's from
    :class:`_ShardComposite`), for sigma and rgb."""

    @staticmethod
    def forward(ctx, sigma, rgb, state):
        ctx.set_materialize_grads(False)
        if sigma.is_cuda:
            t_end = cuda_kernels.ray_march_triplane_totals(sigma, state.dist)
        else:
            t_end = composite_shard_totals_plain(sigma, state.dist)
        ctx.save_for_backward(sigma, rgb)
        ctx.state = state
        return t_end

    @staticmethod
    def backward(ctx, g_tend):
        st = ctx.state
        sigma, rgb = ctx.saved_tensors
        if g_tend is None and st.g_y is None and st.g_acc is None:
            return None, None, None
        args = (sigma, st.dist, rgb, st.t0, st.thres, st.g_y, st.g_acc, g_tend)
        if sigma.is_cuda:
            d_sigma, d_rgb, _ = cuda_kernels.ray_march_triplane_shard_backward(*args)
        else:
            d_sigma, d_rgb, _ = composite_shard_backward_plain(*args)
        return d_sigma, d_rgb, None


class _ShardComposite(torch.autograd.Function):
    """t0 -> (y, acc, depth) of a shard: forward K5's composite launch (on
    sigma and rgb, whose gradients :class:`_ShardTotals` gives); backward
    the gradient of t0 from the forward's local sums, and the cotangents of
    y and acc kept for :class:`_ShardTotals`."""

    @staticmethod
    def forward(ctx, t0, sigma, rgb, z, state):
        ctx.set_materialize_grads(False)
        if sigma.is_cuda:
            y, acc, depth, local, _ = cuda_kernels.ray_march_triplane_shard(
                sigma, state.dist, rgb, z, t0, state.thres)
        else:
            y, acc, depth, local, _ = composite_shard_plain(sigma, state.dist, rgb, z, t0, state.thres)
        state.t0 = t0.detach()
        ctx.save_for_backward(local)
        ctx.state = state
        ctx.mark_non_differentiable(depth)
        return y, acc, depth

    @staticmethod
    def backward(ctx, g_y, g_acc, g_depth):
        st = ctx.state
        (local,) = ctx.saved_tensors
        st.g_y, st.g_acc = g_y, g_acc
        d_t0 = None
        if g_acc is not None:
            d_t0 = g_acc * local[:, 3]
        if g_y is not None:
            d_y = (g_y * local[:, :3]).sum(dim=-1)
            d_t0 = d_y if d_t0 is None else d_t0 + d_y
        return d_t0, None, None, None, None


def composite_shard(
    sigma: torch.Tensor,
    dist: torch.Tensor | float,
    rgb: torch.Tensor,
    z: torch.Tensor,
    thres: float,
    exchange,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One shard's share of the sample-parallel composite
    (`ngf_tpu/parallel/sample_parallel.py:97-117`): its total transmittance
    t_end, ``t0 = exchange(t_end)`` (the product of the earlier shards'
    totals, by the caller's exchange between the shards), then the partial
    sums from t0.

    Args:
      sigma: (N, S) the shard's density times its valid mask; dist (N, S)
        or one number; rgb (N, S, 3); z (N, S) depths; thres the shading
        threshold.
      exchange: ``t_end (N,) -> t0 (N,)``, differentiable.

    Returns:
      (y = sum m w rgb (N, 3), acc (N,), depth = sum w z (N,, no gradient)),
      with w = (alpha T) t0 and m = w > thres: no background, clip or depth
      fill, which follow the sums over the shards. Differentiable in sigma,
      rgb and, through t0, the exchange. On the card K5's shard mode: a
      totals launch before the exchange, a composite launch after it, and
      one backward launch once every cotangent has arrived; on the CPU the
      plain versions.
    """
    if isinstance(dist, torch.Tensor):
        dist = dist.detach()
    state = _ShardState(dist, float(thres))
    t_end = _ShardTotals.apply(sigma, rgb, state)
    t0 = exchange(t_end)
    if t_end.requires_grad and not t0.requires_grad:
        raise ValueError("composite_shard: the exchange must keep t0 differentiable in t_end")
    return _ShardComposite.apply(t0, sigma.detach(), rgb.detach(), z.detach(), state)
