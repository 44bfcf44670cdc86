"""Bilinear and trilinear grid sampling with torch ``F.grid_sample`` semantics.

Port of `ngf_tpu/ops/grid_sample.py`: ``align_corners=True`` (coordinate -1
hits the center of the first texel, +1 the center of the last), zero
padding, and torch's coordinate order (``coords[..., 0]`` indexes the W axis,
``coords[..., 1]`` H, ``coords[..., 2]`` D). Planes are channels-last (H, W, C)
and volumes (D, H, W, C), as in the JAX package.

``grid_sample_planes`` is the hot op of every tri-plane fetch: the three
planes at their three projections in one call, split into the density and
appearance decoders' inputs. On CUDA tensors it launches the hand-written
kernel ``bilinear_gather_planes`` (`ngf_tpu_torch/ops/cuda_kernels.py`) and,
for the plane gradients, its backward ``bilinear_gather_2d_backward``, or,
where the coordinates need a gradient too (the learned gauge's deformed
coordinates), ``bilinear_gather_planes_backward_coords`` (K2c) for both
gradients of all planes in one launch; on CPU tensors it runs the plain
versions below. There is no fallback between the two.
``grid_sample_2d`` is its one-plane call.

A fetch names its channels of the whole plane (``channels``), so its
gradient lands in those channels of the whole plane's gradient: no slice is
copied either way, and both outputs of a plane add into one buffer. A fetch
in another compute dtype (bfloat16 training) casts the float32 planes
inside the fetch, once per call: the kernels read the bfloat16 values and
the bfloat16 cotangents as they are and add the plane gradient in float32
straight into the float32 planes' gradients, with no rounding to bfloat16
on the way back.

``occupancy_lookup`` is the trilinear alpha-mask test ``> 0``: the
``occupancy_lookup`` kernel (K3) on CUDA tensors, ``occupancy_lookup_plain``
on CPU tensors. ``max_pool_3d`` dilates the mask and ``resize_bilinear_2d``
resizes a plane at the upsample event, both library calls, and so is
``grid_sample_2d_border`` (``align_corners=False``, border padding), the UV
path's edited-texture lookup, off its training path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_kernels


def _unnormalize(c: torch.Tensor, size: int) -> torch.Tensor:
    # align_corners=True mapping from [-1, 1] to [0, size-1]
    # (`ngf_tpu/ops/grid_sample.py:33-35`).
    return (c + 1.0) * 0.5 * (size - 1)


def _axis_patch_weights(c: torch.Tensor, size: int):
    """Per-axis (start, w0, w1) of the clipped 2-texel stencil
    (`ngf_tpu/ops/grid_sample.py:38-57`).

    The stencil starts at clip(floor(c), 0, size-2); slot j holds texel
    start+j with the bilinear weight that texel has in the *unclipped*
    stencil, or 0 — torch's zero padding without out-of-bounds reads. ``c``
    is clamped to [-2, size+1] first, as the CUDA kernel does: beyond that
    every weight is 0 anyway, and the clamp keeps the integer cast in range.
    """
    c = c.clamp(-2.0, size + 1.0)
    c0f = torch.floor(c)
    frac = c - c0f
    c0 = c0f.long()
    start = c0.clamp(0, size - 2)
    zero = torch.zeros_like(frac)
    w0 = torch.where(start == c0, 1.0 - frac, zero) + torch.where(start == c0 + 1, frac, zero)
    w1 = torch.where(start + 1 == c0, 1.0 - frac, zero) + torch.where(
        start + 1 == c0 + 1, frac, zero
    )
    return start, w0, w1


def grid_sample_2d_plain(plane: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the ``bilinear_gather_2d`` kernel.

    Same arithmetic as the kernel: the four taps of `_axis_patch_weights`,
    index and weight math in float32, a weighted sum in float32 cast to the
    plane's dtype at the end. Independent of ``F.grid_sample``.

    Args:
      plane: (H, W, C), H, W >= 2; a channel slice of a wider plane is fine.
      coords: (..., 2) float32, x -> W axis, y -> H axis.

    Returns:
      (..., C) in the plane's dtype; zero outside [-1, 1].
    """
    H, W, C = plane.shape
    if H < 2 or W < 2:
        raise ValueError(f"plane must be at least 2x2, got {H}x{W}")
    batch_shape = coords.shape[:-1]
    coords = coords.reshape(-1, 2).float()
    xs, wx0, wx1 = _axis_patch_weights(_unnormalize(coords[:, 0], W), W)
    ys, wy0, wy1 = _axis_patch_weights(_unnormalize(coords[:, 1], H), H)
    flat = plane.reshape(H * W, C)
    idx = ys * W + xs
    out = (
        flat[idx].float() * (wy0 * wx0)[:, None]
        + flat[idx + 1].float() * (wy0 * wx1)[:, None]
        + flat[idx + W].float() * (wy1 * wx0)[:, None]
        + flat[idx + W + 1].float() * (wy1 * wx1)[:, None]
    )
    return out.to(plane.dtype).reshape(*batch_shape, C)


def grid_sample_2d_backward_plain(
    g: torch.Tensor, coords: torch.Tensor, grad_plane: torch.Tensor, channel_offset: int = 0
) -> None:
    """Plain PyTorch version of the ``bilinear_gather_2d_backward`` kernel.

    Adds, in place, the plane gradient of a gather of channels
    ``channel_offset : channel_offset + C`` into those channels of
    ``grad_plane``: each point's ``w_tap * g`` into its four stencil texels
    (the taps of `_axis_patch_weights`) with ``index_add_``, in float32. The
    explicit form of the plane branch of `ngf_tpu/ops/grid_sample.py:421-501`.

    Args:
      g: (..., C) gradient of the gather's output, float32 or bfloat16
        (widened to float32, as the kernel does).
      coords: (..., 2) the gather's coordinates.
      grad_plane: (H, W, C_total) float32, contiguous.
    """
    H, W, c_total = grad_plane.shape
    C = g.shape[-1]
    if not 0 <= channel_offset <= c_total - C:
        raise ValueError(f"channels {channel_offset}:{channel_offset + C} outside 0:{c_total}")
    coords = coords.reshape(-1, 2).float()
    g = g.reshape(-1, C).float()
    xs, wx0, wx1 = _axis_patch_weights(_unnormalize(coords[:, 0], W), W)
    ys, wy0, wy1 = _axis_patch_weights(_unnormalize(coords[:, 1], H), H)
    dst = grad_plane.view(H * W, c_total)[:, channel_offset : channel_offset + C]
    idx = ys * W + xs
    for off, w in ((0, wy0 * wx0), (1, wy0 * wx1), (W, wy1 * wx0), (W + 1, wy1 * wx1)):
        dst.index_add_(0, idx + off, g * w[:, None])


def _axis_weight_grads(c: torch.Tensor, size: int):
    """d(w0)/dc, d(w1)/dc of :func:`_axis_patch_weights` at the unnormalised
    coordinate ``c`` (`ngf_tpu/ops/grid_sample.py:354-363`): +1 where the
    slot's texel is the stencil's upper corner, -1 where it is the lower one,
    else 0; 0 beyond the clamp to [-2, size+1], as the autograd of the clamp
    gives it."""
    c0 = torch.floor(c.clamp(-2.0, size + 1.0)).long()
    start = c0.clamp(0, size - 2)
    dw0 = (start == c0 + 1).float() - (start == c0).float()
    dw1 = (start + 1 == c0 + 1).float() - (start + 1 == c0).float()
    return dw0, dw1


def grid_sample_2d_backward_coords_plain(
    plane: torch.Tensor, coords: torch.Tensor, g: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of the coordinate half of one plane of the
    ``bilinear_gather_planes_backward_coords`` kernel (K2c): the gradient of
    :func:`grid_sample_2d_plain` with respect to its coordinates, written
    out, not by autograd (the coordinate branch of `_duobwd_bwd`,
    `ngf_tpu/ops/grid_sample.py:434-455`). With the four taps j = 00, 01,
    10, 11 (first index y) and t_j = sum_c plane[tap_j, c] * g_c in float32:
    gx = (t00 wy0 dwx0 + t01 wy0 dwx1 + t10 wy1 dwx0 + t11 wy1 dwx1) (W-1)/2,
    and gy likewise with (H-1)/2.

    Args:
      plane: (H, W, C), the fetched channels (a slice of a wider plane is
        fine), float32 or bfloat16.
      coords: (..., 2) the fetch's coordinates.
      g: (..., C) the gradient of the fetch's output, float32 or bfloat16;
        the tap sums run in float32 either way, as in the kernel.

    Returns:
      (..., 2) float32.
    """
    H, W, C = plane.shape
    batch_shape = coords.shape[:-1]
    flat_c = coords.reshape(-1, 2).float()
    g = g.reshape(-1, C).float()
    x, y = _unnormalize(flat_c[:, 0], W), _unnormalize(flat_c[:, 1], H)
    xs, wx0, wx1 = _axis_patch_weights(x, W)
    ys, wy0, wy1 = _axis_patch_weights(y, H)
    dwx0, dwx1 = _axis_weight_grads(x, W)
    dwy0, dwy1 = _axis_weight_grads(y, H)
    flat = plane.reshape(H * W, C)
    idx = ys * W + xs
    t00, t01, t10, t11 = (
        (flat[idx + off].float() * g).sum(-1) for off in (0, 1, W, W + 1)
    )
    gx = (t00 * wy0 * dwx0 + t01 * wy0 * dwx1 + t10 * wy1 * dwx0 + t11 * wy1 * dwx1) * (
        0.5 * (W - 1))
    gy = (t00 * dwy0 * wx0 + t01 * dwy0 * wx1 + t10 * dwy1 * wx0 + t11 * dwy1 * wx1) * (
        0.5 * (H - 1))
    return torch.stack([gx, gy], dim=-1).reshape(*batch_shape, 2)


def grid_sample_planes_backward_coords_plain(
    planes, coords, g_a, g_b, grads, channel_offset: int = 0, split: int | None = None
) -> torch.Tensor:
    """Plain PyTorch version of the ``bilinear_gather_planes_backward_coords``
    kernel (K2c), with its arguments: both gradients of a fetch of channels
    ``channel_offset : channel_offset + C`` of 1 to 3 planes, each of its own
    shape. For each plane and output, :func:`grid_sample_2d_backward_plain`
    adds the plane gradient into ``grads[p]`` and
    :func:`grid_sample_2d_backward_coords_plain` gives the coordinate
    gradient, summed over the two outputs.

    Args:
      planes, coords, grads: as many (H_p, W_p, C_total) values (float32 or
        bfloat16), (..., 2) coordinates and float32 (H_p, W_p, C_total)
        gradients.
      g_a, g_b: (..., P, C_a) over channels ``channel_offset : channel_offset
        + split`` and (..., P, C_b) over the next C_b, either None.
      split: where g_b's channels start; g_a's width by default.

    Returns:
      (..., P, 2) float32, in the kernel's layout.
    """
    if split is None:
        if g_a is None:
            raise ValueError("grid_sample_planes_backward_coords_plain needs split without g_a")
        split = g_a.shape[-1]
    out = []
    for p, (plane, c, grad) in enumerate(zip(planes, coords, grads)):
        cg = torch.zeros(c.shape, dtype=torch.float32, device=c.device)
        for g, off in ((g_a, channel_offset), (g_b, channel_offset + split)):
            if g is not None:
                gp = g[..., p, :]
                grid_sample_2d_backward_plain(gp, c, grad, off)
                cg = cg + grid_sample_2d_backward_coords_plain(
                    plane[..., off : off + gp.shape[-1]], c, gp)
        out.append(cg)
    return torch.stack(out, dim=-2)


def grid_sample_planes_plain(
    planes, coords, channels: slice = slice(None), split: int | None = None
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain PyTorch version of the ``bilinear_gather_planes`` kernel: one
    :func:`grid_sample_2d_plain` of channels ``channels`` per plane, written
    into the kernel's split layout (``out_a`` (..., P, split), ``out_b``
    (..., P, C - split), ``out_b`` None without a split)."""
    full = torch.stack(
        [grid_sample_2d_plain(p[..., channels], c) for p, c in zip(planes, coords)], dim=-2
    )
    if split is None:
        return full, None
    return full[..., :split].contiguous(), full[..., split:].contiguous()


class _BilinearGatherPlanes(torch.autograd.Function):
    """``grid_sample_planes`` of channels ``c0:c1``, split at ``split``, of
    the planes' values in ``dtype`` (a copy of each plane where it is
    another; None keeps the planes' own): one launch of the gather kernel
    (CUDA) or its plain version (CPU) forward. Backward, each plane's
    gradient in one float32 (H, W, C) buffer, whatever ``dtype``: where only
    the planes need a gradient, the backward kernel (CUDA) or its plain
    version (CPU) adds each output's channels into it; where any plane's
    coordinates need one too (the learned gauge), K2c (CUDA, one launch for
    both gradients of every plane and both outputs) or its plain version
    (CPU) gives both, from the values the forward fetched. The cotangents
    reach the kernels in the dtype they come in."""

    @staticmethod
    def forward(ctx, c0, c1, split, dtype, *tensors):
        P = len(tensors) // 2
        planes, coords = tensors[:P], tensors[P:]
        values = planes
        if dtype is not None and dtype != planes[0].dtype:
            values = tuple(p.to(dtype) for p in planes)
        if not planes[0].is_cuda:
            out_a, out_b = grid_sample_planes_plain(values, coords, slice(c0, c1), split)
        elif P == 1 and split is None:
            out_a, out_b = cuda_kernels.bilinear_gather_2d(values[0][..., c0:c1], coords[0]), None
            out_a = out_a.unsqueeze(-2)
        else:
            out_a, out_b = cuda_kernels.bilinear_gather_planes(values, coords, slice(c0, c1), split)
        coord_grads = any(ctx.needs_input_grad[4 + P:])
        ctx.save_for_backward(*coords, *(values if coord_grads else ()))
        ctx.meta = (c0, out_a.shape[-1], [(p.shape, p.device) for p in planes])
        ctx.set_materialize_grads(False)
        return out_a, out_b

    @staticmethod
    def backward(ctx, g_a, g_b):
        saved = ctx.saved_tensors
        c0, split, planes = ctx.meta
        P = len(planes)
        coords, values = saved[:P], saved[P:]
        need_planes, need_coords = ctx.needs_input_grad[4:4 + P], ctx.needs_input_grad[4 + P:]
        none = (None,) * (4 + 2 * P)
        if (g_a is None and g_b is None) or not any(need_planes + need_coords):
            return none
        device = planes[0][1]
        cuda = device.type == "cuda"
        coord_grads = [None] * P
        if any(need_coords):
            grads = [torch.zeros(shape, dtype=torch.float32, device=device)
                     for shape, _ in planes]
            both = (cuda_kernels.bilinear_gather_planes_backward_coords if cuda
                    else grid_sample_planes_backward_coords_plain)
            cg = both(values, coords, g_a, g_b, grads, c0, split)
            coord_grads = [cg[..., i, :] if need else None for i, need in enumerate(need_coords)]
        else:
            scatter = (cuda_kernels.bilinear_gather_2d_backward if cuda
                       else grid_sample_2d_backward_plain)
            grads = [None] * P
            for i, (shape, _) in enumerate(planes):
                if need_planes[i]:
                    grads[i] = torch.zeros(shape, dtype=torch.float32, device=device)
                    for g, off in ((g_a, c0), (g_b, c0 + split)):
                        if g is not None:
                            scatter(g[..., i, :], coords[i], grads[i], off)
        grads = [g if need else None for g, need in zip(grads, need_planes)]
        return (None, None, None, None, *grads, *coord_grads)


def grid_sample_planes(
    planes, coords, channels: slice = slice(None), split: int | None = None,
    dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Bilinear samples of channels ``channels`` of up to three (H_p, W_p, C)
    planes, each of its own shape and at its own (..., 2) coords in [-1, 1], split
    into two outputs: ``out_a`` (..., P, split) and ``out_b`` (..., P,
    C - split), or ``out_a`` (..., P, C) and None without a split.

    ``out_a[..., i, :]`` is ``grid_sample_2d(planes[i], coords[i],
    channels)[..., :split]``. For the tri-plane's density (0:24) and
    appearance (24:96) channels, viewed as (..., 72) and (..., 216), the two
    outputs are the decoders' inputs in the order of a ``torch.cat`` of the
    three planes. CUDA planes launch the ``bilinear_gather_planes`` kernel
    once (or raise) and, in the backward, ``bilinear_gather_2d_backward``
    once per plane and output, or, where coordinates need a gradient (the
    gauge variant's deformed coordinates),
    ``bilinear_gather_planes_backward_coords`` once for both gradients of
    every plane; CPU planes take the plain versions.

    ``dtype`` (bfloat16 training) fetches the planes' values in that dtype:
    the planes are cast inside the fetch, the outputs come in ``dtype``, and
    the plane gradients come back in the planes' own float32, summed in
    float32 from the cotangents as they come (bfloat16 on that path).
    """
    planes, coords = tuple(planes), tuple(coords)
    device = planes[0].device
    if any(t.device != device for t in planes + coords):
        raise ValueError(f"planes and coords on {[str(t.device) for t in planes + coords]}")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"grid_sample_planes runs on cuda or cpu, not {device}")
    c0, c1, step = channels.indices(planes[0].shape[-1])
    if step != 1 or c1 <= c0:
        raise ValueError(f"channels must be a non-empty contiguous slice, got {channels}")
    if split is not None and not 0 < split < c1 - c0:
        raise ValueError(f"split {split} outside 1..{c1 - c0 - 1}")
    return _BilinearGatherPlanes.apply(c0, c1, split, dtype, *planes, *coords)


def grid_sample_2d(
    plane: torch.Tensor, coords: torch.Tensor, channels: slice = slice(None)
) -> torch.Tensor:
    """Bilinear sample of channels ``channels`` of an (H, W, C) plane at
    (..., 2) coords in [-1, 1] (`ngf_tpu/ops/grid_sample.py:216-253`): the
    one-plane call of :func:`grid_sample_planes`.

    Equivalent to ``F.grid_sample(plane[..., channels].permute(2, 0, 1)[None],
    coords.view(1, -1, 1, 2), align_corners=True)``. A CUDA plane launches
    the ``bilinear_gather_2d`` kernel (or raises) and, in the backward,
    ``bilinear_gather_2d_backward``; a CPU plane takes the plain versions.
    """
    return grid_sample_planes((plane,), (coords,), channels)[0].squeeze(-2)


def grid_sample_3d(volume: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of a (D, H, W, C) volume at (..., 3) coords in [-1, 1]
    (`ngf_tpu/ops/grid_sample.py:559-613`): torch 5D ``grid_sample`` with
    align_corners=True and zero padding; coords[..., 0] -> W, 1 -> H, 2 -> D.

    The plain trilinear reference. No path runs it: every consumer of the
    occupancy volume tests the result ``> 0`` and calls
    :func:`occupancy_lookup` (the K3 kernel on the card) instead.
    """
    D, H, W, C = volume.shape
    flat = volume.reshape(D * H * W, C)
    x = _unnormalize(coords[..., 0], W)
    y = _unnormalize(coords[..., 1], H)
    z = _unnormalize(coords[..., 2], D)
    x0, y0, z0 = (torch.floor(v).long() for v in (x, y, z))
    wx1, wy1, wz1 = x - torch.floor(x), y - torch.floor(y), z - torch.floor(z)

    out = None
    for dz in (0, 1):
        wz = wz1 if dz else (1.0 - wz1)
        zi = z0 + dz
        for dy in (0, 1):
            wy = wy1 if dy else (1.0 - wy1)
            yi = y0 + dy
            for dx in (0, 1):
                wx = wx1 if dx else (1.0 - wx1)
                xi = x0 + dx
                inb = (
                    (xi >= 0) & (xi <= W - 1)
                    & (yi >= 0) & (yi <= H - 1)
                    & (zi >= 0) & (zi <= D - 1)
                )
                idx = (
                    zi.clamp(0, D - 1) * (H * W)
                    + yi.clamp(0, H - 1) * W
                    + xi.clamp(0, W - 1)
                )
                w = wx * wy * wz * inb.to(wx.dtype)
                tap = flat[idx] * w[..., None]
                out = tap if out is None else out + tap
    return out


def normalize_coord(xyz: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """Map AABB coords to [-1, 1] (`InfoInv/models/FieldBase.py:88-89`)."""
    inv_size = 2.0 / (aabb[1] - aabb[0])
    return (xyz - aabb[0]) * inv_size - 1.0


def _lookup_axis(c: torch.Tensor, size: int):
    """Per-axis (c0, frac) of the occupancy lookup: the unnormalised
    coordinate, clamped to [-2, size+1] with NaN sent to -2 (both leave
    every tap of the axis outside, as they are without the clamp), its floor
    as an integer and its fraction."""
    c = _unnormalize(c, size)
    c = torch.where(c >= -2.0, c, torch.full_like(c, -2.0)).clamp(max=size + 1.0)
    c0f = torch.floor(c)
    return c0f.long(), c - c0f


def occupancy_lookup_plain(
    volume: torch.Tensor, points: torch.Tensor, aabb: torch.Tensor | None = None
) -> torch.Tensor:
    """Plain PyTorch version of the ``occupancy_lookup`` kernel (K3).

    ``grid_sample_3d(volume[..., None], coords)[..., 0] > 0`` for a volume of
    non-negative values, computed as the kernel computes it: a point is
    occupied iff one of its eight trilinear taps lies inside the volume, has
    a value > 0 and a weight ``wx * wy * wz > 0`` (the float32 products of
    `grid_sample_3d`, in its order).

    Args:
      volume: (D, H, W) occupancy, z-major (any dtype; uint8 on the path).
      points: (..., 3) float32; with ``aabb`` world points, normalised with
        :func:`normalize_coord`, else coordinates in [-1, 1] (x -> W).
      aabb: optional (2, 3) float32 box of the volume.

    Returns:
      (...) bool.
    """
    D, H, W = volume.shape
    coords = points.float() if aabb is None else normalize_coord(points.float(), aabb)
    x0, fx = _lookup_axis(coords[..., 0], W)
    y0, fy = _lookup_axis(coords[..., 1], H)
    z0, fz = _lookup_axis(coords[..., 2], D)
    flat = volume.reshape(-1) > 0
    hit = torch.zeros(coords.shape[:-1], dtype=torch.bool, device=coords.device)
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


def occupancy_lookup(
    volume: torch.Tensor, points: torch.Tensor, aabb: torch.Tensor | None = None
) -> torch.Tensor:
    """Occupancy of (..., 3) points in a z-major (D, H, W) uint8 volume with
    the semantics of ``grid_sample_3d(...) > 0`` (`ngf_tpu/render/volume.py:42-54`,
    the trilinear lookup every occupancy consumer tests ``> 0``). A CUDA
    volume launches the ``occupancy_lookup`` kernel (K3) once, which reads
    strided point views as they are; a CPU volume takes
    :func:`occupancy_lookup_plain`. There is no fallback between the two.
    Returns (...) bool."""
    if volume.is_cuda:
        return cuda_kernels.occupancy_lookup(volume, points, aabb)
    if volume.device.type != "cpu" or points.device != volume.device:
        raise ValueError(f"occupancy_lookup on {volume.device} with points on {points.device}")
    return occupancy_lookup_plain(volume, points, aabb)


def resize_bilinear_2d(plane: torch.Tensor, new_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an (H, W, C) plane to ``new_hw`` with
    align_corners=True (`ngf_tpu/ops/grid_sample.py:651-675`): the library's
    ``F.interpolate`` on the (1, C, H, W) view, as
    `TriPlane/models/Field.py:110-112` calls it, returned channels-last and
    contiguous."""
    out = F.interpolate(plane.permute(2, 0, 1)[None], size=tuple(new_hw), mode="bilinear",
                        align_corners=True)
    return out[0].permute(1, 2, 0).contiguous()


def grid_sample_2d_border(plane: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of an (H, W, C) plane with ``align_corners=False``
    and border padding (`ngf_tpu/ops/grid_sample.py:616-648`): coordinate c
    maps to pixel ((c + 1) * size - 1) / 2, taps outside clamp to the edge;
    ``coords[..., 0]`` indexes W, ``coords[..., 1]`` H. Returns (..., C).
    ``F.grid_sample`` (ROADMAP.md queue 2 item 3: a library call)."""
    H, W, C = plane.shape
    lead = coords.shape[:-1]
    img = plane.permute(2, 0, 1)[None].to(coords.dtype)
    grid = coords.reshape(1, 1, -1, 2)
    out = F.grid_sample(img, grid, mode="bilinear", padding_mode="border", align_corners=False)
    return out[0, :, 0].t().reshape(*lead, C)


def max_pool_3d(volume: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """3D max pool of a (D, H, W) volume, stride 1, 'same' padding of
    ``kernel // 2`` (`ngf_tpu/ops/grid_sample.py:678-695`): the library's
    ``F.max_pool3d``, as `InfoInv/models/FieldBase.py:188` calls it."""
    return F.max_pool3d(volume[None, None], kernel, stride=1, padding=kernel // 2)[0, 0]
