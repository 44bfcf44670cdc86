"""Bilinear and trilinear grid sampling with torch ``F.grid_sample`` semantics.

Port of `ngf_tpu/ops/grid_sample.py`: ``align_corners=True`` (coordinate -1
hits the center of the first texel, +1 the center of the last), zero
padding, and torch's coordinate order (``coords[..., 0]`` indexes the W axis,
``coords[..., 1]`` H, ``coords[..., 2]`` D). Planes are channels-last (H, W, C)
and volumes (D, H, W, C), as in the JAX package.

``grid_sample_2d`` is the hot op of every tri-plane fetch. On a CUDA tensor it
launches the hand-written kernel ``bilinear_gather_2d``
(`ngf_tpu_torch/ops/cuda_kernels.py`) and, for the plane gradient, its
backward ``bilinear_gather_2d_backward``; on a CPU tensor it runs the plain
versions below. There is no fallback between the two.

A fetch names its channels of the whole plane (``channels``), so its
gradient lands in those channels of the whole plane's gradient: no slice is
copied either way. Within one forward pass, the fetches of a plane wrapped
by :func:`share_plane_grad` add into one gradient buffer.
"""

from __future__ import annotations

import torch

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
      g: (..., C) gradient of the gather's output.
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


class _PlaneGradSlot:
    """The one float32 gradient buffer that every fetch of one plane in one
    forward pass adds into."""

    def __init__(self) -> None:
        self.buf: torch.Tensor | None = None

    def buffer(self, shape, device) -> torch.Tensor:
        if self.buf is None:
            self.buf = torch.zeros(shape, dtype=torch.float32, device=device)
        return self.buf


class _PlaneGradSink(torch.autograd.Function):
    """Identity on a plane. Its backward runs after the backward of every
    fetch of its output (autograd runs a node once all its consumers are
    done) and hands on the buffer they filled, plus any other gradient."""

    @staticmethod
    def forward(ctx, plane, slot):
        ctx.slot = slot
        ctx.set_materialize_grads(False)
        return plane.view_as(plane)

    @staticmethod
    def backward(ctx, g):
        buf, ctx.slot.buf = ctx.slot.buf, None
        if g is not None:
            buf = g if buf is None else buf.add_(g)
        return buf, None


def share_plane_grad(plane: torch.Tensor) -> torch.Tensor:
    """The plane, as a tensor whose fetches (:func:`grid_sample_2d`) within
    one forward pass all add into one gradient buffer: the density (0:24)
    and appearance (24:96) fetches of a tri-plane write their channels of
    the same (H, W, C) float32 buffer, with no copy and no sum of two
    buffers. Call it once per plane and forward pass."""
    slot = _PlaneGradSlot()
    out = _PlaneGradSink.apply(plane, slot)
    out._grad_slot = slot
    return out


class _BilinearGather(torch.autograd.Function):
    """``grid_sample_2d`` of channels ``c0:c1`` with the plane gradient by
    the backward kernel (CUDA) or its plain version (CPU). No coordinate
    gradient: :func:`grid_sample_2d` routes coordinates that need one."""

    @staticmethod
    def forward(ctx, plane, coords, c0, c1, slot):
        view = plane[..., c0:c1]
        out = cuda_kernels.bilinear_gather_2d(view, coords) if plane.is_cuda else grid_sample_2d_plain(view, coords)
        ctx.save_for_backward(coords)
        ctx.plane_meta = (plane.shape, plane.dtype, plane.device, c0, slot)
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, g):
        if g is None or not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        (coords,) = ctx.saved_tensors
        shape, dtype, device, c0, slot = ctx.plane_meta
        grad = slot.buffer(shape, device) if slot is not None else torch.zeros(
            shape, dtype=torch.float32, device=device
        )
        if device.type == "cuda":
            if dtype != torch.float32:
                raise NotImplementedError(
                    f"the plane gradient of a {dtype} plane is not ported: see ROADMAP.md "
                    "queue 1, 'bfloat16 training'"
                )
            cuda_kernels.bilinear_gather_2d_backward(g, coords, grad, c0)
        else:
            grid_sample_2d_backward_plain(g, coords, grad, c0)
        return (None if slot is not None else grad), None, None, None, None


def grid_sample_2d(
    plane: torch.Tensor, coords: torch.Tensor, channels: slice = slice(None)
) -> torch.Tensor:
    """Bilinear sample of channels ``channels`` of an (H, W, C) plane at
    (..., 2) coords in [-1, 1] (`ngf_tpu/ops/grid_sample.py:216-253`).

    Equivalent to ``F.grid_sample(plane[..., channels].permute(2, 0, 1)[None],
    coords.view(1, -1, 1, 2), align_corners=True)``. A CUDA plane launches
    the ``bilinear_gather_2d`` kernel (or raises) and, in the backward,
    ``bilinear_gather_2d_backward``; a CPU plane takes the plain versions.
    Coordinates that need a gradient (the gauge variant) take the plain
    version with autograd on the CPU and raise on the card: the kernel has
    no coordinate gradient yet (ROADMAP.md queue 1, item 3).
    """
    if plane.device != coords.device:
        raise ValueError(f"plane on {plane.device} but coords on {coords.device}")
    if plane.device.type not in ("cuda", "cpu"):
        raise ValueError(f"grid_sample_2d runs on cuda or cpu, not {plane.device}")
    c0, c1, step = channels.indices(plane.shape[-1])
    if step != 1 or c1 <= c0:
        raise ValueError(f"channels must be a non-empty contiguous slice, got {channels}")
    if coords.requires_grad and torch.is_grad_enabled():
        if plane.is_cuda:
            raise NotImplementedError(
                "coordinate gradients of the CUDA gather are not ported: see ROADMAP.md "
                "queue 1, item 3, 'Gauge training'"
            )
        return grid_sample_2d_plain(plane[..., c0:c1], coords)
    return _BilinearGather.apply(plane, coords, c0, c1, getattr(plane, "_grad_slot", None))


def grid_sample_3d(volume: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of a (D, H, W, C) volume at (..., 3) coords in [-1, 1]
    (`ngf_tpu/ops/grid_sample.py:559-613`): torch 5D ``grid_sample`` with
    align_corners=True and zero padding; coords[..., 0] -> W, 1 -> H, 2 -> D.

    Plain PyTorch: its only consumer is the occupancy lookup of checkpoints
    that carry a mask, which tests the result ``> 0``.
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
