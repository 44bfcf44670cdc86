"""Build, load and launch the port's hand-written CUDA kernels.

The sources live in ``ngf_tpu_torch/ops/kernels/``. On first use each one is
compiled with ``nvcc`` for ``sm_90a`` (Hopper) into a shared library with a
plain C interface under ``ngf_tpu_torch/_build/`` and loaded with
``ctypes``; a source's library is named by a hash of its text and of the
headers beside it, so an edited source or header is rebuilt. Nothing is
compiled or loaded when this module is imported: the CPU tests import it on
machines without ``nvcc`` or a card.

Every wrapper launches its kernel on PyTorch's current stream, raises on an
input the kernel does not take and on a refused launch, and counts its
launches in a plain integer attribute (``bilinear_gather_2d.launches``) so
that a run can show which path its work took. The launch path is lean, since
a small kernel's call costs more host time than device time: no lock once a
library is loaded, no device switch when the tensor's device is current, the
raw stream handle instead of a stream object (:func:`_launch`).

Kernels: ``bilinear_gather_planes`` (K1, the tri-plane fetch: up to three
planes of any shapes in one launch, split into the two decoders' inputs)
with its one-plane call ``bilinear_gather_2d``, ``bilinear_gather_2d_backward``
(K2, its plane gradient), ``bilinear_gather_planes_backward_coords`` (K2c,
the plane and the coordinate gradients of a fetch of up to three planes in
one launch, for the learned gauge's deformed coordinates), each in float32
and in bfloat16 (values and cotangents; the gradients stay float32),
``gather_rows``
(the trainer's batch assembly, and the top-K renderers' group gather) with
its backward ``scatter_rows``,
``occupancy_lookup`` (K3, the alpha-mask test of point clouds) and
``group_sample_compact`` (K4, the grouped renderer's whole front end:
sampling, occupancy test and per-ray compaction in one launch), and
``ray_march`` / ``ray_march_backward`` (K5, the NeuTex compositing scan with
its background and tone map, and its reverse-scan gradient) with K5's
tri-plane mode ``ray_march_triplane`` / ``ray_march_triplane_backward`` (the
tri-plane renderers' composite: weights, shading mask, colour with its
background and clip, acc and depth) and its shard mode
``ray_march_triplane_totals`` / ``ray_march_triplane_shard`` /
``ray_march_triplane_shard_backward`` (the sample-parallel renderer's
composite of one shard of a ray's samples, from a starting transmittance)
and its top-K mode ``ray_march_triplane_topk`` /
``ray_march_triplane_topk_backward`` (the colour of the K shaded samples a
ray, after ``ray_march_triplane`` without rgb has written the weights; its
backward hands the weights' cotangent to ``ray_march_triplane_backward``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

KERNEL_DIR = Path(__file__).resolve().parent / "kernels"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
]

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        shutil.which("nvcc"),
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build(name: str) -> Path:
    """Compile ``kernels/<name>.cu`` into ``_build/`` unless it is built.

    Returns the library path. The build writes to a temporary name and
    renames it into place, so concurrent builders never load a half-written
    library.
    """
    src = KERNEL_DIR / f"{name}.cu"
    text = src.read_bytes() + b"".join(h.read_bytes() for h in sorted(KERNEL_DIR.glob("*.cuh")))
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"lib{name}-{digest[:12]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {src} ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


def _lib(name: str) -> ctypes.CDLL:
    """The library of ``kernels/<name>.cu``: built and loaded under the lock
    on first use, a dict lookup after."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            if name not in _libs:
                lib = ctypes.CDLL(str(build(name)))
                _declare(name, lib)
                _libs[name] = lib
            lib = _libs[name]
    return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ngf_cuda_error_string.argtypes = [i32]
    lib.ngf_cuda_error_string.restype = ctypes.c_char_p
    if name == "bilinear_gather":
        lib.ngf_bilinear_gather_planes.argtypes = [
            ctypes.POINTER(i64), i32, i32, i32, vp, vp, i64, i32, i32, vp,
        ]
        lib.ngf_bilinear_gather_planes.restype = i32
    elif name == "bilinear_gather_backward":
        lib.ngf_bilinear_gather_2d_backward.argtypes = [
            vp, i64, i32, vp, i64, i64, vp, i32, i32, i64, i64, i32, i32, vp,
        ]
        lib.ngf_bilinear_gather_2d_backward.restype = i32
        lib.ngf_bilinear_gather_planes_backward_coords.argtypes = [
            ctypes.POINTER(i64), i32, vp, i64, i64, i32, vp, i64, i64, i32, i64, vp, i32, i32, vp,
        ]
        lib.ngf_bilinear_gather_planes_backward_coords.restype = i32
        lib.ngf_bilinear_gather_planes_backward_coords_footprint.argtypes = [
            i32, i32, ctypes.POINTER(i32),
        ]
        lib.ngf_bilinear_gather_planes_backward_coords_footprint.restype = i32
    elif name == "gather_rows":
        lib.ngf_gather_rows.argtypes = [vp, i64, i32, i64, i32, vp, i32, i64, i64, i64, vp, vp]
        lib.ngf_gather_rows.restype = i32
        lib.ngf_scatter_rows.argtypes = [vp, i64, i32, i32, vp, i32, i64, i64, i64, vp, vp]
        lib.ngf_scatter_rows.restype = i32
        lib.ngf_rows_lane_bytes.argtypes = [vp, vp, i64, i64, i32]
        lib.ngf_rows_lane_bytes.restype = i32
        lib.ngf_scatter_rows_route.argtypes = [i64, i64]
        lib.ngf_scatter_rows_route.restype = i32
        lib.ngf_rows_footprint.argtypes = [i32, i32, i32, ctypes.POINTER(i32)]
        lib.ngf_rows_footprint.restype = i32
    elif name == "occupancy_lookup":
        lib.ngf_occupancy_lookup.argtypes = [
            vp, i64, i64, i64, i64, i64, i32, vp, vp, i32, i32, i32, vp, vp,
        ]
        lib.ngf_occupancy_lookup.restype = i32
    elif name == "group_compact":
        f32 = ctypes.c_float
        lib.ngf_group_sample_compact.argtypes = [
            vp, i64, vp, i64, vp, f32, f32, f32, i32, i32, i32, i32, vp, i32, i32, i32, vp,
            vp, vp, vp, vp, vp, vp,
        ]
        lib.ngf_group_sample_compact.restype = i32
    elif name == "ray_march":
        common = [i64, i32, vp, i64, i64, vp, i64, i64, vp, i64, i64, vp, i64, i64, i64, vp, i64]
        lib.ngf_ray_march_forward.argtypes = common + [vp, vp, vp, vp]
        lib.ngf_ray_march_forward.restype = i32
        lib.ngf_ray_march_backward.argtypes = common + [vp, vp, vp, vp, vp, vp]
        lib.ngf_ray_march_backward.restype = i32
        f32 = ctypes.c_float
        tri = [i64, i32, vp, i64, i64, vp, i64, i64, f32, vp, i64, i64, i64]
        lib.ngf_ray_march_triplane_forward.argtypes = tri + [
            vp, i64, i64, vp, i64, vp, f32, f32, vp, vp, vp, vp, vp, vp,
        ]
        lib.ngf_ray_march_triplane_forward.restype = i32
        lib.ngf_ray_march_triplane_backward.argtypes = tri + [
            vp, f32, f32, vp, vp, vp, vp, vp, vp, vp,
        ]
        lib.ngf_ray_march_triplane_backward.restype = i32
        topk = [i64, i32, i32, i32, vp, vp, i64, i64, vp, i64, i64, i64]
        lib.ngf_ray_march_topk_forward.argtypes = topk + [vp, vp, f32, f32, vp, vp, vp]
        lib.ngf_ray_march_topk_forward.restype = i32
        lib.ngf_ray_march_topk_backward.argtypes = topk + [vp, f32, f32, vp, vp, vp, vp, vp, vp]
        lib.ngf_ray_march_topk_backward.restype = i32
        lib.ngf_ray_march_triplane_totals.argtypes = tri[:9] + [vp, vp]
        lib.ngf_ray_march_triplane_totals.restype = i32
        lib.ngf_ray_march_triplane_shard_forward.argtypes = tri + [
            vp, i64, i64, vp, f32, vp, vp, vp, vp, vp, vp,
        ]
        lib.ngf_ray_march_triplane_shard_forward.restype = i32
        lib.ngf_ray_march_triplane_shard_backward.argtypes = tri + [
            vp, f32, vp, vp, vp, vp, vp, vp, vp,
        ]
        lib.ngf_ray_march_triplane_shard_backward.restype = i32
        lib.ngf_ray_march_max_samples.argtypes = []
        lib.ngf_ray_march_max_samples.restype = i32
        lib.ngf_ray_march_footprint.argtypes = [i32, i32, ctypes.POINTER(i32)]
        lib.ngf_ray_march_footprint.restype = i32


def build_all() -> float:
    """Build every kernel of the port, one ``nvcc`` per source all started
    together, then load them; returns the seconds taken."""
    t0 = time.perf_counter()
    names = [src.stem for src in sorted(KERNEL_DIR.glob("*.cu"))]
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        for fut in [pool.submit(build, n) for n in names]:
            fut.result()
    for name in names:
        _lib(name)
    return time.perf_counter() - t0


def _launch(lib: ctypes.CDLL, entry, device: int, what: str, *args) -> None:
    """Call the C entry point ``entry(*args, stream)`` with the raw handle of
    PyTorch's current stream on ``device``, switching the current device only
    when it is another; raise on a refused launch."""
    if device == torch._C._cuda_getDevice():
        code = entry(*args, torch._C._cuda_getCurrentRawStream(device))
    else:
        with torch.cuda.device(device):
            code = entry(*args, torch._C._cuda_getCurrentRawStream(device))
    if code:
        msg = lib.ngf_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch: CUDA error {code} ({msg})")


def _on_one_device(*tensors: torch.Tensor) -> bool:
    return all(t.is_cuda for t in tensors) and len({t.get_device() for t in tensors}) == 1


_GATHER_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GATHER_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}


def _check_plane(plane: torch.Tensor, what: str) -> None:
    H, W, _ = plane.shape
    if H < 2 or W < 2:
        raise ValueError(f"{what} must be at least 2x2, got {H}x{W}")
    if plane.stride(2) != 1 or plane.stride(0) != W * plane.stride(1):
        raise ValueError(f"unsupported {what} strides {plane.stride()} for {tuple(plane.shape)}")


def gather_lanes(dtype: torch.dtype, C: int, split: int, texel_strides, ptrs) -> int:
    """Channels per load and store of the gather kernel: 16 bytes' worth (4
    float32 or 8 bfloat16) when every such access is 16-byte aligned — C,
    the split and each plane's texel stride multiples of it, every plane
    pointer (offset to its first fetched channel) and output pointer of 16
    bytes — and 1 (scalar) otherwise."""
    v = 16 // _GATHER_ITEMSIZE[dtype]
    if C % v or split % v or any(t % v for t in texel_strides) or any(p % 16 for p in ptrs):
        return 1
    return v


def _gather(planes, flats, c0: int, C: int, split: int, out_a, out_b, what: str) -> None:
    """Launch the gather kernel on checked planes, each of its own (H, W),
    and (N, 2) coordinates."""
    itemsize = planes[0].element_size()
    plane_ptrs = [p.data_ptr() + itemsize * c0 for p in planes]
    desc = []
    for plane, ptr, flat in zip(planes, plane_ptrs, flats):
        H, W, _ = plane.shape
        desc += [ptr, plane.stride(1), flat.data_ptr(), flat.stride(0), flat.stride(1), H, W]
    out_ptrs = [out_a.data_ptr()] + ([out_b.data_ptr()] if out_b is not None else [])
    lanes = gather_lanes(planes[0].dtype, C, split, [p.stride(1) for p in planes],
                         plane_ptrs + out_ptrs)
    lib = _lib("bilinear_gather")
    _launch(
        lib, lib.ngf_bilinear_gather_planes, planes[0].get_device(), what,
        (ctypes.c_longlong * len(desc))(*desc), len(planes), C, split,
        out_ptrs[0], out_ptrs[1] if out_b is not None else None, flats[0].shape[0],
        _GATHER_DTYPES[planes[0].dtype], lanes,
    )


def _check_gather_plane(plane: torch.Tensor, what: str) -> None:
    if plane.dim() != 3 or plane.dtype not in _GATHER_DTYPES:
        raise ValueError(
            f"{what} must be (H, W, C) float32/bfloat16, got {tuple(plane.shape)} {plane.dtype}"
        )
    _check_plane(plane, what)
    H, W, _ = plane.shape
    if H * W >= 2**31:
        raise ValueError(f"{what} of {H}x{W} texels: the kernel indexes texels in 32 bits")


def _check_coords(coords: torch.Tensor) -> None:
    if coords.dtype != torch.float32 or coords.shape[-1] != 2:
        raise ValueError(
            f"coords must be (..., 2) float32, got {tuple(coords.shape)} {coords.dtype}"
        )


def bilinear_gather_2d(plane: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """CUDA kernel for ``grid_sample_2d`` (``kernels/bilinear_gather.cu``):
    the one-plane, unsplit call of :func:`bilinear_gather_planes`' kernel.

    Args:
      plane: (H, W, C) float32 or bfloat16 CUDA tensor, H, W >= 2, channels
        contiguous and rows ``W`` texels apart — a channel slice
        ``plane[..., a:b]`` of a wider contiguous plane qualifies as it is.
      coords: (..., 2) float32 CUDA tensor on the same device.

    Returns:
      (..., C) in the plane's dtype.
    """
    if not _on_one_device(plane, coords):
        raise ValueError(
            f"bilinear_gather_2d needs plane and coords on one CUDA device, got "
            f"{plane.device} and {coords.device}"
        )
    _check_gather_plane(plane, "plane")
    _check_coords(coords)
    C = plane.shape[-1]
    batch_shape = coords.shape[:-1]
    flat = coords.reshape(-1, 2)
    out = plane.new_empty((flat.shape[0], C))
    if flat.shape[0] == 0 or C == 0:
        return out.reshape(*batch_shape, C)
    _gather([plane], [flat], 0, C, C, out, None, "bilinear_gather_2d")
    bilinear_gather_2d.launches += 1
    return out.reshape(*batch_shape, C)


bilinear_gather_2d.launches = 0


def bilinear_gather_planes(
    planes, coords, channels: slice = slice(None), split: int | None = None
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """CUDA kernel for ``grid_sample_2d`` of channels ``channels`` of up to
    three planes in one launch, split into two outputs
    (``kernels/bilinear_gather.cu``).

    Args:
      planes: 1 to 3 (H_p, W_p, C_total) float32 or bfloat16 CUDA tensors of
        one channel count and dtype, each of its own H_p, W_p >= 2 (the
        gauge variant's planes after its shrink and upsample), channels
        contiguous and rows ``W_p`` texels apart.
      coords: as many (..., 2) float32 CUDA tensors of one shape, the
        coordinates of each plane; strided views qualify as they are.
      channels: the contiguous channel range c0:c1 fetched from each plane.
      split: channels c0:c0+split go to the first output and the rest to the
        second; None keeps all C = c1 - c0 in the first.

    Returns:
      (out_a (..., P, split), out_b (..., P, C - split)) in the planes' dtype,
      out_b None without a split.
    """
    planes, coords = tuple(planes), tuple(coords)
    P = len(planes)
    if not 1 <= P <= 3 or len(coords) != P:
        raise ValueError(f"bilinear_gather_planes takes 1 to 3 planes and as many coords, "
                         f"got {P} and {len(coords)}")
    if not _on_one_device(*planes, *coords):
        raise ValueError(
            "bilinear_gather_planes needs planes and coords on one CUDA device, got "
            f"{[str(t.device) for t in planes + coords]}"
        )
    for plane in planes:
        _check_gather_plane(plane, "plane")
        if plane.shape[-1] != planes[0].shape[-1] or plane.dtype != planes[0].dtype:
            raise ValueError(f"planes differ in channels or dtype: "
                             f"{[(tuple(p.shape), p.dtype) for p in planes]}")
    for c in coords:
        _check_coords(c)
        if c.shape != coords[0].shape:
            raise ValueError(f"coords differ in shape: {[tuple(c.shape) for c in coords]}")
    c0, c1, step = channels.indices(planes[0].shape[-1])
    C = c1 - c0
    if step != 1 or C <= 0:
        raise ValueError(f"channels must be a non-empty contiguous slice, got {channels}")
    if split is not None and not 0 < split < C:
        raise ValueError(f"split {split} outside 1..{C - 1}")
    s = C if split is None else split
    batch_shape = coords[0].shape[:-1]
    flats = [c.reshape(-1, 2) for c in coords]
    n = flats[0].shape[0]
    out_a = planes[0].new_empty((n, P, s))
    out_b = planes[0].new_empty((n, P, C - s)) if s < C else None
    if n > 0:
        _gather(planes, flats, c0, C, s, out_a, out_b, "bilinear_gather_planes")
        bilinear_gather_planes.launches += 1
    return (out_a.reshape(*batch_shape, P, s),
            None if out_b is None else out_b.reshape(*batch_shape, P, C - s))


bilinear_gather_planes.launches = 0


def backward_lanes(C: int, channel_offset: int, texel_stride: int, g_stride: int,
                   g_ptr: int, dst_ptr: int, dtype: torch.dtype = torch.float32) -> int:
    """Channels per load of the backward kernel: 4 (one load of 16 bytes of
    float32 g or 8 of bfloat16, added with float4 atomics) when every such
    access is aligned — C, g's row stride (in g's elements), the channel
    offset and the gradient's texel stride multiples of 4, g's base pointer
    of a load's bytes and the gradient's of 16 — and 1 (scalar) otherwise."""
    if (C % 4 or g_stride % 4 or channel_offset % 4 or texel_stride % 4
            or g_ptr % (4 * _GATHER_ITEMSIZE[dtype]) or dst_ptr % 16):
        return 1
    return 4


def bilinear_gather_2d_backward(
    g: torch.Tensor, coords: torch.Tensor, grad_plane: torch.Tensor, channel_offset: int = 0
) -> None:
    """CUDA kernel for the plane gradient of ``grid_sample_2d``
    (``kernels/bilinear_gather_backward.cu``): adds, in place, the gradient
    of a gather of channels ``channel_offset : channel_offset + C`` into
    those channels of ``grad_plane``.

    Args:
      g: (..., C) float32 or bfloat16 CUDA tensor, the gradient of the
        gather's output, read as it is (a bfloat16 cotangent is widened in
        the kernel; the sums and the gradient stay float32).
      coords: (..., 2) float32 CUDA tensor, the gather's coordinates.
      grad_plane: (H, W, C_total) float32 CUDA tensor, channels contiguous
        and rows ``W`` texels apart: the whole plane's gradient.
      channel_offset: first channel of the gather within the plane.
    """
    if not _on_one_device(g, coords, grad_plane):
        raise ValueError(
            "bilinear_gather_2d_backward needs g, coords and grad_plane on one CUDA "
            f"device, got {[str(t.device) for t in (g, coords, grad_plane)]}"
        )
    if grad_plane.dim() != 3 or grad_plane.dtype != torch.float32:
        raise ValueError(
            f"grad_plane must be (H, W, C) float32, got {tuple(grad_plane.shape)} {grad_plane.dtype}"
        )
    _check_plane(grad_plane, "grad_plane")
    H, W, c_total = grad_plane.shape
    if H * W >= 2**31:
        raise ValueError(f"grad_plane of {H}x{W} texels: the kernel indexes texels in 32 bits")
    C = g.shape[-1]
    if not 0 <= channel_offset <= c_total - C:
        raise ValueError(f"channels {channel_offset}:{channel_offset + C} outside 0:{c_total}")
    if coords.dtype != torch.float32 or coords.shape[-1] != 2:
        raise ValueError(f"coords must be (..., 2) float32, got {tuple(coords.shape)} {coords.dtype}")
    if g.dtype not in _GATHER_DTYPES or g.shape[:-1] != coords.shape[:-1]:
        raise ValueError(f"g must be float32 or bfloat16 of shape {(*coords.shape[:-1], C)}, "
                         f"got {tuple(g.shape)} {g.dtype}")
    flat_c = coords.reshape(-1, 2)
    flat_g = g.reshape(-1, C)
    if flat_g.stride(1) != 1:
        flat_g = flat_g.contiguous()
    n = flat_c.shape[0]
    if n == 0 or C == 0:
        return
    texel_stride = grad_plane.stride(1)
    dst = grad_plane.data_ptr() + 4 * channel_offset
    lanes = backward_lanes(C, channel_offset, texel_stride, flat_g.stride(0),
                           flat_g.data_ptr(), dst, g.dtype)
    lib = _lib("bilinear_gather_backward")
    _launch(
        lib, lib.ngf_bilinear_gather_2d_backward, grad_plane.get_device(),
        "bilinear_gather_2d_backward",
        flat_g.data_ptr(), flat_g.stride(0), C,
        flat_c.data_ptr(), flat_c.stride(0), flat_c.stride(1),
        dst, H, W, texel_stride, n, lanes, _GATHER_DTYPES[g.dtype],
    )
    bilinear_gather_2d_backward.launches += 1


bilinear_gather_2d_backward.launches = 0


def _check_cotangent(g: torch.Tensor, batch_shape, P: int, dtype: torch.dtype,
                     what: str) -> torch.Tensor:
    """``g`` (..., P, C) of the planes' ``dtype`` as (N, P, C) with
    contiguous channels."""
    if g.dtype != dtype or g.dim() < 2 or g.shape[:-1] != (*batch_shape, P):
        raise ValueError(
            f"{what} must be {dtype} (the planes' dtype) of shape "
            f"{(*batch_shape, P, g.shape[-1])}, got {tuple(g.shape)} {g.dtype}"
        )
    flat = g.reshape(-1, P, g.shape[-1])
    return flat if flat.stride(2) == 1 else flat.contiguous()


def bilinear_gather_planes_backward_coords(
    planes,
    coords,
    g_a: torch.Tensor | None,
    g_b: torch.Tensor | None,
    grads,
    channel_offset: int = 0,
    split: int | None = None,
) -> torch.Tensor:
    """CUDA kernel K2c (``kernels/bilinear_gather_backward.cu``): the plane
    and the coordinate gradients of a fetch of channels ``channel_offset :
    channel_offset + C`` of up to three planes (:func:`bilinear_gather_planes`),
    in one launch. Adds each plane's gradient into those channels of its
    ``grads`` buffer and returns the coordinates' gradients.

    Args:
      planes: 1 to 3 (H_p, W_p, C_total) CUDA tensors of one channel count
        and dtype, float32 or bfloat16, the fetched planes' values, each of
        its own H_p, W_p >= 2, channels contiguous and rows ``W_p`` texels
        apart.
      coords: as many (..., 2) float32 CUDA tensors of one shape, each
        plane's coordinates; strided views qualify as they are.
      g_a, g_b: the gradients of the fetch's two outputs as
        :func:`bilinear_gather_planes` returns them, in the planes' dtype,
        (..., P, C_a) over channels ``channel_offset : channel_offset +
        split`` and (..., P, C_b) over the next C_b; strided views qualify.
        Either may be None (its output got no gradient). The kernel reads a
        bfloat16 cotangent and bfloat16 values as they are and sums in
        float32.
      grads: as many float32 CUDA tensors of the planes' shapes and layouts:
        the whole planes' gradients.
      channel_offset: first channel of the fetch within the planes.
      split: the first output's width, where g_b's channels start; g_a's
        width by default, needed when g_a is None.

    Returns:
      (..., P, 2) float32, the gradient of each plane's coordinates.
    """
    planes, coords, grads = tuple(planes), tuple(coords), tuple(grads)
    P = len(planes)
    if not 1 <= P <= 3 or len(coords) != P or len(grads) != P:
        raise ValueError(f"bilinear_gather_planes_backward_coords takes 1 to 3 planes and as many "
                         f"coords and grads, got {P}, {len(coords)} and {len(grads)}")
    given = [t for t in (*planes, *coords, *grads, g_a, g_b) if t is not None]
    if not _on_one_device(*given):
        raise ValueError(
            "bilinear_gather_planes_backward_coords needs its tensors on one CUDA device, got "
            f"{[str(t.device) for t in given]}"
        )
    if g_a is None and g_b is None:
        raise ValueError("bilinear_gather_planes_backward_coords needs g_a or g_b")
    dtype = planes[0].dtype
    if dtype not in _GATHER_DTYPES:
        raise ValueError(f"planes must be float32 or bfloat16, got {dtype}")
    for plane, grad in zip(planes, grads):
        for t, what, want in ((plane, "plane", dtype), (grad, "grad", torch.float32)):
            if t.dim() != 3 or t.dtype != want:
                raise ValueError(
                    f"{what} must be (H, W, C) {want}, got {tuple(t.shape)} {t.dtype}")
            _check_plane(t, what)
            H, W, _ = t.shape
            if H * t.stride(0) >= 2**31:
                raise ValueError(f"{what} of {H}x{W} texels x {t.stride(1)} channels: the kernel "
                                 "indexes elements in 32 bits")
        if plane.shape != grad.shape or plane.shape[-1] != planes[0].shape[-1]:
            raise ValueError(f"planes {[tuple(p.shape) for p in planes]} and grads "
                             f"{[tuple(g.shape) for g in grads]} differ in shape or channels")
    for c in coords:
        _check_coords(c)
        if c.shape != coords[0].shape:
            raise ValueError(f"coords differ in shape: {[tuple(c.shape) for c in coords]}")
    batch_shape = coords[0].shape[:-1]
    flat_a = None if g_a is None else _check_cotangent(g_a, batch_shape, P, dtype, "g_a")
    flat_b = None if g_b is None else _check_cotangent(g_b, batch_shape, P, dtype, "g_b")
    if split is None:
        if flat_a is None:
            raise ValueError("bilinear_gather_planes_backward_coords needs split without g_a")
        split = flat_a.shape[2]
    c_total = planes[0].shape[-1]
    c_b = 0 if flat_b is None else flat_b.shape[2]
    if flat_a is None:  # g_b alone: it goes first, at its own channels
        channel_offset, flat_a, flat_b, c_b = channel_offset + split, flat_b, None, 0
    elif flat_a.shape[2] != split:
        raise ValueError(f"g_a has {flat_a.shape[2]} channels, split is {split}")
    c_a = flat_a.shape[2]
    if not 0 <= channel_offset <= c_total - (c_a + c_b) or c_a == 0:
        raise ValueError(f"channels {channel_offset}:{channel_offset + c_a + c_b} outside "
                         f"0:{c_total} or empty")
    flats = [c.reshape(-1, 2) for c in coords]
    n = flats[0].shape[0]
    out = torch.empty((n, P, 2), dtype=torch.float32, device=coords[0].device)
    if n == 0:
        return out.reshape(*batch_shape, P, 2)
    itemsize = _GATHER_ITEMSIZE[dtype]
    desc, ptrs, strides = [], [flat_a.data_ptr()], [flat_a.stride(0), flat_a.stride(1)]
    grad_ptrs = []
    for plane, grad, flat in zip(planes, grads, flats):
        H, W, _ = plane.shape
        src = plane.data_ptr() + itemsize * channel_offset
        dst = grad.data_ptr() + 4 * channel_offset
        desc += [src, plane.stride(1), dst, grad.stride(1), flat.data_ptr(), flat.stride(0),
                 flat.stride(1), H, W]
        ptrs.append(src)
        grad_ptrs.append(dst)
        strides += [plane.stride(1), grad.stride(1)]
    b_ptr = b_stride_n = b_stride_p = 0
    if flat_b is not None:
        b_ptr, b_stride_n, b_stride_p = flat_b.data_ptr(), flat_b.stride(0), flat_b.stride(1)
        ptrs.append(b_ptr)
        strides += [b_stride_n, b_stride_p]
    # Lanes of 4 channels (16 bytes of float32, 8 of bfloat16) and float4
    # atomics when every such access is aligned, as `backward_lanes`.
    aligned = (c_a % 4 == 0 and c_b % 4 == 0 and all(t % 4 == 0 for t in strides)
               and all(p % (4 * itemsize) == 0 for p in ptrs)
               and all(p % 16 == 0 for p in grad_ptrs))
    lib = _lib("bilinear_gather_backward")
    _launch(
        lib, lib.ngf_bilinear_gather_planes_backward_coords, planes[0].get_device(),
        "bilinear_gather_planes_backward_coords",
        (ctypes.c_longlong * len(desc))(*desc), P,
        flat_a.data_ptr(), flat_a.stride(0), flat_a.stride(1), c_a,
        b_ptr or None, b_stride_n, b_stride_p, c_b, n, out.data_ptr(), 4 if aligned else 1,
        _GATHER_DTYPES[dtype],
    )
    bilinear_gather_planes_backward_coords.launches += 1
    return out.reshape(*batch_shape, P, 2)


bilinear_gather_planes_backward_coords.launches = 0


def backward_coords_footprint(vec: int = 4, dtype: torch.dtype = torch.float32) -> dict:
    """K2c's footprint on the current card: the 256-thread blocks an SM
    holds at once, registers a thread and local (spilled) bytes a thread of
    its variant of ``vec``-channel lanes (4 or 1) over float32 or bfloat16
    values and cotangents."""
    lib = _lib("bilinear_gather_backward")
    out = (ctypes.c_int * 3)()
    code = lib.ngf_bilinear_gather_planes_backward_coords_footprint(vec, _GATHER_DTYPES[dtype],
                                                                    out)
    if code:
        raise RuntimeError(f"K2c footprint: CUDA error {code} "
                           f"({lib.ngf_cuda_error_string(code).decode()})")
    return {"blocks_per_sm": out[0], "registers": out[1], "local_bytes": out[2]}


_INDEX_BYTES = {torch.int64: 8, torch.int32: 4}
_ROW_BYTES = {torch.float32: 4, torch.bfloat16: 2}


def _row_args(idx: torch.Tensor, device: int, what: str, per: int, seg: int):
    """Check a row-kernel's ids and return (ids contiguous, index bytes)."""
    if not idx.is_cuda or idx.get_device() != device:
        raise ValueError(f"{what} needs its ids on the table's CUDA device, got {idx.device}")
    idx_bytes = _INDEX_BYTES.get(idx.dtype)
    if idx_bytes is None or idx.dim() != 1:
        raise ValueError(f"idx must be (B,) int64 or int32, got {tuple(idx.shape)} {idx.dtype}")
    if per < 0 or (per > 0 and seg <= 0):
        raise ValueError(f"per must be >= 0 and seg > 0 where per > 0, got per {per}, seg {seg}")
    return (idx if idx.stride(0) == 1 else idx.contiguous()), idx_bytes


def gather_rows(tab: torch.Tensor, idx: torch.Tensor, per: int = 0, seg: int = 0) -> torch.Tensor:
    """CUDA kernel for the row gather ``tab[rows]`` (``kernels/gather_rows.cu``):
    a group of lanes a row, each moving words of 16 bytes where the row's
    bytes, the row stride's bytes and the pointers of ``tab`` and the output
    allow it (the launcher reads them from ``data_ptr()`` and ``stride(0)``;
    :func:`rows_lane_bytes`), else of 8, 4 or 2.

    Args:
      tab: (R, D) float32 or bfloat16 CUDA tensor with contiguous rows.
      idx: (B,) int64 or int32 CUDA tensor of row ids; a row outside [0, R)
        comes back as NaN.
      per, seg: with ``per`` > 0 the ids are relative to segments of ``seg``
        rows, one segment per ``per`` ids, as ``take_along_axis`` reads them:
        row b is ``idx[b] + (b // per) * seg`` for an id in [0, seg), an id
        in [-seg, 0) counts from the segment's end, and an id outside
        [-seg, seg) comes back as NaN (the top groups of each ray of an
        (n * ng, G * C) table).

    Returns:
      (B, D) of tab's dtype.
    """
    # Every check reads as few tensor attributes as it can: this kernel's
    # call costs more host time than device time.
    device = tab.get_device()
    if not tab.is_cuda:
        raise ValueError(f"gather_rows needs tab on a CUDA device, got {tab.device}")
    elem = _ROW_BYTES.get(tab.dtype)
    if elem is None or tab.dim() != 2 or tab.stride(1) != 1:
        raise ValueError(
            f"tab must be (R, D) float32 or bfloat16 with contiguous rows, got "
            f"{tuple(tab.shape)} {tab.dtype} strides {tab.stride()}"
        )
    idx, idx_bytes = _row_args(idx, device, "gather_rows", per, seg)
    R, D = tab.shape
    B = idx.shape[0]
    out = tab.new_empty((B, D))
    if B == 0 or D == 0:
        return out
    lib = _lib("gather_rows")
    _launch(
        lib, lib.ngf_gather_rows, device, "gather_rows",
        tab.data_ptr(), R, D, tab.stride(0), elem, idx.data_ptr(), idx_bytes, B, per, seg,
        out.data_ptr(),
    )
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def scatter_rows(src: torch.Tensor, idx: torch.Tensor, rows: int, per: int = 0,
                 seg: int = 0) -> torch.Tensor:
    """CUDA kernel for the backward of :func:`gather_rows`
    (``kernels/gather_rows.cu``): an (rows, D) tensor of zeros with ``src``
    (B, D) written at the rows of ``idx``, read as :func:`gather_rows` reads
    them; an id that names no row of [0, rows) is dropped. The ids must name
    distinct rows: with a repeated row one of its sources is written, not
    their sum. No atomics. One launch: with ``per`` > 0 one block a
    segment writes each element of its ``seg`` rows once, the source row or
    zeros, through the segment's inverse map in shared memory; with ``per``
    0, or segments longer than the map holds (:func:`scatter_rows_route`),
    a fill, then the rows.

    Args:
      src: (B, D) float32 or bfloat16 CUDA tensor.
      idx: (B,) int64 or int32 on its device; per, seg as :func:`gather_rows`.

    Returns:
      (rows, D) of src's dtype, contiguous.
    """
    device = src.get_device()
    elem = _ROW_BYTES.get(src.dtype)
    if not src.is_cuda or elem is None or src.dim() != 2:
        raise ValueError(f"src must be (B, D) float32 or bfloat16 on a CUDA device, got "
                         f"{tuple(src.shape)} {src.dtype} {src.device}")
    idx, idx_bytes = _row_args(idx, device, "scatter_rows", per, seg)
    B, D = src.shape
    if idx.shape[0] != B:
        raise ValueError(f"{idx.shape[0]} ids for {B} rows of src")
    src = src.contiguous()
    out = src.new_empty((rows, D))
    if rows == 0 or D == 0:
        return out
    lib = _lib("gather_rows")
    _launch(lib, lib.ngf_scatter_rows, device, "scatter_rows", src.data_ptr(), rows, D, elem,
            idx.data_ptr(), idx_bytes, B, per, seg, out.data_ptr())
    scatter_rows.launches += 1
    return out


scatter_rows.launches = 0


def rows_lane_bytes(a: torch.Tensor, out: torch.Tensor) -> int:
    """The word, in bytes, that ``gather_rows`` (``a`` the table) or
    ``scatter_rows`` (``a`` the contiguous source) moves into ``out``: 16,
    8, 4 or 2, the widest that divides the row's bytes, ``a``'s row stride
    in bytes and both pointers."""
    e = a.element_size()
    return _lib("gather_rows").ngf_rows_lane_bytes(a.data_ptr(), out.data_ptr(), a.stride(0) * e,
                                                   a.shape[1] * e, e)


def scatter_rows_route(per: int, seg: int) -> str:
    """The route ``scatter_rows`` takes for these segments: ``"segments"``
    (one block a segment, each element written once) or ``"fill"`` (a fill,
    then the rows)."""
    return "segments" if _lib("gather_rows").ngf_scatter_rows_route(per, seg) else "fill"


def rows_footprint() -> dict:
    """The row kernels' footprint on the current card, by kernel and word
    (int64 ids): the 256-thread blocks an SM holds at once, registers a
    thread and local (spilled) bytes a thread."""
    lib = _lib("gather_rows")
    out = {}
    for which, name in enumerate(("gather_rows_kernel", "scatter_segments_kernel",
                                  "scatter_rows_kernel")):
        for word in (16, 8, 4, 2):
            got = (ctypes.c_int * 3)()
            code = lib.ngf_rows_footprint(which, word, 8, got)
            if code:
                raise RuntimeError(f"row kernels' footprint: CUDA error {code} "
                                   f"({lib.ngf_cuda_error_string(code).decode()})")
            out[f"{name} {word}B"] = {"blocks_per_sm": got[0], "registers": got[1],
                                      "local_bytes": got[2]}
    return out


def occupancy_lookup(
    volume: torch.Tensor, points: torch.Tensor, aabb: torch.Tensor | None = None
) -> torch.Tensor:
    """CUDA kernel K3 (``kernels/occupancy_lookup.cu``): is each point in
    occupied space of a binary volume, ``grid_sample_3d(...) > 0``.

    Args:
      volume: (D, H, W) uint8 CUDA tensor, contiguous, z-major, fewer than
        2^31 voxels.
      points: (..., 3) float32 CUDA tensor. Contiguous points take the
        kernel's contiguous path (four points a thread, 16-byte loads); a
        view of up to three dimensions is read with its strides as it lies
        (``pts[:, 2::4]`` needs no copy).
      aabb: (2, 3) float32 CUDA tensor, the volume's box (the kernel
        normalises the points with it), or None for points that are
        coordinates in [-1, 1].

    Returns:
      (...) bool.
    """
    tensors = (volume, points) if aabb is None else (volume, points, aabb)
    if not _on_one_device(*tensors):
        raise ValueError(
            "occupancy_lookup needs volume, points and aabb on one CUDA device, got "
            f"{[str(t.device) for t in tensors]}"
        )
    _check_volume(volume)
    if points.dtype != torch.float32 or points.dim() < 1 or points.shape[-1] != 3:
        raise ValueError(f"points must be (..., 3) float32, got {tuple(points.shape)} {points.dtype}")
    if aabb is not None:
        _check_box(aabb, "aabb")
        aabb = aabb.contiguous()
    batch_shape = points.shape[:-1]
    out = torch.empty(batch_shape, dtype=torch.bool, device=volume.device)
    M = out.numel()
    if M == 0:
        return out
    contiguous = points.is_contiguous() and points.data_ptr() % 16 == 0 and 3 * M < 2**31
    if contiguous or points.dim() == 3:
        p3 = points.reshape(1, M, 3) if contiguous else points
    elif points.dim() == 2:
        p3 = points[None]
    else:
        p3 = points.reshape(-1, 3)[None]
    A, B, _ = p3.shape
    D, H, W = volume.shape
    lib = _lib("occupancy_lookup")
    _launch(
        lib, lib.ngf_occupancy_lookup, volume.get_device(), "occupancy_lookup",
        p3.data_ptr(), A, B, p3.stride(0), p3.stride(1), p3.stride(2), int(contiguous),
        None if aabb is None else aabb.data_ptr(), volume.data_ptr(), D, H, W, out.data_ptr(),
    )
    occupancy_lookup.launches += 1
    return out


occupancy_lookup.launches = 0


def _check_volume(volume: torch.Tensor) -> None:
    if volume.dtype != torch.uint8 or volume.dim() != 3 or not volume.is_contiguous():
        raise ValueError(
            f"volume must be (D, H, W) uint8 and contiguous, got {tuple(volume.shape)} {volume.dtype}"
        )
    if volume.numel() >= 2**31:
        raise ValueError(f"volume of {volume.numel()} voxels: the kernels index voxels in 32 bits")


def _check_box(box: torch.Tensor, what: str) -> None:
    if box.dtype != torch.float32 or box.shape != (2, 3):
        raise ValueError(f"{what} must be (2, 3) float32, got {tuple(box.shape)} {box.dtype}")


def group_sample_compact(
    rays: torch.Tensor,
    jitter: torch.Tensor | None,
    aabb: torch.Tensor,
    near: float,
    far: float,
    n_samples: int,
    step_size: float,
    group: int,
    capg: int,
    volume: torch.Tensor | None = None,
    volume_aabb: torch.Tensor | None = None,
    indices: bool = False,
):
    """CUDA kernel K4 (``kernels/group_compact.cu``): the grouped render
    path's front end in one launch. Per ray, ``n_samples`` fixed-step
    samples from the box entry, padded to groups of ``group``; the last
    sample and the pad invalid; out-of-box samples invalid and, with a
    volume, the samples its per-group queries find unoccupied; then the
    first ``capg`` groups holding a valid sample, in marching order.

    Args:
      rays: (n, 6) float32 CUDA tensor [origin, direction], components
        contiguous (a row view of a wider table qualifies).
      jitter: (n, 1) float32 per-ray offsets in [0, 1), or None.
      aabb: (2, 3) float32, the render box.
      near, far, n_samples, step_size: as ``stratified_sample`` takes them.
      group: G, 1 to 32 (the kernel keeps a group's validity in one word).
      capg: groups kept per ray, 1 to ceil(n_samples / group).
      volume: optional (D, H, W) uint8 occupancy, contiguous, z-major, with
        ``volume_aabb`` its (2, 3) float32 box (None: the render box).
      indices: also return idx and got (the renderer needs neither).

    Returns:
      (idx (n, capg) int32 or None, got (n, capg) bool or None,
      z_c (n, capg * group) float32, vmask (n, capg * group) float32,
      xyz_n (n, capg * group, 3) float32), as ``group_sample_compact_plain``
      (``ngf_tpu_torch/ops/compaction.py``) gives them.
    """
    tensors = [rays, aabb] + [t for t in (jitter, volume, volume_aabb) if t is not None]
    if not _on_one_device(*tensors):
        raise ValueError(
            "group_sample_compact needs rays, jitter, aabb, volume and its box on one CUDA "
            f"device, got {[str(t.device) for t in tensors]}"
        )
    if rays.dtype != torch.float32 or rays.dim() != 2 or rays.shape[1] != 6 or rays.stride(1) != 1:
        raise ValueError(
            f"rays must be (n, 6) float32 with contiguous components, got {tuple(rays.shape)} "
            f"{rays.dtype} strides {rays.stride()}"
        )
    n = rays.shape[0]
    if jitter is not None and (jitter.dtype != torch.float32 or jitter.shape != (n, 1)):
        raise ValueError(f"jitter must be ({n}, 1) float32, got {tuple(jitter.shape)} {jitter.dtype}")
    _check_box(aabb, "aabb")
    aabb = aabb.contiguous()
    if volume is not None:
        _check_volume(volume)
        volume_aabb = aabb if volume_aabb is None else volume_aabb
        _check_box(volume_aabb, "volume_aabb")
        volume_aabb = volume_aabb.contiguous()
    ng = -(-n_samples // group) if group >= 1 else 0
    if not (n_samples >= 1 and 1 <= group <= 32 and 1 <= capg <= ng):
        raise ValueError(f"group {group} and capg {capg} for {n_samples} samples: the kernel "
                         "takes 1 <= group <= 32 and 1 <= capg <= ceil(n_samples / group)")
    dev = rays.device
    m = capg * group
    z_c = torch.empty((n, m), dtype=torch.float32, device=dev)
    vmask = torch.empty((n, m), dtype=torch.float32, device=dev)
    xyz_n = torch.empty((n, m, 3), dtype=torch.float32, device=dev)
    idx = torch.empty((n, capg), dtype=torch.int32, device=dev) if indices else None
    got = torch.empty((n, capg), dtype=torch.bool, device=dev) if indices else None
    if n == 0:
        return idx, got, z_c, vmask, xyz_n
    D, H, W = volume.shape if volume is not None else (0, 0, 0)
    lib = _lib("group_compact")
    _launch(
        lib, lib.ngf_group_sample_compact, rays.get_device(), "group_sample_compact",
        rays.data_ptr(), rays.stride(0),
        None if jitter is None else jitter.data_ptr(), 0 if jitter is None else jitter.stride(0),
        aabb.data_ptr(), near, far, step_size, n, n_samples, group, capg,
        None if volume is None else volume.data_ptr(), D, H, W,
        None if volume is None else volume_aabb.data_ptr(),
        None if idx is None else idx.data_ptr(), None if got is None else got.data_ptr(),
        z_c.data_ptr(), vmask.data_ptr(), xyz_n.data_ptr(),
    )
    group_sample_compact.launches += 1
    return idx, got, z_c, vmask, xyz_n


group_sample_compact.launches = 0

# The most samples a ray of K5 may have: its backward keeps S/32 floats a
# warp in 48 KB of shared memory (`ngf_ray_march_max_samples`).
MARCH_MAX_SAMPLES = 49152


def _check_samples(S: int, what: str) -> None:
    if not 0 < S <= MARCH_MAX_SAMPLES:
        raise ValueError(f"{what}: rays of {S} samples; the kernel takes 1 to "
                         f"{MARCH_MAX_SAMPLES}")


def _march_inputs(density, valid, dist, rgb, background, what: str) -> list:
    """Check K5's inputs and return the leading arguments of both entry
    points: N, S, each input's pointer and strides, the background's pointer
    and rays per background row."""
    tensors = [t for t in (density, valid, dist, rgb, background) if t is not None]
    if not _on_one_device(*tensors):
        raise ValueError(f"{what} needs its inputs on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if density.dtype != torch.float32 or density.dim() != 2:
        raise ValueError(f"density must be (N, S) float32, got {tuple(density.shape)} {density.dtype}")
    N, S = density.shape
    _check_samples(S, what)
    if valid.dtype not in (torch.bool, torch.uint8) or valid.shape != (N, S):
        raise ValueError(f"valid must be ({N}, {S}) bool or uint8, got {tuple(valid.shape)} {valid.dtype}")
    if dist.dtype != torch.float32 or dist.shape != (N, S):
        raise ValueError(f"dist must be ({N}, {S}) float32, got {tuple(dist.shape)} {dist.dtype}")
    if rgb is not None and (rgb.dtype != torch.float32 or rgb.shape != (N, S, 3)):
        raise ValueError(f"rgb must be ({N}, {S}, 3) float32, got {tuple(rgb.shape)} {rgb.dtype}")
    per_bg = 1
    if background is not None:
        if rgb is None:
            raise ValueError(f"{what}: a background needs rgb")
        nb = background.shape[0] if background.dim() == 2 else 0
        if (background.dtype != torch.float32 or background.dim() != 2 or background.shape[1] != 3
                or nb == 0 or N % nb or not background.is_contiguous()):
            raise ValueError(f"background must be (B, 3) float32, contiguous, B dividing {N}, "
                             f"got {tuple(background.shape)} {background.dtype}")
        per_bg = N // nb
    return [
        N, S, density.data_ptr(), *density.stride(), valid.data_ptr(), *valid.stride(),
        dist.data_ptr(), *dist.stride(),
        None if rgb is None else rgb.data_ptr(), *(rgb.stride() if rgb is not None else (0, 0, 0)),
        None if background is None else background.data_ptr(), per_bg,
    ]


def ray_march(
    density: torch.Tensor,
    valid: torch.Tensor,
    dist: torch.Tensor,
    rgb: torch.Tensor | None = None,
    background: torch.Tensor | None = None,
) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor]:
    """CUDA kernel K5 (``kernels/ray_march.cu``), forward: the NeuTex ray
    march of N rays of S samples, with the background and the tone map.

    Args:
      density: (N, S) float32 CUDA tensor, any strides.
      valid: (N, S) bool or uint8, any strides.
      dist: (N, S) float32 segment lengths, any strides.
      rgb: (N, S, 3) float32 radiance, any strides, or None for the
        colour-free march (``alpha_ray_march``).
      background: (B, 3) float32 contiguous, B dividing N (ray n takes row
        n // (N // B)), or None.

    Returns:
      (colour (N, 3) tone-mapped, or None without rgb; blend weights w
      (N, S); background transmittance T_total (N,)), contiguous.
    """
    args = _march_inputs(density, valid, dist, rgb, background, "ray_march")
    N, S = density.shape
    weight = density.new_empty((N, S))
    t_total = density.new_empty((N,))
    color = density.new_empty((N, 3)) if rgb is not None else None
    if N == 0:
        return color, weight, t_total
    lib = _lib("ray_march")
    _launch(
        lib, lib.ngf_ray_march_forward, density.get_device(), "ray_march", *args,
        None if color is None else color.data_ptr(), weight.data_ptr(), t_total.data_ptr(),
    )
    ray_march.launches += 1
    return color, weight, t_total


ray_march.launches = 0


def ray_march_backward(
    density: torch.Tensor,
    valid: torch.Tensor,
    dist: torch.Tensor,
    rgb: torch.Tensor | None,
    background: torch.Tensor | None,
    g_color: torch.Tensor | None,
    g_weight: torch.Tensor | None,
    g_t: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """CUDA kernel K5 (``kernels/ray_march.cu``), backward: from the
    cotangents of :func:`ray_march`'s colour (N, 3), weights (N, S) and
    T_total (N,), each float32 or None, the gradients of density (N, S) and
    of rgb (N, S, 3; None without rgb), by a reverse scan with no division.
    The inputs are :func:`ray_march`'s."""
    args = _march_inputs(density, valid, dist, rgb, background, "ray_march_backward")
    N, S = density.shape
    cots = []
    for g, shape, what in ((g_color, (N, 3), "g_color"), (g_weight, (N, S), "g_weight"),
                           (g_t, (N,), "g_t")):
        if g is not None:
            if g.dtype != torch.float32 or tuple(g.shape) != shape or not g.is_cuda:
                raise ValueError(f"{what} must be {shape} float32 on the card, got "
                                 f"{tuple(g.shape)} {g.dtype} {g.device}")
            g = g.contiguous()
        cots.append(g)
    if cots[0] is not None and rgb is None:
        raise ValueError("ray_march_backward: a colour cotangent needs rgb")
    d_density = density.new_empty((N, S))
    d_rgb = None if rgb is None else density.new_empty((N, S, 3))
    if N == 0:
        return d_density, d_rgb
    lib = _lib("ray_march")
    _launch(
        lib, lib.ngf_ray_march_backward, density.get_device(), "ray_march_backward", *args,
        *(None if g is None else g.data_ptr() for g in cots),
        d_density.data_ptr(), None if d_rgb is None else d_rgb.data_ptr(),
    )
    ray_march_backward.launches += 1
    return d_density, d_rgb


ray_march_backward.launches = 0


def _background_args(background) -> list:
    """The tri-plane modes' background b as the kernels take it: a pointer
    to one float32 value on the card (the training draw), or none and a
    constant (0 for None)."""
    if isinstance(background, torch.Tensor):
        return [background.data_ptr(), 0.0]
    return [None, 0.0 if background is None else float(background)]


def _triplane_inputs(sigma, dist, rgb, background, thres, what: str) -> list:
    """Check the tri-plane mode's inputs and return the leading arguments of
    its entry points: N, S, sigma's pointer and strides, dist's (or none
    and the constant), rgb's (zeros without rgb: the shard mode's totals),
    the background's pointer (or none) and constant, and the threshold."""
    if not isinstance(sigma, torch.Tensor) or sigma.dtype != torch.float32 or sigma.dim() != 2:
        raise ValueError(f"sigma must be (N, S) float32, got {getattr(sigma, 'shape', sigma)} "
                         f"{getattr(sigma, 'dtype', '')}")
    N, S = sigma.shape
    _check_samples(S, what)
    tensors = [t for t in (sigma, rgb, dist, background) if isinstance(t, torch.Tensor)]
    if not _on_one_device(*tensors):
        raise ValueError(f"{what} needs its inputs on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if rgb is not None and (rgb.dtype != torch.float32 or rgb.shape != (N, S, 3)):
        raise ValueError(f"rgb must be ({N}, {S}, 3) float32, got {tuple(rgb.shape)} {rgb.dtype}")
    if isinstance(dist, torch.Tensor):
        if dist.dtype != torch.float32 or dist.shape != (N, S):
            raise ValueError(f"dist must be ({N}, {S}) float32 or a number, got "
                             f"{tuple(dist.shape)} {dist.dtype}")
        d_args = [dist.data_ptr(), *dist.stride(), 0.0]
    else:
        d_args = [None, 0, 0, float(dist)]
    if isinstance(background, torch.Tensor) and (
            background.dtype != torch.float32 or background.numel() != 1):
        raise ValueError(f"background must be one float32 value, got "
                         f"{tuple(background.shape)} {background.dtype}")
    b_args = _background_args(background)
    r_args = [None, 0, 0, 0] if rgb is None else [rgb.data_ptr(), *rgb.stride()]
    return [N, S, sigma.data_ptr(), *sigma.stride(), *d_args, *r_args, *b_args, float(thres)]


def ray_march_triplane(
    sigma: torch.Tensor,
    dist: torch.Tensor | float,
    rgb: torch.Tensor | None,
    z: torch.Tensor,
    ray_last: torch.Tensor,
    background: torch.Tensor | float | None,
    thres: float,
    weights: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """CUDA kernel K5 (``kernels/ray_march.cu``), tri-plane mode, forward:
    the renderers' composite of N rays of S samples.

    Args:
      sigma: (N, S) float32 CUDA tensor (the density times the valid mask),
        any strides.
      dist: (N, S) float32 segment lengths, any strides, or one number for
        every sample (the grouped path's).
      rgb: (N, S, 3) float32 radiance, any strides, or None: the top-K
        mode's weight launch, no colour (rgb_map and y come back None).
      z: (N, S) float32 sample depths, any strides.
      ray_last: (N,) float32, any stride: each ray's last component.
      background: b of ``y = sum w m rgb + b (1 - acc)``: one float32
        value on the card (the training draw), a number, or None (0).
      thres: the shading threshold on w.
      weights: also write w.

    Returns:
      (rgb_map (N, 3) = clip(y, 0, 1), y (N, 3), acc (N,), depth (N,),
      w (N, S) or None), contiguous.
    """
    args = _triplane_inputs(sigma, dist, rgb, background, thres, "ray_march_triplane")
    N, S = sigma.shape
    for t, shape, what in ((z, (N, S), "z"), (ray_last, (N,), "ray_last")):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not _on_one_device(sigma, t):
            raise ValueError(f"{what} must be {shape} float32 on sigma's device, got "
                             f"{tuple(t.shape)} {t.dtype} {t.device}")
    rgb_map = rgb_lin = None
    if rgb is not None:
        rgb_map, rgb_lin = sigma.new_empty((N, 3)), sigma.new_empty((N, 3))
    acc, depth = sigma.new_empty((N,)), sigma.new_empty((N,))
    w = sigma.new_empty((N, S)) if weights else None
    if N == 0:
        return rgb_map, rgb_lin, acc, depth, w
    lib = _lib("ray_march")
    _launch(
        lib, lib.ngf_ray_march_triplane_forward, sigma.get_device(), "ray_march_triplane",
        *args[:13], z.data_ptr(), *z.stride(), ray_last.data_ptr(), ray_last.stride(0),
        *args[13:], *(None if t is None else t.data_ptr() for t in (rgb_map, rgb_lin)),
        acc.data_ptr(), depth.data_ptr(), None if w is None else w.data_ptr(),
    )
    ray_march_triplane.launches += 1
    return rgb_map, rgb_lin, acc, depth, w


ray_march_triplane.launches = 0


def ray_march_triplane_backward(
    sigma: torch.Tensor,
    dist: torch.Tensor | float,
    rgb: torch.Tensor | None,
    background: torch.Tensor | float | None,
    thres: float,
    rgb_lin: torch.Tensor | None,
    g_rgb: torch.Tensor | None,
    g_acc: torch.Tensor | None,
    g_weight: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """CUDA kernel K5 (``kernels/ray_march.cu``), tri-plane mode, backward:
    from the cotangents of :func:`ray_march_triplane`'s rgb_map (N, 3), acc
    (N,) and w (N, S) (``g_weight``), each float32 or None, and its y
    (``rgb_lin``, needed with ``g_rgb``), the gradients of sigma (N, S) and
    rgb (N, S, 3; None without rgb: the top-K mode's weight backward), by a
    reverse scan with no division. The clip passes half the gradient where y
    lies on 0 or 1, as ``jnp.clip``. The other inputs are the forward's."""
    args = _triplane_inputs(sigma, dist, rgb, background, thres, "ray_march_triplane_backward")
    N, S = sigma.shape
    cots = []
    for g, shape, what in ((rgb_lin, (N, 3), "rgb_lin"), (g_rgb, (N, 3), "g_rgb"),
                           (g_acc, (N,), "g_acc"), (g_weight, (N, S), "g_weight")):
        if g is not None:
            if g.dtype != torch.float32 or tuple(g.shape) != shape or not _on_one_device(sigma, g):
                raise ValueError(f"{what} must be {shape} float32 on sigma's device, got "
                                 f"{tuple(g.shape)} {g.dtype} {g.device}")
            g = g.contiguous()
        cots.append(g)
    if cots[1] is not None and (cots[0] is None or rgb is None):
        raise ValueError("ray_march_triplane_backward: g_rgb needs rgb and the forward's rgb_lin")
    d_sigma = sigma.new_empty((N, S))
    d_rgb = None if rgb is None else sigma.new_empty((N, S, 3))
    if N == 0:
        return d_sigma, d_rgb
    lib = _lib("ray_march")
    _launch(
        lib, lib.ngf_ray_march_triplane_backward, sigma.get_device(),
        "ray_march_triplane_backward", *args, *(None if g is None else g.data_ptr() for g in cots),
        d_sigma.data_ptr(), None if d_rgb is None else d_rgb.data_ptr(),
    )
    ray_march_triplane_backward.launches += 1
    return d_sigma, d_rgb


ray_march_triplane_backward.launches = 0


def _topk_inputs(w, idx, group, rgb_k, background, thres, what: str) -> list:
    """Check the top-K colour pass's inputs and return its leading
    arguments: N, S, K, G, w's pointer, the ids' pointer and strides, rgb_k's
    pointer and strides."""
    if not isinstance(w, torch.Tensor) or w.dtype != torch.float32 or w.dim() != 2:
        raise ValueError(f"w must be (N, S) float32, got {getattr(w, 'shape', w)}")
    N, S = w.shape
    tensors = [t for t in (w, idx, rgb_k, background) if isinstance(t, torch.Tensor)]
    if not _on_one_device(*tensors):
        raise ValueError(f"{what} needs its inputs on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if not w.is_contiguous():
        raise ValueError(f"{what}: w must be contiguous (the weight launch writes it so)")
    if idx.dtype != torch.int64 or idx.dim() != 2 or idx.shape[0] != N or group < 1:
        raise ValueError(f"idx must be (N, K / G) int64 with G >= 1, got {tuple(idx.shape)} "
                         f"{idx.dtype}, G {group}")
    K = idx.shape[1] * group
    if not 0 < K <= S or S % group:
        raise ValueError(f"{what}: {K} slots of groups of {group} in rays of {S} samples")
    if rgb_k.dtype != torch.float32 or tuple(rgb_k.shape) != (N, K, 3):
        raise ValueError(f"rgb_k must be ({N}, {K}, 3) float32, got {tuple(rgb_k.shape)} "
                         f"{rgb_k.dtype}")
    if isinstance(background, torch.Tensor) and (
            background.dtype != torch.float32 or background.numel() != 1):
        raise ValueError(f"background must be one float32 value, got "
                         f"{tuple(background.shape)} {background.dtype}")
    return [N, S, K, group, w.data_ptr(), idx.data_ptr(), *idx.stride(), rgb_k.data_ptr(),
            *rgb_k.stride()]


def ray_march_triplane_topk(
    w: torch.Tensor,
    acc: torch.Tensor,
    idx: torch.Tensor,
    group: int,
    rgb_k: torch.Tensor,
    background: torch.Tensor | float | None,
    thres: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA kernel K5 (``kernels/ray_march.cu``), tri-plane top-K mode, the
    colour pass: with slot k's sample s_k = idx[n, k // G] * G + k % G and
    m_k = w[n, s_k] > thres, y = sum_k m_k w[n, s_k] rgb_k + b (1 - acc)
    (`ngf_tpu/render/volume.py:315-353,473-501`).

    Args:
      w: (N, S) float32 contiguous, the weight launch's
        (:func:`ray_march_triplane` without rgb); acc (N,) float32, its acc.
      idx: (N, K / G) int64 group ids, distinct a ray (sample ids with G 1),
        any strides; group: G.
      rgb_k: (N, K, 3) float32 colours of the selected samples, any strides.
      background, thres: as :func:`ray_march_triplane`'s.

    Returns:
      (rgb_map = clip(y, 0, 1) (N, 3), y (N, 3)), contiguous.
    """
    args = _topk_inputs(w, idx, group, rgb_k, background, thres, "ray_march_triplane_topk")
    N = w.shape[0]
    if acc.dtype != torch.float32 or tuple(acc.shape) != (N,) or not _on_one_device(w, acc):
        raise ValueError(f"acc must be ({N},) float32 on w's device, got {tuple(acc.shape)}")
    acc = acc.contiguous()
    rgb_map, rgb_lin = w.new_empty((N, 3)), w.new_empty((N, 3))
    if N == 0:
        return rgb_map, rgb_lin
    lib = _lib("ray_march")
    _launch(lib, lib.ngf_ray_march_topk_forward, w.get_device(), "ray_march_triplane_topk",
            *args, acc.data_ptr(), *_background_args(background), float(thres),
            rgb_map.data_ptr(), rgb_lin.data_ptr())
    ray_march_triplane_topk.launches += 1
    return rgb_map, rgb_lin


ray_march_triplane_topk.launches = 0


def ray_march_triplane_topk_backward(
    w: torch.Tensor,
    idx: torch.Tensor,
    group: int,
    rgb_k: torch.Tensor,
    background: torch.Tensor | float | None,
    thres: float,
    rgb_lin: torch.Tensor,
    g_rgb: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CUDA kernel K5 (``kernels/ray_march.cu``), tri-plane top-K mode, the
    colour pass's backward: from the cotangent of rgb_map (N, 3) and the
    forward's y (``rgb_lin``), with gy = g_rgb times the clip's derivative
    (half at a bound), the cotangent of w (N, S) (m_k gy . rgb_k at the
    selected samples, 0 elsewhere; every element written), of acc (N,)
    (-b sum gy) and of rgb_k (N, K, 3) (gy m_k w_{s_k}). The other inputs are
    :func:`ray_march_triplane_topk`'s."""
    args = _topk_inputs(w, idx, group, rgb_k, background, thres,
                        "ray_march_triplane_topk_backward")
    N, S = w.shape
    K = rgb_k.shape[1]
    cots = []
    for g, what in ((rgb_lin, "rgb_lin"), (g_rgb, "g_rgb")):
        if g is None or g.dtype != torch.float32 or tuple(g.shape) != (N, 3) or not _on_one_device(w, g):
            raise ValueError(f"{what} must be ({N}, 3) float32 on w's device, got "
                             f"{None if g is None else (tuple(g.shape), g.dtype)}")
        cots.append(g.contiguous())
    g_w, d_acc, d_rgb = w.new_empty((N, S)), w.new_empty((N,)), w.new_empty((N, K, 3))
    if N == 0:
        return g_w, d_acc, d_rgb
    lib = _lib("ray_march")
    _launch(lib, lib.ngf_ray_march_topk_backward, w.get_device(),
            "ray_march_triplane_topk_backward", *args, *_background_args(background),
            float(thres), cots[0].data_ptr(), cots[1].data_ptr(), g_w.data_ptr(),
            d_acc.data_ptr(), d_rgb.data_ptr())
    ray_march_triplane_topk_backward.launches += 1
    return g_w, d_acc, d_rgb


ray_march_triplane_topk_backward.launches = 0


def _check_rays(t: torch.Tensor | None, shape, sigma: torch.Tensor, what: str) -> torch.Tensor | None:
    """A per-ray input of the shard mode: float32 of ``shape`` on sigma's
    device, or None; returned contiguous."""
    if t is None:
        return None
    if t.dtype != torch.float32 or tuple(t.shape) != shape or not _on_one_device(sigma, t):
        raise ValueError(f"{what} must be {shape} float32 on sigma's device, got "
                         f"{tuple(t.shape)} {t.dtype} {t.device}")
    return t.contiguous()


def ray_march_triplane_totals(sigma: torch.Tensor, dist: torch.Tensor | float) -> torch.Tensor:
    """CUDA kernel K5 (``kernels/ray_march.cu``), tri-plane shard mode,
    totals: t_end = prod_k (1 - alpha_k + 1e-10) over the N rays of S
    samples of one shard (`ngf_tpu/parallel/sample_parallel.py:99-103`), by
    the forward's scan. sigma (N, S) float32, any strides; dist (N, S) or
    one number. Returns t_end (N,)."""
    args = _triplane_inputs(sigma, dist, None, None, 0.0, "ray_march_triplane_totals")
    N = sigma.shape[0]
    t_end = sigma.new_empty((N,))
    if N == 0:
        return t_end
    lib = _lib("ray_march")
    _launch(lib, lib.ngf_ray_march_triplane_totals, sigma.get_device(),
            "ray_march_triplane_totals", *args[:9], t_end.data_ptr())
    ray_march_triplane_totals.launches += 1
    return t_end


ray_march_triplane_totals.launches = 0


def ray_march_triplane_shard(
    sigma: torch.Tensor,
    dist: torch.Tensor | float,
    rgb: torch.Tensor,
    z: torch.Tensor,
    t0: torch.Tensor,
    thres: float,
    weights: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """CUDA kernel K5 (``kernels/ray_march.cu``), tri-plane shard mode,
    composite: one shard's share of the sample-parallel composite
    (`ngf_tpu/parallel/sample_parallel.py:105-117`) from the starting
    transmittance t0 (N,): w = (alpha T) t0, m = w > thres, and the partial
    sums with no background, clip or depth fill.

    Args: sigma, dist, rgb, z as :func:`ray_march_triplane`'s; t0 (N,)
    float32; thres the shading threshold; weights: also write w.

    Returns:
      (y = sum m w rgb (N, 3), acc = sum w (N,), depth = sum w z (N,),
      local (N, 4): sum m alpha T rgb and sum alpha T, w (N, S) or None),
      contiguous.
    """
    args = _triplane_inputs(sigma, dist, rgb, None, thres, "ray_march_triplane_shard")
    N, S = sigma.shape
    t0 = _check_rays(t0, (N,), sigma, "t0")
    if z.dtype != torch.float32 or tuple(z.shape) != (N, S) or not _on_one_device(sigma, z):
        raise ValueError(f"z must be ({N}, {S}) float32 on sigma's device, got "
                         f"{tuple(z.shape)} {z.dtype} {z.device}")
    y, local = sigma.new_empty((N, 3)), sigma.new_empty((N, 4))
    acc, depth = sigma.new_empty((N,)), sigma.new_empty((N,))
    w = sigma.new_empty((N, S)) if weights else None
    if N == 0:
        return y, acc, depth, local, w
    lib = _lib("ray_march")
    _launch(
        lib, lib.ngf_ray_march_triplane_shard_forward, sigma.get_device(),
        "ray_march_triplane_shard", *args[:13], z.data_ptr(), *z.stride(), t0.data_ptr(),
        float(thres), y.data_ptr(), acc.data_ptr(), depth.data_ptr(), local.data_ptr(),
        None if w is None else w.data_ptr(),
    )
    ray_march_triplane_shard.launches += 1
    return y, acc, depth, local, w


ray_march_triplane_shard.launches = 0


def ray_march_triplane_shard_backward(
    sigma: torch.Tensor,
    dist: torch.Tensor | float,
    rgb: torch.Tensor,
    t0: torch.Tensor,
    thres: float,
    g_y: torch.Tensor | None,
    g_acc: torch.Tensor | None,
    g_tend: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CUDA kernel K5 (``kernels/ray_march.cu``), tri-plane shard mode,
    backward: from the cotangents of :func:`ray_march_triplane_shard`'s y
    (N, 3) and acc (N,) and of :func:`ray_march_triplane_totals`'s t_end
    (N,), each float32 or None, the gradients of sigma (N, S), rgb (N, S, 3)
    and t0 (N,), in one launch: the reverse scan with the t_end term folded
    in, dividing by neither t0 nor f. The other inputs are the forward's."""
    args = _triplane_inputs(sigma, dist, rgb, None, thres, "ray_march_triplane_shard_backward")
    N, S = sigma.shape
    t0 = _check_rays(t0, (N,), sigma, "t0")
    cots = [_check_rays(g, shape, sigma, what) for g, shape, what in (
        (g_y, (N, 3), "g_y"), (g_acc, (N,), "g_acc"), (g_tend, (N,), "g_tend"))]
    d_sigma, d_rgb, d_t0 = sigma.new_empty((N, S)), sigma.new_empty((N, S, 3)), sigma.new_empty((N,))
    if N == 0:
        return d_sigma, d_rgb, d_t0
    lib = _lib("ray_march")
    _launch(
        lib, lib.ngf_ray_march_triplane_shard_backward, sigma.get_device(),
        "ray_march_triplane_shard_backward", *args[:13], t0.data_ptr(), float(thres),
        *(None if g is None else g.data_ptr() for g in cots),
        d_sigma.data_ptr(), d_rgb.data_ptr(), d_t0.data_ptr(),
    )
    ray_march_triplane_shard_backward.launches += 1
    return d_sigma, d_rgb, d_t0


ray_march_triplane_shard_backward.launches = 0

def ray_march_footprint(S: int) -> dict:
    """K5's footprint on the current card at rays of S samples, by kernel
    (NeuTex, tri-plane and its shard and top-K modes, forward and backward,
    and the shard mode's totals): the blocks of eight warps an SM holds at once,
    registers a thread and local (spilled) bytes a thread."""
    lib = _lib("ray_march")
    out = {}
    for which, name in enumerate(("neutex_forward", "neutex_backward", "triplane_forward",
                                  "triplane_backward", "shard_forward", "shard_backward",
                                  "shard_totals", "topk_forward", "topk_backward")):
        got = (ctypes.c_int * 3)()
        code = lib.ngf_ray_march_footprint(which, S, got)
        if code:
            raise RuntimeError(f"K5 footprint: CUDA error {code} "
                               f"({lib.ngf_cuda_error_string(code).decode()})")
        out[name] = {"blocks_per_sm": got[0], "registers": got[1], "local_bytes": got[2]}
    return out


# Every wrapper with a launch counter, by kernel name.
KERNELS = {
    "bilinear_gather_planes": bilinear_gather_planes,
    "bilinear_gather_2d": bilinear_gather_2d,
    "bilinear_gather_2d_backward": bilinear_gather_2d_backward,
    "bilinear_gather_planes_backward_coords": bilinear_gather_planes_backward_coords,
    "gather_rows": gather_rows,
    "scatter_rows": scatter_rows,
    "occupancy_lookup": occupancy_lookup,
    "group_sample_compact": group_sample_compact,
    "ray_march": ray_march,
    "ray_march_backward": ray_march_backward,
    "ray_march_triplane": ray_march_triplane,
    "ray_march_triplane_backward": ray_march_triplane_backward,
    "ray_march_triplane_totals": ray_march_triplane_totals,
    "ray_march_triplane_shard": ray_march_triplane_shard,
    "ray_march_triplane_shard_backward": ray_march_triplane_shard_backward,
    "ray_march_triplane_topk": ray_march_triplane_topk,
    "ray_march_triplane_topk_backward": ray_march_triplane_topk_backward,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
