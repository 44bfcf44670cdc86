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

Kernels: ``bilinear_gather_2d`` (K1, the tri-plane fetch),
``bilinear_gather_2d_backward`` (K2, its plane gradient) and ``gather_rows``
(the trainer's batch assembly).
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
        lib.ngf_bilinear_gather_2d.argtypes = [
            vp, i32, i32, i64, i32, vp, i64, i64, vp, i64, i32, vp,
        ]
        lib.ngf_bilinear_gather_2d.restype = i32
    elif name == "bilinear_gather_backward":
        lib.ngf_bilinear_gather_2d_backward.argtypes = [
            vp, i64, i32, vp, i64, i64, vp, i32, i32, i64, i64, i32, vp,
        ]
        lib.ngf_bilinear_gather_2d_backward.restype = i32
    elif name == "gather_rows":
        lib.ngf_gather_rows.argtypes = [vp, i64, i32, i64, vp, i32, i64, vp, vp]
        lib.ngf_gather_rows.restype = i32


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


def _check_plane(plane: torch.Tensor, what: str) -> None:
    H, W, _ = plane.shape
    if H < 2 or W < 2:
        raise ValueError(f"{what} must be at least 2x2, got {H}x{W}")
    if plane.stride(2) != 1 or plane.stride(0) != W * plane.stride(1):
        raise ValueError(f"unsupported {what} strides {plane.stride()} for {tuple(plane.shape)}")


def bilinear_gather_2d(plane: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """CUDA kernel for ``grid_sample_2d`` (``kernels/bilinear_gather.cu``).

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
    if plane.dim() != 3 or plane.dtype not in _GATHER_DTYPES:
        raise ValueError(
            f"plane must be (H, W, C) float32/bfloat16, got {tuple(plane.shape)} "
            f"{plane.dtype}"
        )
    _check_plane(plane, "plane")
    H, W, C = plane.shape
    if coords.dtype != torch.float32 or coords.shape[-1] != 2:
        raise ValueError(
            f"coords must be (..., 2) float32, got {tuple(coords.shape)} {coords.dtype}"
        )
    batch_shape = coords.shape[:-1]
    flat = coords.reshape(-1, 2)
    n = flat.shape[0]
    out = plane.new_empty((n, C))
    if n == 0 or C == 0:
        return out.reshape(*batch_shape, C)
    lib = _lib("bilinear_gather")
    _launch(
        lib, lib.ngf_bilinear_gather_2d, plane.get_device(), "bilinear_gather_2d",
        plane.data_ptr(), H, W, plane.stride(1), C,
        flat.data_ptr(), flat.stride(0), flat.stride(1),
        out.data_ptr(), n, _GATHER_DTYPES[plane.dtype],
    )
    bilinear_gather_2d.launches += 1
    return out.reshape(*batch_shape, C)


bilinear_gather_2d.launches = 0


def backward_lanes(C: int, channel_offset: int, texel_stride: int, g_stride: int,
                   g_ptr: int, dst_ptr: int) -> int:
    """Channels per load and atomic of the backward kernel: 4 (float4) when
    every such access is 16-byte aligned — C, the channel offset, the texel
    stride and g's row stride multiples of 4 floats, both base pointers of
    16 bytes — and 1 (scalar) otherwise."""
    if (C % 4 or channel_offset % 4 or texel_stride % 4 or g_stride % 4
            or g_ptr % 16 or dst_ptr % 16):
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
      g: (..., C) float32 CUDA tensor, the gradient of the gather's output.
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
    if g.dtype != torch.float32 or g.shape[:-1] != coords.shape[:-1]:
        raise ValueError(
            f"g must be float32 of shape {(*coords.shape[:-1], C)}, got {tuple(g.shape)} {g.dtype}"
        )
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
                           flat_g.data_ptr(), dst)
    lib = _lib("bilinear_gather_backward")
    _launch(
        lib, lib.ngf_bilinear_gather_2d_backward, grad_plane.get_device(),
        "bilinear_gather_2d_backward",
        flat_g.data_ptr(), flat_g.stride(0), C,
        flat_c.data_ptr(), flat_c.stride(0), flat_c.stride(1),
        dst, H, W, texel_stride, n, lanes,
    )
    bilinear_gather_2d_backward.launches += 1


bilinear_gather_2d_backward.launches = 0

_INDEX_BYTES = {torch.int64: 8, torch.int32: 4}


def gather_rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """CUDA kernel for the row gather ``tab[idx]`` (``kernels/gather_rows.cu``).

    Args:
      tab: (R, D) float32 CUDA tensor with contiguous rows.
      idx: (B,) int64 or int32 CUDA tensor of row ids in [0, R); a row whose
        id lies outside comes back as NaN.

    Returns:
      (B, D) float32.
    """
    # Every check reads as few tensor attributes as it can: this kernel's
    # call costs more host time than device time.
    device = tab.get_device()
    if not (tab.is_cuda and idx.is_cuda) or idx.get_device() != device:
        raise ValueError(
            f"gather_rows needs tab and idx on one CUDA device, got {tab.device} and {idx.device}"
        )
    if tab.dtype is not torch.float32 or tab.dim() != 2 or tab.stride(1) != 1:
        raise ValueError(
            f"tab must be (R, D) float32 with contiguous rows, got {tuple(tab.shape)} "
            f"{tab.dtype} strides {tab.stride()}"
        )
    idx_bytes = _INDEX_BYTES.get(idx.dtype)
    if idx_bytes is None or idx.dim() != 1:
        raise ValueError(f"idx must be (B,) int64 or int32, got {tuple(idx.shape)} {idx.dtype}")
    R, D = tab.shape
    B = idx.shape[0]
    if idx.stride(0) != 1:
        idx = idx.contiguous()
    out = tab.new_empty((B, D))
    if B == 0 or D == 0:
        return out
    lib = _lib("gather_rows")
    _launch(
        lib, lib.ngf_gather_rows, device, "gather_rows",
        tab.data_ptr(), R, D, tab.stride(0), idx.data_ptr(), idx_bytes, B, out.data_ptr(),
    )
    gather_rows.launches += 1
    return out


gather_rows.launches = 0

# Every wrapper with a launch counter, by kernel name.
KERNELS = {
    "bilinear_gather_2d": bilinear_gather_2d,
    "bilinear_gather_2d_backward": bilinear_gather_2d_backward,
    "gather_rows": gather_rows,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
