"""Build, load and launch the port's hand-written CUDA kernels.

The sources live in ``ngf_tpu_torch/ops/kernels/``. On first use each one is
compiled with ``nvcc`` for ``sm_90a`` (Hopper) into a shared library with a
plain C interface under ``ngf_tpu_torch/_build/`` and loaded with
``ctypes``; a source's library is named by a hash of its text, so an edited
source is rebuilt. Nothing is compiled or loaded when this module is
imported: the CPU tests import it on machines without ``nvcc`` or a card.

Every wrapper launches its kernel on PyTorch's current stream, raises on an
input the kernel does not take and on a refused launch, and counts its
launches in a plain integer attribute (``bilinear_gather_2d.launches``) so
that a run can show which path its work took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
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
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
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


def _load(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build(name)))
            _declare(name, lib)
            _libs[name] = lib
        return _libs[name]


def _declare(name: str, lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ngf_cuda_error_string.argtypes = [i32]
    lib.ngf_cuda_error_string.restype = ctypes.c_char_p
    if name == "bilinear_gather":
        lib.ngf_bilinear_gather_2d.argtypes = [
            vp, i32, i32, i64, i32, vp, i64, i64, vp, i64, i32, vp,
        ]
        lib.ngf_bilinear_gather_2d.restype = i32


def build_all() -> float:
    """Build and load every kernel of the port; returns the seconds taken."""
    t0 = time.perf_counter()
    for src in sorted(KERNEL_DIR.glob("*.cu")):
        _load(src.stem)
    return time.perf_counter() - t0


def _check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.ngf_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


_GATHER_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    if not (plane.is_cuda and coords.is_cuda) or plane.device != coords.device:
        raise ValueError(
            f"bilinear_gather_2d needs plane and coords on one CUDA device, got "
            f"{plane.device} and {coords.device}"
        )
    if plane.dim() != 3 or plane.dtype not in _GATHER_DTYPES:
        raise ValueError(
            f"plane must be (H, W, C) float32/bfloat16, got {tuple(plane.shape)} "
            f"{plane.dtype}"
        )
    H, W, C = plane.shape
    if H < 2 or W < 2:
        raise ValueError(f"plane must be at least 2x2, got {H}x{W}")
    if plane.stride(2) != 1 or plane.stride(0) != W * plane.stride(1):
        raise ValueError(f"unsupported plane strides {plane.stride()} for {tuple(plane.shape)}")
    if coords.dtype != torch.float32 or coords.shape[-1] != 2:
        raise ValueError(
            f"coords must be (..., 2) float32, got {tuple(coords.shape)} {coords.dtype}"
        )
    batch_shape = coords.shape[:-1]
    flat = coords.reshape(-1, 2)
    n = flat.shape[0]
    out = torch.empty((n, C), dtype=plane.dtype, device=plane.device)
    if n == 0 or C == 0:
        return out.reshape(*batch_shape, C)
    lib = _load("bilinear_gather")
    with torch.cuda.device(plane.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ngf_bilinear_gather_2d(
            plane.data_ptr(), H, W, plane.stride(1), C,
            flat.data_ptr(), flat.stride(0), flat.stride(1),
            out.data_ptr(), n, _GATHER_DTYPES[plane.dtype], stream,
        )
    _check(lib, code, "bilinear_gather_2d launch")
    bilinear_gather_2d.launches += 1
    return out.reshape(*batch_shape, C)


bilinear_gather_2d.launches = 0

# Every wrapper with a launch counter, by kernel name.
KERNELS = {"bilinear_gather_2d": bilinear_gather_2d}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
