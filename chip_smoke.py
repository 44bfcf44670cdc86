#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`ngf_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases kernel,rows,backward,render,train]

1. Device: requires CUDA, prints the card and its power limit, builds every
   kernel of the port from the sources in this checkout.
2. Kernel phase: ``bilinear_gather_2d`` at the render path's shapes (a
   256 x 256 x 96 plane, N = 4096 rays x 884 samples, the density channels
   0:24 and the appearance channels 24:96, float32 and bfloat16) against its
   plain PyTorch version, timed beside its bound and ``F.grid_sample``.
3. Row-gather phase: ``gather_rows`` against its plain version (exact) at
   the Pallas probes' shapes (`tools/probe_pallas.py`) and at the
   trainer's (rays (491520, 6) and rgbs (491520, 3) gathered at 4096 ids),
   timed beside its bound and ``torch.index_select``; the host time of one
   call by part (``time.perf_counter_ns`` over 1000 calls), for the lean
   launch path and the earlier one; and the trainer's whole batch assembly
   (``next_batch``: one launch at ids already on the card) against the
   earlier two-call form with a host copy of the ids every step.
4. Backward phase: ``bilinear_gather_2d_backward`` at the train step's
   shapes (a 256 x 256 x 96 plane gradient, N = 4096 rays x 512 samples,
   channels 0:24 and 24:96, random cotangents) on the lego geometry's
   coordinates and on random coordinates in [-1, 1]^2, against its plain
   version and the backward of ``F.grid_sample``, timed beside its bound;
   the mean run length of equal stencil starts of the lego coordinates.
5. Render phase: a random InfoInv tri-plane model at full width, saved as a
   checkpoint with the lego geometry, rendered through ``main_torch.main``
   (render-only, one 800 x 800 synthetic test view, 4096-ray chunks). The
   kernel's launch count over that run must be 6 per chunk; one chunk is
   rendered again with the plain sampler and compared, timed, and profiled
   (device time by op, torch.profiler).
6. Train phase: ``main_torch.main`` in training mode with
   ``configs/synthetic_infoinv_tpu.txt --group_size 0`` at full width (30
   synthetic 128 x 128 views, one test view), 300 steps, under the profiler.
   Each step must launch 6 gathers, 6 gather backwards and 1 row gather;
   the steps may copy to the card only the ids, once per epoch; the losses
   must be finite and fall; the checkpoint and the final evaluation's PNG
   must exist. Then one step on one batch with the kernels and with the
   plain sampler, compared, on the trained weights and on opaque ones, with
   the backward kernel run alone on the step's own cotangents; then ms per
   step, rays/s, peak memory and a profile.

Prints per-phase lines, then the card line, a JSON line of kernel numbers,
and last ``{"ok": true, "device": {...}}``. Any failure raises: the script
then exits non-zero and prints no ``ok`` line. ``--phases`` runs a subset
and prints no result lines. It imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

SEED = 20211202
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
F32_TOL = 1e-5
# bfloat16 keeps 8 significant bits: kernel and plain version sum the same
# float32 terms in another order, so their bfloat16 results may differ by
# one unit in the last place, which is at most 2^-7 of the value.
BF16_REL_TOL = 2.0 ** -7
BF16_ABS_TOL = 1e-6
RENDER_TOL = 1e-4
# Plane gradients, kernel against plain version: both add each texel's
# float32 terms atomically, in orders that differ, so they agree to a few
# float32 roundings of the texel's largest partial sum; 1e-5 of the largest
# gradient holds that with room.
GRAD_REL_TOL = 1e-5
# A train step's plane gradients, kernels against the plain sampler: the
# forward's rounding differences (<= 1e-7) pass through the decoders'
# backward into every cotangent, and a texel's gradient is a sum of
# thousands of terms of both signs that mostly cancel, so the rounding of
# the terms shows relative to the net result (6.5e-5 of the largest
# gradient on the H100 with most samples shaded); 1e-3 of the largest.
STEP_GRAD_REL_TOL = 1e-3
STEP_LOSS_RTOL = 1e-5

RAYS_PER_CHUNK = 4096
WH = 800
# The train step of `configs/synthetic_infoinv_tpu.txt`: 4096-ray batches of
# 884 samples compacted to open_sample_cap 512; 30 views of 128 x 128.
TRAIN_CONFIG = "configs/synthetic_infoinv_tpu.txt"
TRAIN_RAYS, TRAIN_CAP, TRAIN_VIEWS, TRAIN_WH = 4096, 512, 30, 128
# From the random start the loss sits on a plateau (density below the
# shading threshold) for about 130 steps, then falls: 300 steps make the
# falling-loss check meaningful, at about 60 ms a step.
TRAIN_ITERS = 300
PROBE_ROWS, PROBE_D, PROBE_B = 512, 128, 256


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def gather_bound_ms(n: int, h: int, w: int, c: int, itemsize: int) -> tuple[float, str]:
    """Least time for one gather: output written once, coords and the plane
    slice read once, over HBM; 7 flops per output value and ~30 per point of
    index/weight math over the float32 rate. Returns (ms, what bounds it)."""
    nbytes = n * c * itemsize + 8 * n + h * w * c * itemsize
    flops = 7 * n * c + 30 * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(device: torch.device, n_points: int) -> list[dict]:
    """bilinear_gather_2d against its plain version and F.grid_sample."""
    from ngf_tpu_torch.ops.cuda_kernels import bilinear_gather_2d
    from ngf_tpu_torch.ops.grid_sample import grid_sample_2d_plain

    gen = torch.Generator(device=device).manual_seed(SEED)
    plane = 0.1 * torch.randn((256, 256, 96), generator=gen, device=device)
    # Uniform in [-r, r]^2 with r = 1/sqrt(0.9): about 10% of the points
    # fall outside [-1, 1]; the first four are the exact corners.
    r = 1.0 / math.sqrt(0.9)
    coords = (2.0 * torch.rand((n_points, 2), generator=gen, device=device) - 1.0) * r
    coords[:4] = torch.tensor([[-1.0, -1.0], [1.0, 1.0], [-1.0, 1.0], [1.0, -1.0]], device=device)
    outside = ((coords.abs() > 1).any(-1)).float().mean().item()
    print(f"[kernel] N={n_points} points, {100 * outside:.2f}% outside [-1, 1]")

    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        p = plane.to(dtype)
        for name, ch in (("density", slice(0, 24)), ("appearance", slice(24, 96))):
            view = p[..., ch]  # strided view: no copy of the slice
            H, W, C = view.shape
            got = bilinear_gather_2d(view, coords)
            torch.cuda.synchronize()
            ref = grid_sample_2d_plain(view, coords)
            err = (got.float() - ref.float()).abs()
            max_err = err.max().item()
            if dtype == torch.float32:
                check(max_err <= F32_TOL, f"{name} f32 max err {max_err} > {F32_TOL}")
            else:
                bad = (err > BF16_REL_TOL * ref.float().abs() + BF16_ABS_TOL).sum().item()
                check(bad == 0, f"{name} bf16: {bad} values beyond 2^-7 relative")
            for i, (yy, xx) in enumerate(((0, 0), (-1, -1), (-1, 0), (0, -1))):
                check(torch.equal(got[i], view[yy, xx]), f"{name} corner {i} misses its texel")

            lib_plane = view.permute(2, 0, 1)[None].contiguous()
            lib_grid = coords.to(dtype).view(1, n_points, 1, 2)

            def library():
                return F.grid_sample(lib_plane, lib_grid, mode="bilinear",
                                     padding_mode="zeros", align_corners=True)

            if dtype == torch.float32:
                lib_err = (library()[0, :, :, 0].t() - got).abs().max().item()
                check(lib_err <= F32_TOL, f"{name} f32 vs F.grid_sample {lib_err}")
            del ref, err
            ms = cuda_ms(lambda: bilinear_gather_2d(view, coords), reps=20)
            plain_ms = cuda_ms(lambda: grid_sample_2d_plain(view, coords), reps=5)
            library_ms = cuda_ms(library, reps=10)
            bound_ms, bound_by = gather_bound_ms(n_points, H, W, C, view.element_size())
            row = {
                "fetch": name, "dtype": str(dtype).replace("torch.", ""), "C": C,
                "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            }
            print("[kernel] " + json.dumps(row))
            rows.append(row)
    return rows


def bytes_bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def row_gather_phase(device: torch.device, n_train: int) -> dict:
    """gather_rows against its plain version (exact) and torch.index_select,
    at the probes' shapes and at the trainer's batch assembly; where the
    host time of one call goes; the whole per-step batch assembly."""
    from ngf_tpu_torch.ops.cuda_kernels import gather_rows
    from ngf_tpu_torch.ops.gather import gather_rows_plain

    gen = torch.Generator(device=device).manual_seed(SEED)
    ids = torch.randperm(n_train, generator=gen, device=device)[:TRAIN_RAYS]
    cases = [
        ("probe", torch.arange(PROBE_ROWS * PROBE_D, dtype=torch.float32, device=device)
         .reshape(PROBE_ROWS, PROBE_D), torch.arange(PROBE_B, device=device) * 7 % PROBE_ROWS),
        ("rays", torch.randn((n_train, 6), generator=gen, device=device), ids),
        ("rgbs", torch.rand((n_train, 3), generator=gen, device=device), ids),
    ]
    rows = []
    for name, tab, idx in cases:
        got = gather_rows(tab, idx)
        ref = gather_rows_plain(tab, idx)
        check(torch.equal(got, ref), f"gather_rows {name} differs from tab[idx]")
        B, D = got.shape
        # Each gathered row read once and written once, each index read once.
        bound_ms, bound_by = bytes_bound_ms(B * (2 * D * 4 + idx.element_size()), 0.0)
        row = {
            "case": name, "table": list(tab.shape), "B": B, "max_abs_err": 0.0,
            # Back-to-back calls of a kernel this small measure the host's
            # side of each call: 1000 of them.
            "ms": cuda_ms(lambda: gather_rows(tab, idx), reps=1000, warmup=20),
            "device_ms": kernel_device_ms(lambda: gather_rows(tab, idx), "gather_rows_kernel"),
            "plain_ms": cuda_ms(lambda: gather_rows_plain(tab, idx), reps=1000, warmup=20),
            "library_ms": cuda_ms(lambda: torch.index_select(tab, 0, idx), reps=1000,
                                  warmup=20),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        print("[rows] " + json.dumps(row))
        rows.append(row)
    rays_tab, rgbs_tab = cases[1][1], cases[2][1]
    host = launch_host_us(rays_tab, ids)
    print("[rows] host us per call of the rays gather, by part: " + json.dumps(host))
    return {"cases": rows, "host_us": host, "batch": batch_row(device, rays_tab, rgbs_tab)}


def two_call_gather_rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The row-gather wrapper's earlier launch path, kept here only to time
    it against the lean one: the same checks, then a lock, ``torch.empty``
    with a device, a device switch and a stream object on every call, and
    the same C entry point (not counted as a launch of the path)."""
    from ngf_tpu_torch.ops import cuda_kernels

    if not (tab.is_cuda and idx.is_cuda) or tab.device != idx.device:
        raise ValueError("tab and idx on one CUDA device")
    if tab.dim() != 2 or tab.dtype != torch.float32 or tab.stride(1) != 1:
        raise ValueError("tab (R, D) float32")
    if idx.dim() != 1 or idx.dtype not in (torch.int64, torch.int32):
        raise ValueError("idx (B,) int64 or int32")
    R, D = tab.shape
    idx = idx.contiguous()
    out = torch.empty((idx.shape[0], D), dtype=tab.dtype, device=tab.device)
    with _TWO_CALL_LOCK:
        lib = cuda_kernels._lib("gather_rows")
    with torch.cuda.device(tab.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ngf_gather_rows(tab.data_ptr(), R, D, tab.stride(0), idx.data_ptr(),
                                   idx.element_size(), idx.shape[0], out.data_ptr(), stream)
    check(code == 0, f"gather_rows launch: CUDA error {code}")
    return out


_TWO_CALL_LOCK = threading.Lock()


def host_us(fn, calls: int = 1000) -> float:
    """Mean host microseconds of ``fn()`` over ``calls`` back-to-back calls
    (time.perf_counter_ns; the card is synchronised before and after)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    ns = time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    return ns / calls / 1e3


def launch_host_us(tab: torch.Tensor, idx: torch.Tensor) -> dict:
    """Where the host time of one ``gather_rows`` call goes: each part of
    the earlier and of the lean launch path alone, the whole of both, and
    the PyTorch calls of the same gather. Microseconds per call."""
    from ngf_tpu_torch.ops import cuda_kernels

    lib = cuda_kernels._lib("gather_rows")
    dev = tab.get_device()
    out = tab.new_empty((idx.shape[0], tab.shape[1]))
    raw_stream = torch._C._cuda_getCurrentRawStream
    stream = raw_stream(dev)
    args = (tab.data_ptr(), tab.shape[0], tab.shape[1], tab.stride(0), idx.data_ptr(),
            idx.element_size(), idx.shape[0], out.data_ptr(), stream)
    lock, libs = threading.Lock(), {"gather_rows": lib}

    def locked_lookup():
        with lock:
            return libs["gather_rows"]

    def device_switch():
        with torch.cuda.device(tab.device):
            pass

    parts = {
        "python_call": lambda: None,
        "lock_and_lookup": locked_lookup,
        "device_switch": device_switch,
        "stream_object": lambda: torch.cuda.current_stream().cuda_stream,
        "raw_stream": lambda: raw_stream(torch._C._cuda_getDevice()),
        "contiguous": idx.contiguous,
        "torch_empty": lambda: torch.empty((idx.shape[0], tab.shape[1]), dtype=tab.dtype,
                                           device=tab.device),
        "new_empty": lambda: tab.new_empty((idx.shape[0], tab.shape[1])),
        "ctypes_launch": lambda: lib.ngf_gather_rows(*args),
        "two_call_wrapper": lambda: two_call_gather_rows(tab, idx),
        "lean_wrapper": lambda: cuda_kernels.gather_rows(tab, idx),
        "index_select": lambda: torch.index_select(tab, 0, idx),
        "tab[idx]": lambda: tab[idx],
    }
    return {k: host_us(fn) for k, fn in parts.items()}


def batch_row(device: torch.device, rays_tab: torch.Tensor, rgbs_tab: torch.Tensor) -> dict:
    """The trainer's whole per-step batch assembly, ``trainer.next_batch()``
    (ids a slice of the epoch's permutation on the card, one gather of the
    (N, 9) table), on a training set of the train phase's size, against the
    earlier two-call form (numpy ids copied from pinned memory every step,
    one gather of rays and one of rgbs); both by CUDA events, per call over
    100 calls inside an epoch and over the calls of one epoch with its
    reshuffle."""
    import numpy as np

    from ngf_tpu_torch.config import config_parser
    from ngf_tpu_torch.data.dataset import RayDataset
    from ngf_tpu_torch.data.sampler import SimpleSampler
    from ngf_tpu_torch.ops.cuda_kernels import gather_rows
    from ngf_tpu_torch.train.loop import TriPlaneTrainer

    ds = RayDataset()
    ds.all_rays, ds.all_rgbs = rays_tab.cpu().numpy(), rgbs_tab.cpu().numpy()
    ds.img_wh, ds.near_far, ds.white_bg, ds.is_stack = (TRAIN_WH, TRAIN_WH), (2.0, 6.0), True, False
    ds.scene_bbox = np.array([[-1.5] * 3, [1.5] * 3], np.float32)
    args = config_parser([
        "--config", os.path.join(os.path.dirname(os.path.abspath(__file__)), TRAIN_CONFIG),
        "--group_size", "0", "--n_iters", str(TRAIN_ITERS), "--filter_rays", "0",
        "--device", device.type,
    ])
    trainer = TriPlaneTrainer(args, ds, device=device)
    host_ids = SimpleSampler(rays_tab.shape[0], args.batch_size, args.seed)

    def two_call():
        ids = torch.from_numpy(host_ids.nextids()).pin_memory().to(device, non_blocking=True)
        return two_call_gather_rows(rays_tab, ids), two_call_gather_rows(rgbs_tab, ids)

    (rays0, rgbs0), (rays1, rgbs1) = two_call(), trainer.next_batch()
    check(torch.equal(rays0, rays1) and torch.equal(rgbs0, rgbs1),
          "the one-launch batch differs from the two-call batch")
    epoch = rays_tab.shape[0] // args.batch_size
    before = gather_rows.launches
    # Calls 2-102 of an epoch (no reshuffle), then the next `epoch` calls
    # (one reshuffle: the host's permutation and, for the lean form, its
    # one upload).
    row = {"case": "batch", "rays": rays_tab.shape[0], "B": args.batch_size,
           "ms": cuda_ms(trainer.next_batch, reps=100, warmup=1)}
    row["epoch_ms"] = cuda_ms(trainer.next_batch, reps=epoch, warmup=0)
    row["launches_per_batch"] = (gather_rows.launches - before) / (101 + epoch)
    row["id_uploads"] = trainer.sampler.uploads
    row["two_call_ms"] = cuda_ms(two_call, reps=100, warmup=1)
    row["two_call_epoch_ms"] = cuda_ms(two_call, reps=epoch, warmup=0)
    check(row["launches_per_batch"] == 1 and row["id_uploads"] == 2, f"batch {row}")
    print("[rows] " + json.dumps(row))
    return row


def kernel_device_ms(fn, kernel: str, reps: int = 20) -> float:
    """Mean device time of the kernels named ``kernel`` per call of
    ``fn()``, by torch.profiler: for a launch whose host-side call takes
    longer than the kernel, ``cuda_ms`` measures the host."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and kernel in e.key
    ) / 1e3 / reps


def train_coords(device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(TRAIN_RAYS, TRAIN_CAP, 2) plane coordinates xy, yz, xz as a train
    step fetches them: rays of the lego geometry through the middle of the
    800 x 800 view, marched at the geometry's 884 steps, the first
    TRAIN_CAP samples inside the box kept (``open_sample_cap``), normalised
    and projected. Strided views, as in the render path."""
    from ngf_tpu_torch.fields.triplane import triplane_project
    from ngf_tpu_torch.ops.rays import stratified_sample
    from ngf_tpu_torch.render.volume import normalize_coord
    from ngf_tpu_torch.utils.grid import cal_n_samples, grid_step_size

    aabb = torch.tensor([[-1.5] * 3, [1.5] * 3], device=device)
    step = grid_step_size(aabb.tolist(), [256] * 3, 0.5)
    rays = chunk_rays(WH, TRAIN_RAYS, device)
    pts, _, valid = stratified_sample(
        rays[:, :3], rays[:, 3:], aabb, 2.0, 6.0, cal_n_samples([256] * 3, 0.5), step
    )
    order = torch.argsort((~valid).int(), dim=-1, stable=True)[:, :TRAIN_CAP]
    pts = torch.gather(pts, 1, order[..., None].expand(-1, -1, 3))
    return triplane_project(normalize_coord(pts, aabb))


def run_lengths(coords: torch.Tensor, H: int, W: int) -> dict:
    """Plain PyTorch: the mean length of the runs of equal stencil starts in
    point order, and the tap adds per point and channel group that the
    backward kernel makes before skipping zero sums: 4 at the end of each
    16-point segment, and inside one 2 for a step of one texel along x or y
    (two texels carry over) and 4 for any other new start. A scatter
    without merging makes 4."""
    from ngf_tpu_torch.ops.grid_sample import _axis_patch_weights, _unnormalize

    flat = coords.reshape(-1, 2)
    xs = _axis_patch_weights(_unnormalize(flat[:, 0], W), W)[0]
    ys = _axis_patch_weights(_unnormalize(flat[:, 1], H), H)[0]
    start = ys * W + xs
    n = start.numel()
    d = start[1:] - start[:-1]
    inside = torch.arange(1, n, device=start.device) % 16 != 0
    step = (d.abs() == 1) | (d.abs() == W)
    taps = (4 * -(-n // 16) + 2 * (inside & step).sum().item()
            + 4 * (inside & ~step & (d != 0)).sum().item())
    return {"mean_run": n / (1 + (d != 0).sum().item()), "taps_per_point": taps / n}


def backward_row(fetch: str, case: str, g: torch.Tensor, coords: torch.Tensor, c0: int,
                 H: int = 256, W: int = 256, c_total: int = 96) -> dict:
    """One case of bilinear_gather_2d_backward into a zeroed (H, W, 96)
    plane gradient at channel offset c0: against its plain version and
    aten's grid_sample backward (1e-5 of the largest gradient), timed beside
    them and its bound."""
    from ngf_tpu_torch.ops.cuda_kernels import bilinear_gather_2d_backward
    from ngf_tpu_torch.ops.grid_sample import grid_sample_2d_backward_plain

    C = g.shape[-1]
    ch = slice(c0, c0 + C)
    n = g.numel() // C
    got = torch.zeros((H, W, c_total), device=g.device)
    bilinear_gather_2d_backward(g, coords, got, c0)
    ref = torch.zeros_like(got)
    grid_sample_2d_backward_plain(g, coords, ref, c0)
    scale = ref.abs().max().item()
    max_err = (got - ref).abs().max().item()
    check(max_err <= GRAD_REL_TOL * scale, f"{fetch} {case} backward err {max_err} vs max {scale}")
    outside = torch.ones(c_total, dtype=torch.bool, device=g.device)
    outside[ch] = False
    check(not got[..., outside].any().item(), f"{fetch} {case} backward wrote outside {ch}")

    # The library's plane gradient: aten's grid_sample backward, input
    # gradient only, on the permuted plane.
    lib_in = torch.zeros((1, C, H, W), device=g.device)
    lib_grid = coords.reshape(1, n, 1, 2).contiguous()
    lib_g = g.reshape(n, C).t().contiguous().view(1, C, n, 1)

    def library():
        return torch.ops.aten.grid_sampler_2d_backward(
            lib_g, lib_in, lib_grid, 0, 0, True, [True, False])[0]

    lib_err = (library()[0].permute(1, 2, 0) - got[..., ch]).abs().max().item()
    check(lib_err <= GRAD_REL_TOL * scale, f"{fetch} {case} backward vs grid_sample {lib_err}")
    del ref
    row = {
        "fetch": fetch, "case": case, "C": C, "max_abs_err": max_err, "max_abs_grad": scale,
        "zero_row_share": (g.reshape(n, C) == 0).all(-1).float().mean().item(),
        "ms": cuda_ms(lambda: bilinear_gather_2d_backward(g, coords, got, c0), reps=20),
        "plain_ms": cuda_ms(lambda: grid_sample_2d_backward_plain(g, coords, got, c0), reps=3),
        "library_ms": cuda_ms(library, reps=10),
    }
    # g and the coords read once, the plane gradient's channels read and
    # written once; 8 flops per value (4 products, 4 adds) and ~30 per
    # point of index and weight math.
    row["bound_ms"], row["bound_by"] = bytes_bound_ms(
        n * C * 4 + 8 * n + 2 * H * W * C * 4, 8 * n * C + 30 * n)
    print("[backward] " + json.dumps(row))
    return row


def backward_phase(device: torch.device) -> list[dict]:
    """bilinear_gather_2d_backward at the train step's shapes, random
    cotangents: on the train coordinates, whose consecutive points share
    stencils, and on random coordinates in [-1, 1]^2, where no run merges
    and no two neighbouring points contend for a texel."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    xy, yz, xz = train_coords(device)
    n = xy.shape[0] * xy.shape[1]
    print(f"[backward] N={n} points ({xy.shape[0]} rays x {xy.shape[1]} samples)")
    coords = {"train": xy, "random": torch.rand(xy.shape, generator=gen, device=device) * 2 - 1}
    runs = {k: run_lengths(c, 256, 256)
            for k, c in (("xy", xy), ("yz", yz), ("xz", xz), ("random", coords["random"]))}
    print("[backward] runs of equal stencil starts, train coordinates by plane and random "
          "ones: " + json.dumps(runs))
    rows = []
    for case, c in coords.items():
        for fetch, ch in (("density", slice(0, 24)), ("appearance", slice(24, 96))):
            g = torch.randn((*c.shape[:-1], ch.stop - ch.start), generator=gen, device=device)
            rows.append(backward_row(fetch, case, g, c, ch.start))
    rows[0]["runs"] = runs
    return rows


def density_bias(cfg) -> float:
    """Final density bias giving sigma = ln 2 / (distance_scale * 3): a ray
    that crosses 3 units of the box then keeps half its transmittance, so
    the mean opacity lands near 0.5 and the samples clear the 1e-4 shading
    threshold. With random planes and a zero bias, density sits near
    softplus(-10) and nothing is shaded."""
    sigma = math.log(2.0) / (cfg.distance_scale * 3.0)
    return -cfg.density_shift + math.log(math.expm1(sigma))


def make_checkpoint(path: str, device: torch.device, plane_res: int = 256) -> None:
    """Random InfoInv tri-plane at the preset widths with the lego geometry."""
    from ngf_tpu_torch.fields.triplane import TriPlaneConfig, init_triplane
    from ngf_tpu_torch.utils.checkpoint import save_checkpoint
    from ngf_tpu_torch.utils.grid import grid_step_size

    cfg = dataclasses.replace(TriPlaneConfig.infoinv_preset(infoinv=True), plane_res=plane_res)
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = init_triplane(cfg, gen, device)
    params["density_decoder"]["mlp"]["layers"][-1]["b"].fill_(density_bias(cfg))
    aabb = [[-1.5] * 3, [1.5] * 3]
    meta = {
        "model_cfg": dataclasses.asdict(cfg),
        "aabb": aabb,
        "step_size": grid_step_size(aabb, [256] * 3, 0.5),
        "near_far": [2.0, 6.0],
    }
    save_checkpoint(path, params, meta)


def load_model(ckpt: str, device: torch.device):
    """(params, model config, render config) of a checkpoint, as
    `main_torch.run_test` builds them."""
    from ngf_tpu_torch.fields.triplane import TriPlaneConfig
    from ngf_tpu_torch.render.volume import RenderConfig
    from ngf_tpu_torch.utils.checkpoint import load_checkpoint
    from ngf_tpu_torch.utils.grid import grid_n_samples

    params, meta, _, _ = load_checkpoint(ckpt, device)
    rcfg = RenderConfig(
        aabb=tuple(map(tuple, meta["aabb"])), near=meta["near_far"][0], far=meta["near_far"][1],
        n_samples=grid_n_samples(meta["aabb"], meta["step_size"]), step_size=meta["step_size"],
    )
    return params, TriPlaneConfig(**meta["model_cfg"]), rcfg


def chunk_rays(wh: int, n: int, device: torch.device) -> torch.Tensor:
    """The n rays through the middle rows of the wh x wh synthetic test view."""
    import numpy as np

    from ngf_tpu_torch.data.geometry import get_ray_directions_blender, get_rays, pose_spherical

    focal = 0.5 * wh / math.tan(0.5 * 0.6911112070083618)
    dirs = get_ray_directions_blender(wh, wh, [focal, focal])
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    o, d = get_rays(dirs, pose_spherical(-142.5, -24.0, 4.0))
    mid = (wh * wh - n) // 2
    rays = np.concatenate([o, d], 1)[mid : mid + n]
    return torch.from_numpy(rays).to(device)


def render_phase(
    device: torch.device, wh: int = WH, plane_res: int = 256, chunk: int = RAYS_PER_CHUNK
) -> dict:
    """Render-only CLI on a full-width random model, then one chunk again
    with the plain sampler."""
    import main_torch
    from ngf_tpu_torch.ops import cuda_kernels
    from ngf_tpu_torch.ops.grid_sample import grid_sample_2d_plain
    from ngf_tpu_torch.render.volume import render_rays

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "model.npz")
        make_checkpoint(ckpt, device, plane_res)
        argv = [
            "--render_only", "1", "--render_test", "1", "--ckpt", ckpt,
            "--dataset_name", "synthetic", "--datadir", f"synthetic:wh={wh},test_views=1",
            "--eval_chunk", str(chunk), "--compute_extra_metrics", "0",
            "--expname", "smoke", "--device", device.type,
        ]
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        psnrs = main_torch.main(argv)
        main_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in cuda_kernels.KERNELS.items()}
        n_chunks = -(-wh * wh // chunk)
        print(f"[render] main_torch.main: {main_s:.3f} s, psnr {psnrs}, launches {launches}, "
              f"{n_chunks} chunks")
        check(len(psnrs) == 1 and math.isfinite(psnrs[0]), f"psnr {psnrs}")
        out_dir = os.path.join(tmp, "smoke", "imgs_test_all")
        check(os.path.isfile(os.path.join(out_dir, "000.png")), "no rendered PNG")
        check(os.path.isfile(os.path.join(out_dir, "mean.txt")), "no mean.txt")
        if device.type == "cuda":
            check(launches["bilinear_gather_2d"] == 6 * n_chunks,
                  f"{launches['bilinear_gather_2d']} gather launches for {n_chunks} chunks")

        params, model_cfg, rcfg = load_model(ckpt, device)
    rays = chunk_rays(wh, chunk, device)
    plain = lambda p, c, name: grid_sample_2d_plain(p, c)  # noqa: E731
    with torch.inference_mode():
        got = render_rays(params, model_cfg, rcfg, rays)
        ref = render_rays(params, model_cfg, rcfg, rays, sample_fn=plain)
        errs = {k: (got[k] - ref[k]).abs().max().item() for k in got}
        acc = got["acc_map"].mean().item()
        print(f"[render] chunk of {rays.shape[0]} rays x {rcfg.n_samples} samples: "
              f"kernel vs plain max err {errs}, mean acc {acc:.4f}")
        for k in got:
            check(bool(torch.isfinite(got[k]).all()), f"{k} not finite")
            check(errs[k] <= RENDER_TOL, f"{k} kernel vs plain {errs[k]} > {RENDER_TOL}")
        check(0.05 < acc < 0.95, f"mean acc {acc} outside (0.05, 0.95)")
        result = {"psnr": psnrs[0], "main_s": main_s, "launches": launches,
                  "chunks": n_chunks, "render_err": errs, "mean_acc": acc}
        if device.type == "cuda":
            ms = cuda_ms(lambda: render_rays(params, model_cfg, rcfg, rays), reps=5, warmup=1)
            plain_ms = cuda_ms(
                lambda: render_rays(params, model_cfg, rcfg, rays, sample_fn=plain),
                reps=3, warmup=1,
            )
            peak = torch.cuda.max_memory_allocated(device) / 2**30
            print(f"[render] {ms:.3f} ms/chunk ({1e3 * rays.shape[0] / ms:.0f} rays/s) with the "
                  f"kernel, {plain_ms:.3f} ms/chunk with the plain sampler, peak {peak:.2f} GiB")
            result.update(chunk_ms=ms, chunk_plain_ms=plain_ms, peak_gib=peak)
            profile_chunk(lambda: render_rays(params, model_cfg, rcfg, rays))
    return result


def train_phase(
    device: torch.device, iters: int = TRAIN_ITERS, views: int = TRAIN_VIEWS,
    wh: int = TRAIN_WH, extra: tuple[str, ...] = (),
) -> dict:
    """Training CLI at full width, then one step with the kernels against
    the plain sampler, then its time, memory and profile. ``extra`` argv
    shrinks the run for the CPU test."""
    import main_torch
    from ngf_tpu_torch.config import config_parser
    from ngf_tpu_torch.data import load_dataset
    from ngf_tpu_torch.ops import cuda_kernels
    from ngf_tpu_torch.train.loop import TriPlaneTrainer
    from ngf_tpu_torch.utils.checkpoint import load_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        argv = [
            "--config", os.path.join(os.path.dirname(os.path.abspath(__file__)), TRAIN_CONFIG),
            "--group_size", "0", "--n_iters", str(iters),
            "--datadir", f"synthetic:views={views},wh={wh},test_views=1",
            "--render_test", "1", "--basedir", tmp, "--expname", "train",
            "--progress_refresh_rate", "10", "--device", device.type, *extra,
        ]
        args = config_parser(argv)
        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        cuda_kernels.reset_launch_counts()
        # On the card the run is profiled, to count the host-to-device
        # copies of its steps.
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        t0 = time.perf_counter()
        with profile(activities=activities) if cuda else contextlib.nullcontext() as prof:
            stats = main_torch.main(argv)
        main_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in cuda_kernels.KERNELS.items()}
        mses = stats["train_mses"]
        eval_chunks = -(-wh * wh // args.eval_chunk)
        print(f"[train] main_torch.main: {main_s:.3f} s{' under the profiler' if cuda else ''} "
              f"({stats['wall_time_s']:.3f} s in the train loop), {iters} steps, launches "
              f"{launches}, test psnr {stats['test_psnrs']}")
        print(f"[train] mse per step {mses}")
        check(len(mses) == iters and all(math.isfinite(m) for m in mses), f"losses {mses}")
        first, last = sum(mses[:5]) / 5, sum(mses[-5:]) / 5
        check(last < first, f"mse of the last 5 steps {last} >= first 5 {first}")
        check(len(stats["test_psnrs"]) == 1 and math.isfinite(stats["test_psnrs"][0]),
              f"test psnr {stats['test_psnrs']}")
        run = os.path.join(tmp, "train")
        for f in ("model.npz", "imgs_test_all/000.png"):
            check(os.path.isfile(os.path.join(run, f)), f"training wrote no {f}")
        result = {"main_s": main_s, "launches": launches, "mses": mses,
                  "test_psnr": stats["test_psnrs"][0]}
        if cuda:
            steps = args.microbatch * iters
            want = {"bilinear_gather_2d": 6 * steps + 6 * eval_chunks,
                    "bilinear_gather_2d_backward": 6 * steps, "gather_rows": iters}
            check(launches == want, f"launches {launches}, expected {want}")
            result["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
            result["loop"] = loop_profile(prof)
            result["loop"]["id_uploads"] = uploads = stats["id_uploads"]
            print("[train] the train loop under the profiler: " + json.dumps(result["loop"]))
            # One id upload per epoch, and at most the box's one copy
            # besides (made at its first use, if no render made it before).
            copies = result["loop"]["h2d_copies"]
            check(uploads <= copies <= uploads + 1, f"{copies} host-to-device copies in the "
                  f"{iters} steps for {uploads} epochs")
        params = load_checkpoint(os.path.join(run, "model.npz"), device)[0]

    # One batch of a smaller training set through the same configuration.
    ds = load_dataset("synthetic", f"synthetic:views=1,wh={wh}", split="train", is_stack=False)
    trainer = TriPlaneTrainer(args, ds, init_params=params, device=device)
    rays, rgbs = trainer.next_batch()
    result["compare"] = {"trained": compare_step(trainer, rays, rgbs)}
    # The same with the density bias of `make_checkpoint` (mean opacity
    # near 0.5): most samples are shaded, so both fetches carry gradient.
    with torch.no_grad():
        trainer.params["density_decoder"]["mlp"]["layers"][-1]["b"].fill_(
            density_bias(trainer.model_cfg))
    result["compare"]["opaque"] = compare_step(trainer, rays, rgbs, need_appearance=True)
    if cuda:
        step = lambda: trainer.train_step(*trainer.next_batch(), trainer.gen)  # noqa: E731
        torch.cuda.reset_peak_memory_stats(device)
        ms = cuda_ms(step, reps=5, warmup=1)
        step_peak = torch.cuda.max_memory_allocated(device) / 2**30
        print(f"[train] {ms:.3f} ms/step ({1e3 * args.batch_size / ms:.0f} rays/s), peak "
              f"{step_peak:.2f} GiB in the timed steps, {result['peak_gib']:.2f} GiB over "
              f"main_torch.main")
        result.update(step_ms=ms, step_peak_gib=step_peak)
        profile_chunk(step, reps=2, unit="step")
    return result


def compare_step(trainer, rays, rgbs, need_appearance: bool = False) -> dict:
    """One step's MSE and plane gradients with the kernels and with the
    plain sampler on the same batch and jitter; also the share of sample
    rows whose fetch cotangent is all zero, by fetch. On the card, the
    backward kernel also runs alone on the xy plane's cotangents of this
    step, against its plain version and timed (``backward``)."""
    from ngf_tpu_torch.ops.grid_sample import grid_sample_2d_plain

    dd = trainer.model_cfg.density_dim
    zero_rows: dict[str, list[float]] = {}
    cotangents: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}

    def plain(p, c, name):
        out = grid_sample_2d_plain(p, c)
        if out.requires_grad:
            fetch = "density" if p.shape[-1] == dd else "appearance"

            def hook(g):
                zero_rows.setdefault(fetch, []).append((g == 0).all(-1).float().mean().item())
                if name == "plane_xy":
                    cotangents[fetch] = (g.detach(), c.detach())

            out.register_hook(hook)
        return out

    planes = ("plane_xy", "plane_yz", "plane_xz")
    mse, grads = {}, {}
    for how, fn in (("kernels", None), ("plain", plain)):
        gen = torch.Generator(device=rays.device).manual_seed(SEED)
        mse[how] = trainer.compute_grads(rays, rgbs, gen, sample_fn=fn).item()
        grads[how] = {n: trainer.params[n].grad.clone() for n in planes}
    trainer.optimizer.zero_grad()
    scale = max(grads["plain"][n].abs().max().item() for n in planes)
    err = max((grads["kernels"][n] - grads["plain"][n]).abs().max().item() for n in planes)
    app_scale = max(grads["plain"][n][..., dd:].abs().max().item() for n in planes)
    out = {"mse": mse, "max_abs_grad": scale, "max_abs_err": err,
           "max_abs_appearance_grad": app_scale,
           "zero_row_share": {k: sum(v) / len(v) for k, v in zero_rows.items()}}
    print("[train] step, kernels vs plain sampler: " + json.dumps(out))
    check(abs(mse["kernels"] - mse["plain"]) <= STEP_LOSS_RTOL * abs(mse["plain"]),
          f"step mse {mse}")
    check(scale > 0 and err <= STEP_GRAD_REL_TOL * scale, f"plane grad err {err} vs max {scale}")
    check(app_scale > 0 or not need_appearance, "no appearance gradient")
    if rays.is_cuda:
        H, W, c_total = trainer.params["plane_xy"].shape
        out["backward"] = [
            backward_row(fetch, "opaque step" if need_appearance else "trained step", g, c,
                         0 if fetch == "density" else dd, H, W, c_total)
            for fetch, (g, c) in sorted(cotangents.items(), reverse=True)
        ]
    return out


def loop_profile(prof) -> dict:
    """Inside the trainer's ``train_loop`` profiler span: the host-to-device
    copies, the device's busy time (kernels, copies and sets, which run on
    one stream) and its idle share. Reads the profiler's raw events: the
    300 steps make over half a million of them."""
    from torch.autograd import DeviceType

    t = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    span = next(e for e in events if e.name() == "train_loop" and e.device_type() == DeviceType.CPU)
    t0, t1 = span.start_ns(), span.end_ns()
    inside = [e for e in events if e.device_type() == DeviceType.CUDA
              and not e.is_user_annotation() and t0 <= e.start_ns() <= t1]
    busy_ns = sum(e.duration_ns() for e in inside)
    return {"h2d_copies": sum("HtoD" in e.name() for e in inside), "loop_ms": (t1 - t0) / 1e6,
            "device_busy_ms": busy_ns / 1e6, "idle_share": 1.0 - busy_ns / (t1 - t0),
            "events": len(events), "read_s": time.perf_counter() - t}


def profile_chunk(fn, reps: int = 3, unit: str = "chunk") -> None:
    """Where the device time of one call of ``fn`` (a render chunk or a
    train step) goes: torch.profiler over ``reps`` calls, ops sorted by
    device time."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    events = prof.key_averages()
    print(events.table(sort_by="self_device_time_total", row_limit=25))
    # Kernel events only: the aten ops above them report the same time again.
    device_ms = sum(
        e.self_device_time_total for e in events
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation
    ) / 1e3 / reps
    print(f"[profile] {wall_ms:.3f} ms/{unit} on the host clock under the profiler, "
          f"{device_ms:.3f} ms/{unit} of device time, idle share "
          f"{max(0.0, 1.0 - device_ms / wall_ms):.3f}")


PHASES = ("kernel", "rows", "backward", "render", "train")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of %(default)s; the result lines are "
                             "printed only when all run")
    phases = parser.parse_args(argv).phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 1
    from ngf_tpu_torch.ops import cuda_kernels

    device = torch.device("cuda")
    card = card_line()
    print(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_s = cuda_kernels.build_all()
    print(f"[device] kernels built and loaded in {build_s:.3f} s (set-up)")

    run = {
        "kernel": lambda: kernel_phase(device, RAYS_PER_CHUNK * 884),
        "rows": lambda: row_gather_phase(device, TRAIN_VIEWS * TRAIN_WH * TRAIN_WH),
        "backward": lambda: backward_phase(device),
        "render": lambda: render_phase(device),
        "train": lambda: train_phase(device),
    }
    out = {}
    for phase in PHASES:
        if phase in phases:
            t0 = time.perf_counter()
            out[phase] = run[phase]()
            print(f"[device] {phase} phase: {time.perf_counter() - t0:.3f} s")
    if set(phases) != set(PHASES):
        print(card)
        return 0
    rows, bwd_rows, render, train = out["kernel"], out["backward"], out["render"], out["train"]
    row_cases = out["rows"]["cases"]

    def entry(name, source, replaces, row, max_abs_err, at):
        by_path = {"render": render["launches"][name], "train": train["launches"][name]}
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max_abs_err,
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "at": at,
        }

    step_rows = [r for state in train["compare"].values() for r in state.get("backward", [])]
    kernels = [
        entry("bilinear_gather_2d", "ngf_tpu_torch/ops/kernels/bilinear_gather.cu",
              "ngf_tpu/ops/pallas_kernels.py:57",
              next(r for r in rows if r["fetch"] == "appearance" and r["dtype"] == "float32"),
              max(r["max_abs_err"] for r in rows if r["dtype"] == "float32"),
              "appearance fetch: plane 256x256x96 float32, channels 24:96, N=3620864"),
        entry("bilinear_gather_2d_backward", "ngf_tpu_torch/ops/kernels/bilinear_gather_backward.cu",
              "ngf_tpu/ops/grid_sample.py:421",
              next(r for r in bwd_rows if r["fetch"] == "appearance" and r["case"] == "train"),
              max(r["max_abs_err"] for r in bwd_rows + step_rows),
              "appearance fetch: plane gradient 256x256x96 float32, channels 24:96, "
              f"N={TRAIN_RAYS * TRAIN_CAP}, train coordinates, random cotangents"),
        entry("gather_rows", "ngf_tpu_torch/ops/kernels/gather_rows.cu",
              "tools/probe_pallas.py:21,44,68",
              next(r for r in row_cases if r["case"] == "rays"), 0.0,
              f"rays table ({TRAIN_VIEWS * TRAIN_WH * TRAIN_WH}, 6) float32 at {TRAIN_RAYS} ids"),
    ]
    kernels[1]["random_coords_ms"] = next(
        r["ms"] for r in bwd_rows if r["fetch"] == "appearance" and r["case"] == "random")
    kernels[1]["step_cotangent_ms"] = {
        r["case"]: r["ms"] for r in step_rows if r["fetch"] == "appearance"}
    kernels[2]["batch_ms"] = out["rows"]["batch"]["ms"]
    kernels[2]["batch_two_call_ms"] = out["rows"]["batch"]["two_call_ms"]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
