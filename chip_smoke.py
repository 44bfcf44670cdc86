#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`ngf_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases kernel,rows,backward,occupancy,uv,render,train,staged,gauge,
                                    bf16,topk,llff,lego,tail,parallel]
                          [--uv_steps 3000] [--uv_bf16_steps 500] [--uv_sphere_steps 500]
                          [--uv_sphere_dtype float32]

1. Device: requires CUDA, prints the card and its power limit, builds every
   kernel of the port from the sources in this checkout, and writes random
   LPIPS alex and vgg weights (the tests' generators) into a temporary
   ``NGF_LPIPS_WEIGHTS_DIR``, so that every evaluation that asks for LPIPS
   computes it on the card.
2. Kernel phase: K1's one-plane call ``bilinear_gather_2d`` at the render
   path's shapes (a 256 x 256 x 96 plane, N = 4096 rays x 884 random
   points, the density channels 0:24 and the appearance channels 24:96,
   float32 and bfloat16), then K1 as the dense path calls it,
   ``bilinear_gather_planes`` (three such planes, split 24) on random
   points, a render chunk's lego samples and a train step's; each against
   its plain PyTorch version, timed beside its bound and ``F.grid_sample``,
   the fused rows with their tap loads per point; and K1 at the shape of
   the Pallas probe ``round1_kernel`` (a 32 x 32 x 8 plane, N = 1024).
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
   Then K2c ``bilinear_gather_planes_backward_coords`` (the plane and the
   coordinate gradients of a fetch of up to three planes in one launch) at
   the gauge recipe's shapes (three 256 x 256 x 64 planes split 16 / 48, the
   projections of an open step's 4096 x 512 lego samples, a masked step's
   4096 x 224, random points), and on the xy plane alone, against its plain
   version and aten's grid_sample backward with both gradients (one call a
   plane), timed beside its bound and the plane branch's, with the fetch's
   whole backward through autograd.
5. Occupancy phase, run before the render and train phases (their
   profiles of hundreds of thousands of events leave the profiler dropping
   kernel events later in the process): K3 ``occupancy_lookup`` against its
   plain version, byte for byte, on random points in [-1.05, 1.05]^3, on
   texel centres and edges, and on a masked train step's query points
   (4096 lego rays x 222, two a group, contiguous and as a strided view) at
   128^3 and 256^3, a dilated ball for the volume, and on the point clouds
   it keeps: a mask
   event's filter chunk (51,200 rays x 256) and count chunk (16,384 x 886)
   and a render-only chunk (4096 x 884); K4 ``group_sample_compact`` (the
   grouped front end: sampling, occupancy test and compaction) against its
   plain version, byte for byte, on a masked train step (4096 rays, 111
   groups of 8, capg 28 and 64), an open one (capg 64) and a masked
   evaluation chunk (all 111 groups); each timed beside its bound and a
   library call. Then the grouped front end as ``render_rays`` runs it (to
   its K1 launch: time, device time, launches) and a masked train step on
   random weights (ms, host clock, idle share, launches per step): both
   call only the entry points, so they also run on an earlier version of
   the port for a comparison in one call.
6. Render phase: a random InfoInv tri-plane model at full width, saved as a
   checkpoint with the lego geometry, rendered through ``main_torch.main``
   (render-only, one 800 x 800 synthetic test view, 4096-ray chunks). The
   gather's and K5's tri-plane composite's launch counts over that run must
   be 1 per chunk; one chunk is rendered again with the plain sampler and
   compared, timed, and profiled (device time by op, torch.profiler, K5's
   share, no ``cumprod``); then K5's tri-plane rows on that chunk's own
   composite inputs (4096 x 884).
7. Train phase: ``main_torch.main`` in training mode with
   ``configs/synthetic_infoinv_tpu.txt --group_size 0`` at full width (30
   synthetic 128 x 128 views, one test view), 300 steps, under the profiler.
   Each step must launch 1 gather, 6 gather backwards, 1 row gather and
   K5's tri-plane composite once each way (once a chunk in evaluation);
   the steps may copy to the card only the ids, once per epoch; the losses
   must be finite and fall; the checkpoint and the final evaluation's PNG
   must exist. Then one step on one batch with the kernels and with the
   plain sampler, compared, on the trained weights and on opaque ones, with
   the backward kernel run alone on the step's own cotangents; then ms per
   step, rays/s, peak memory and a profile; then K5's tri-plane rows on a
   step's own composite inputs and cotangents (4096 x 512).
8. Staged phase: ``main_torch.main`` on ``configs/synthetic_infoinv_tpu.txt``
   as it is (grouped path, 1600 steps, the mask event at 600, 30 synthetic
   128 x 128 views, one test view). The event must run once (its voxels,
   kept rays, measured capacity); the launches of K1, K2, ``gather_rows``,
   K3 (the event's chunks only) and K4 (one per step and evaluation chunk)
   over the run must equal the counts worked out from the steps, the event,
   the evaluation chunks and the mesh export (``--export_mesh 1``: 32 K1
   launches over a 256^3 lattice); the losses must fall in both stages; the
   checkpoint must carry its mask; ``mesh.ply`` must parse with every vertex
   inside the box (the export's seconds printed: grid, marching cubes,
   write); the evaluation (``--compute_extra_metrics 1``) writes
   ``video.mp4`` and ``depthvideo.mp4`` (frames counted back through
   OpenCV) and a ``mean.txt`` of four finite values, LPIPS included.
   Then one masked step with the kernels
   against the plain sampler, the open and masked stages' ms/step, the
   masked step's profile with its launches per step, K5's tri-plane rows on
   an open and a masked step's own inputs (grouped, one constant length),
   and the checkpoint rendered once by the render-only CLI (K3 on the
   dense path).
9. Gauge phase: ``main_torch.main`` on ``configs/synthetic_triplane_tpu.txt``
   as it is (the learned gauge, 1600 grouped steps, the gauge on at 400, the
   mask event with the shrink at 600, the upsample at 800, the same data).
   The two events must run (the shrink's box and grid, the capacities);
   the launches of K1, K2, K2c, ``gather_rows``, K3 and K4 over the run
   must equal the counts worked out from the steps, events and evaluation
   chunks; the losses must fall in each stage; the gauge grids must be
   trained and the checkpoint must carry planes of three shapes. Then one
   step after ``gauge_start`` with the kernels against the plain sampler
   (the loss and every gradient), K2c on that step's own cotangents (its
   three planes in one launch, and the xy plane alone), K1 on its planes
   of three shapes, the stages' ms/step, the events' phases, the
   test PSNR beside the JAX package's band, the checkpoint through the
   render-only CLI, the upsampled stage's step profiled, and K5's tri-plane
   rows on that step's own inputs.
10. bfloat16 phase: ``main_torch.main`` on ``configs/synthetic_infoinv_tpu30k.txt
   --n_iters 3000`` (the 30k schedule cut to its three mask events at 300,
   2000 and 2500, masked cap 160, bfloat16, the same data) and on
   ``configs/synthetic_triplane_tpu_bf16.txt`` as it is (the gauge recipe in
   bfloat16). Each run's events (voxels, kept rays, capacities), exact launch
   totals, falling losses in every stage and float32 checkpoint are checked;
   then one bfloat16 step with the kernels against the plain sampler (the
   loss to 1e-2, the gradients to 3e-2 of the largest), with the dtypes of
   the cotangents K2 and K2c were handed (bfloat16: no float32 copy before
   the launch), K2 and K2c timed on that step's own bfloat16 cotangents
   beside their bounds, plain versions and aten's bfloat16 grid_sample
   backward; each stage's ms/step and the test PSNRs, the gauge's beside the
   JAX package's bfloat16 54.02 dB and float32 band.
11. UV phase (run after the occupancy phase, before the profiled ones): K5
   ``ray_march`` / ``ray_march_backward`` (the NeuTex compositing scan with
   background and tone map, and its reverse-scan gradient) against their
   plain versions at a train step's 576 x 64 jittered cube samples (valid
   and invalid), a ``render_view`` chunk of 576 x 64 (forward) and 65,536
   rays x 64, timed beside bound and plain version; then the UV recipe at
   the `dtu_train.sh` shape (24 synthetic views of 64 x 64, 576 balanced
   rays x 64 samples, 2500 template points, the `NeuTexConfig` widths):
   ``uv_train_torch.py`` on the square in float32 in a subprocess,
   SIGTERMed once it logs step 1000, its 'latest' checkpoint checked,
   resumed in this process to ``--uv_steps`` (3000), then
   ``uv_test_torch.py`` (the 512^2 texture, the six held-out views, renders
   with a checkerboard ``--target_texture``); the sphere (500 steps, the
   cube and equirect exports, an edited cube render) and the square in
   bfloat16 (``--uv_bf16_steps``, 500). Each run: exact K5 launches (one
   forward and one backward a step, one forward a render chunk), falling
   losses, novel IoU and colour PSNR as `tools/uv_cert.py` computes them,
   beside the JAX package's certificates, and one step on its trained
   weights: ms by CUDA events, rays/s, launches, idle share, peak memory
   and the top device ops (the products' and K5's shares).

12. Lego phase (last): the lego recipe ``configs/lego_infoinv_tpu.txt``
   (bfloat16, grouped, measured capacity, mask events at 300, 2000 and 2500,
   ``mask_stride`` 4, an evaluation at 2100) cut to ``--n_iters 2600
   --save_every 500``, on a Blender-format scene written from the cached
   synthetic views (30 train and 1 test view, ``transforms_*.json`` and
   PNGs, read back through ``load_dataset("blender", ..., downsample=6.25)``
   and checked against the written pixels and the synthetic rays). Through
   ``main_torch.py``: a subprocess SIGTERMed once ``log.txt`` passes 1000
   (exit 0, ``model.npz`` with its resume state, the periodic saves'
   ``ckpt/blocked_s`` rows), resumed with ``--ckpt`` in this process to 2600
   (the later events once each, not as first events; falling losses in each
   stage; exact launch totals), and once uninterrupted (exact launch
   totals); the two test PSNRs within 0.3 dB. Then a trainer restored from
   a checkpoint against the one that saved it (parameters, optimizer
   leaves, counts, grid, ray table, generator and next ids equal; one more
   step's loss to 1e-5), and the full-width checkpoint's cost: the seconds a
   synchronous and a background save block the loop, the background write,
   the file's size and ``from_checkpoint``'s seconds.
13. Top-K phase (``topk_phase``, before the lego phase): the JAX package's
   smoke recipe ``configs/synthetic_smoke.txt`` as it is (``rgb_cap 64``:
   the top 8 of 64 groups a ray shaded, the appearance fetched again at
   them, ``microbatch 4``), the staged recipe with ``--rgb_cap 64`` (the
   fused fetch's features gathered, ``scatter_rows`` in the backward) and
   with ``--rgb_cap -2`` against the staged phase's dense run (the PSNR
   within 0.3 dB, the picked capacity printed); exact launch totals with
   the top-K steps, a masked step against the plain sampler, K5's top-K
   mode and the group gather and scatter against their plain versions on a
   masked step's own inputs (the fused features also in bfloat16, and the
   dense path's group-1 gather of 6-float coordinates beside them; each
   row with its word and the scatter's route), the step profiled (no
   ``cumprod``), and the masked model rendered densely with ``mask_stride``
   1 and 4.
14. LLFF phase: a forward-facing scene written from the analytic scene
   (``poses_bounds.npy``, ``images_4/``), trained 400 steps in NDC through
   ``main_torch.main --dataset_name llff`` (exact launch totals, falling
   loss), four views of its spiral path rendered through
   ``evaluation_path`` (its 4-frame videos counted back).
15. Tail phase (``tail_phase``, before the parallel phase): the UV ray
   functions (``cube_ray_generation_with_end``, ``sample_pdf``,
   ``refine_cube_ray_generation``) on the card against the CPU at a UV
   step's shape; LPIPS alex and vgg timed on an 800 x 800 view and held
   against the CPU forward on a 256 x 256 crop (rtol 1e-4); K1 at the mesh
   export's chunk (524,288 lattice points, the density channels of the
   staged phase's trained planes) against its plain version, timed beside
   its bound and ``F.grid_sample``; ``utils.profiling.trace`` around three
   train steps, whose Chrome trace must name K1's kernel symbol.
16. Parallel phase (last; ``parallel_phase``): K5's shard mode, then two
   ranks sharing the card over gloo, a data mesh (2x1, 700 grouped steps
   across the mask event), a sample mesh (1x2, 100 dense steps) and the UV
   trainer on a data mesh (200 steps at the `dtu_train.sh` shape, the ranks
   bit-equal, the first step's losses and gradients within 1e-4 of one
   rank's, the last 50 steps' colour loss within 5%).

Each K5 tri-plane row (``k5_triplane_rows``) holds the kernel against its
plain pair beside its bound and the composite as the renderers ran it
before K5: the plain forward is its ``cumprod`` chain, timed also forward
and backward through autograd, by CUDA events. Every profiled tri-plane step must run no
``cumprod``.

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
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
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
# A bfloat16 train step, kernels against the plain sampler: the kernel and
# the plain gather may round a feature to neighbouring bfloat16 values
# (2^-8 of it), which the bfloat16 decoders carry into every cotangent, and
# the plain route rounds each plane's float32 gradient to bfloat16 once
# (the tracked ``.to`` of its planes) where the kernels add into the float32
# planes: the loss to 1e-2, every gradient to 3e-2 of its leaf's largest.
BF16_STEP_GRAD_REL_TOL = 3e-2
BF16_STEP_LOSS_RTOL = 1e-2

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
# The staged recipe's grouped step: groups of 8 of 886 samples padded to
# 888, 111 groups a ray, two occupancy queries a group.
GROUP, N_GROUPS = 8, 111
# Index and weight arithmetic of one occupancy lookup (normalise, three
# axes, eight tap weights): about 60 float32 operations.
K3_OPS_PER_POINT = 60
# K5's shard mode runs only on the sample-parallel path, its top-K mode only
# with top-K shading, the row scatter only with top-K shading or packing.
NO_MODE_LAUNCHES = {"ray_march_triplane_totals": 0, "ray_march_triplane_shard": 0,
                    "ray_march_triplane_shard_backward": 0, "ray_march_triplane_topk": 0,
                    "ray_march_triplane_topk_backward": 0, "scatter_rows": 0}


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
    return rows + [probe_row(device)] + fused_rows(device)


def probe_row(device: torch.device) -> dict:
    """K1's one-plane call at the shape of the Pallas probe `round1_kernel`
    (tools/probe_pallas.py:94): a (32, 32, 8) float32 plane at 1024 random
    points in [-1, 1]^2, against its plain version and ``F.grid_sample``,
    timed beside its bound."""
    from ngf_tpu_torch.ops.cuda_kernels import bilinear_gather_2d
    from ngf_tpu_torch.ops.grid_sample import grid_sample_2d_plain

    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    plane = torch.randn((32, 32, 8), generator=gen, device=device)
    coords = torch.rand((1024, 2), generator=gen, device=device) * 2 - 1
    got = bilinear_gather_2d(plane, coords)
    err = (got - grid_sample_2d_plain(plane, coords)).abs().max().item()
    check(err <= F32_TOL, f"K1 at the probe's shape: err {err}")
    lib_plane, lib_grid = plane.permute(2, 0, 1)[None].contiguous(), coords.view(1, 1024, 1, 2)

    def library():
        return F.grid_sample(lib_plane, lib_grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True)

    row = {"fetch": "probe", "case": "round1_kernel probe: (32, 32, 8) f32, N=1024",
           "dtype": "float32", "N": 1024, "max_abs_err": err,
           "ms": cuda_ms(lambda: bilinear_gather_2d(plane, coords), reps=100),
           "plain_ms": cuda_ms(lambda: grid_sample_2d_plain(plane, coords), reps=100),
           "library_ms": cuda_ms(library, reps=100)}
    row["bound_ms"], row["bound_by"] = gather_bound_ms(1024, 32, 32, 8, 4)
    print("[kernel] " + json.dumps(row))
    return row


# K1's segment: the consecutive points one thread walks (bilinear_gather.cu).
K1_SEG = 32
CORNERS = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), (-1.0, 1.0, 1.0), (1.0, -1.0, 1.0))


def fused_rows(device: torch.device) -> list[dict]:
    """``bilinear_gather_planes`` as the dense path calls it, once per
    render chunk and train step: three 256 x 256 x 96 planes, split 24,
    float32 and bfloat16, at the projections of four point sets (random
    points in [-r, r]^3, a render chunk's 4096 x 884 lego samples, a train
    step's 4096 x 512 on the same middle rays, and on rays scattered over
    the view as a training batch's are), each set's first four points moved
    to corners of the cube; and the random points on one plane fetched
    three times (a working set the L2 holds). Against ``grid_sample_planes_plain`` (float32 1e-5,
    bfloat16 one ulp) and one batched ``F.grid_sample`` of the stacked
    planes, timed
    beside its bound, with the tap loads per point and channel group that
    the kernel's reuse along runs leaves (``run_lengths``)."""
    from ngf_tpu_torch.fields.triplane import triplane_project
    from ngf_tpu_torch.ops.cuda_kernels import bilinear_gather_planes
    from ngf_tpu_torch.ops.grid_sample import grid_sample_planes_plain

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    planes = [0.1 * torch.randn((256, 256, 96), generator=gen, device=device) for _ in range(3)]
    r = 1.0 / math.sqrt(0.9)
    random = (2.0 * torch.rand((RAYS_PER_CHUNK * 884, 3), generator=gen, device=device) - 1.0) * r
    # The third random case fetches one plane three times: a 25 MB float32
    # working set, which the 50 MB L2 holds, where three planes (75 MB) do
    # not.
    cases = [("random", random, (0, 1, 2)), ("random, one plane", random, (0, 0, 0)),
             ("render chunk", lego_points(device, cap=None), (0, 1, 2)),
             ("train step", lego_points(device), (0, 1, 2)),
             ("train batch", lego_points(device, scattered=True), (0, 1, 2))]
    rows = []
    for case, xyz, which in cases:
        flat = xyz.reshape(-1, 3)
        flat[:4] = torch.tensor(CORNERS, device=device)
        coords = triplane_project(xyz)
        n = flat.shape[0]
        taps = [run_lengths(c, 256, 256, K1_SEG) for c in coords]
        print(f"[kernel] fused, {case}: N={n} points, runs by plane {json.dumps(taps)}")
        distinct = len(set(which))
        for dtype in (torch.float32, torch.bfloat16):
            cast = [p.to(dtype) for p in planes]
            ps = [cast[i] for i in which]
            got = bilinear_gather_planes(ps, coords, split=24)
            torch.cuda.synchronize()
            ref = grid_sample_planes_plain(ps, coords, split=24)
            max_err = 0.0
            for a, b, what in zip(got, ref, ("density", "appearance")):
                err = (a.float() - b.float()).abs()
                max_err = max(max_err, err.max().item())
                if dtype == torch.float32:
                    check(err.max().item() <= F32_TOL, f"fused {case} {what} f32 err {max_err}")
                else:
                    bad = (err > BF16_REL_TOL * b.float().abs() + BF16_ABS_TOL).sum().item()
                    check(bad == 0, f"fused {case} {what} bf16: {bad} values beyond 2^-7")
            full = torch.cat([a.reshape(n, 3, -1) for a in got], -1)
            for i, (p, c) in enumerate(zip(ps, coords)):
                c = c.reshape(n, 2)
                for k in range(len(CORNERS)):
                    texel = p[int(c[k, 1] > 0) * 255, int(c[k, 0] > 0) * 255]
                    check(torch.equal(full[k, i], texel), f"fused {case} corner {k} plane {i}")
            del got, ref, full

            # The library's same function: one batched grid_sample of the
            # three planes, each at its own coordinates.
            lib_planes = torch.stack([p.permute(2, 0, 1) for p in ps]).contiguous()
            lib_grid = torch.stack([c.reshape(n, 2) for c in coords]).to(dtype).view(3, n, 1, 2)

            def library():
                return F.grid_sample(lib_planes, lib_grid, mode="bilinear",
                                     padding_mode="zeros", align_corners=True)

            ms = cuda_ms(lambda: bilinear_gather_planes(ps, coords, split=24), reps=20)
            plain_ms = cuda_ms(lambda: grid_sample_planes_plain(ps, coords, split=24), reps=3)
            library_ms = cuda_ms(library, reps=10)
            del lib_planes, lib_grid
            itemsize = ps[0].element_size()
            # Output written once, the points (the three projections are
            # views of one xyz) and each distinct plane read once; 7 flops
            # per output value and ~30 per point and plane of index and
            # weight math.
            bound_ms, bound_by = bytes_bound_ms(
                n * 3 * 96 * itemsize + 12 * n + distinct * 256 * 256 * 96 * itemsize,
                7 * n * 3 * 96 + 30 * n * 3)
            row = {
                "fetch": "fused", "case": case, "dtype": str(dtype).replace("torch.", ""),
                "N": n, "C": 96, "split": 24, "max_abs_err": max_err, "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "bound_share": bound_ms / ms,
                "taps_per_point": sum(t["taps_per_point"] for t in taps) / 3,
                "mean_run": sum(t["mean_run"] for t in taps) / 3,
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
        code = lib.ngf_gather_rows(tab.data_ptr(), R, D, tab.stride(0), tab.element_size(),
                                   idx.data_ptr(), idx.element_size(), idx.shape[0], 0, 0,
                                   out.data_ptr(), stream)
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
    args = (tab.data_ptr(), tab.shape[0], tab.shape[1], tab.stride(0), tab.element_size(),
            idx.data_ptr(), idx.element_size(), idx.shape[0], 0, 0, out.data_ptr(), stream)
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
    """Mean device time of one launch of the kernel named ``kernel`` in
    ``reps`` calls of ``fn()`` (one launch each), by torch.profiler: for a
    launch whose host-side call takes longer than the kernel, ``cuda_ms``
    measures the host. Averaged over the launches the profiler recorded."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and kernel in e.key]
    return sum(e.self_device_time_total for e in events) / 1e3 / sum(e.count for e in events)


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device milliseconds of one call of ``fn()``: ``reps`` calls captured
    in one CUDA graph, replayed ``replays`` times between two CUDA events,
    so that no host time sits between the launches (``cuda_ms`` of a small
    kernel measures its host-side call)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def lego_points(device: torch.device, cap: int | None = TRAIN_CAP,
                scattered: bool = False) -> torch.Tensor:
    """(TRAIN_RAYS, samples, 3) points in [-1, 1]^3 as a fetch takes them:
    rays of the lego geometry through the middle of the 800 x 800 view (a
    render chunk's), or ``scattered`` over the whole view at random (a
    training batch's), marched and normalised. With ``cap`` (a train step:
    the trainer's 886 steps) the first ``cap`` samples inside the box are
    kept (``open_sample_cap``); None keeps all of an evaluation's 884 steps,
    as a render chunk fetches them."""
    from ngf_tpu_torch.ops.rays import stratified_sample
    from ngf_tpu_torch.render.volume import normalize_coord
    from ngf_tpu_torch.utils.grid import cal_n_samples, grid_n_samples, grid_step_size

    aabb = torch.tensor([[-1.5] * 3, [1.5] * 3], device=device)
    step = grid_step_size(aabb.tolist(), [256] * 3, 0.5)
    n_samples = cal_n_samples([256] * 3, 0.5) if cap else grid_n_samples(aabb.tolist(), step)
    if scattered:
        gen = torch.Generator(device=device).manual_seed(SEED)
        rays = chunk_rays(WH, WH * WH, device)
        rays = rays[torch.randperm(WH * WH, generator=gen, device=device)[:TRAIN_RAYS]]
    else:
        rays = chunk_rays(WH, TRAIN_RAYS, device)
    pts, _, valid = stratified_sample(
        rays[:, :3], rays[:, 3:], aabb, 2.0, 6.0, n_samples, step
    )
    if cap:
        order = torch.argsort((~valid).int(), dim=-1, stable=True)[:, :cap]
        pts = torch.gather(pts, 1, order[..., None].expand(-1, -1, 3))
    return normalize_coord(pts, aabb)


def train_coords(device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(TRAIN_RAYS, TRAIN_CAP, 2) plane coordinates xy, yz, xz as a train
    step fetches them (:func:`lego_points`), projected: strided views, as
    in the render path."""
    from ngf_tpu_torch.fields.triplane import triplane_project

    return triplane_project(lego_points(device))


def run_lengths(coords: torch.Tensor, H: int, W: int, seg: int = 16) -> dict:
    """Plain PyTorch: the mean length of the runs of equal stencil starts in
    point order, and the tap accesses per point and channel group of a
    kernel whose threads walk ``seg`` consecutive points: 4 at each
    segment's end (the backward's adds, before zero sums are skipped) or
    start (the gather's loads), and inside a segment 2 for a step of one
    texel along x or y (two texels carry over), 4 for any other new start
    and none for the same start. K2 walks 16 points, K1 32; a kernel
    without reuse makes 4."""
    from ngf_tpu_torch.ops.grid_sample import _axis_patch_weights, _unnormalize

    flat = coords.reshape(-1, 2)
    xs = _axis_patch_weights(_unnormalize(flat[:, 0], W), W)[0]
    ys = _axis_patch_weights(_unnormalize(flat[:, 1], H), H)[0]
    start = ys * W + xs
    n = start.numel()
    d = start[1:] - start[:-1]
    inside = torch.arange(1, n, device=start.device) % seg != 0
    step = (d.abs() == 1) | (d.abs() == W)
    taps = (4 * -(-n // seg) + 2 * (inside & step).sum().item()
            + 4 * (inside & ~step & (d != 0)).sum().item())
    return {"mean_run": n / (1 + (d != 0).sum().item()), "taps_per_point": taps / n}


def backward_row(fetch: str, case: str, g: torch.Tensor, coords: torch.Tensor, c0: int,
                 H: int = 256, W: int = 256, c_total: int = 96) -> dict:
    """One case of bilinear_gather_2d_backward into a zeroed (H, W, 96)
    float32 plane gradient at channel offset c0, from a float32 or bfloat16
    cotangent: against its plain version and, in float32, aten's grid_sample
    backward (1e-5 of the largest gradient), timed beside them and its
    bound. In bfloat16 the library call is aten's grid_sample backward with
    the plane, the grid and the cotangent in bfloat16 (it takes one dtype),
    timed only: its bfloat16 grid moves the stencils."""
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
    lib_in = torch.zeros((1, C, H, W), device=g.device, dtype=g.dtype)
    lib_grid = coords.reshape(1, n, 1, 2).to(g.dtype).contiguous()
    lib_g = g.reshape(n, C).t().contiguous().view(1, C, n, 1)

    def library():
        return torch.ops.aten.grid_sampler_2d_backward(
            lib_g, lib_in, lib_grid, 0, 0, True, [True, False])[0]

    if g.dtype == torch.float32:
        lib_err = (library()[0].permute(1, 2, 0) - got[..., ch]).abs().max().item()
        check(lib_err <= GRAD_REL_TOL * scale, f"{fetch} {case} backward vs grid_sample {lib_err}")
    del ref
    row = {
        "fetch": fetch, "case": case, "dtype": str(g.dtype).removeprefix("torch."), "C": C,
        "max_abs_err": max_err, "max_abs_grad": scale,
        "zero_row_share": (g.reshape(n, C) == 0).all(-1).float().mean().item(),
        "ms": cuda_ms(lambda: bilinear_gather_2d_backward(g, coords, got, c0), reps=20),
        "plain_ms": cuda_ms(lambda: grid_sample_2d_backward_plain(g, coords, got, c0), reps=3),
        "library_ms": cuda_ms(library, reps=10),
    }
    # g and the coords read once, the float32 plane gradient's channels
    # read and written once; 8 flops per value (4 products, 4 adds) and ~30
    # per point of index and weight math.
    row["bound_ms"], row["bound_by"] = bytes_bound_ms(
        n * C * g.element_size() + 8 * n + 2 * H * W * C * 4, 8 * n * C + 30 * n)
    print("[backward] " + json.dumps(row))
    return row


def coords_bound_ms(n: int, C: int, shapes, itemsize: int = 4) -> tuple[float, str]:
    """K2c's least time over a fetch of planes of ``shapes`` (H, W): per
    plane g and the plane's values (``itemsize`` bytes an element) and the
    coordinates read once, the coordinate gradient written once, the float32
    plane gradient's channels read and written once; 16 flops per value (the
    plane gradient's 4 products and 4 adds, the tap sums' 4 and 4) and ~60
    per point of index, weight and coordinate math."""
    P, texels = len(shapes), sum(h * w for h, w in shapes)
    return bytes_bound_ms(P * (n * C * itemsize + 16 * n) + texels * C * (itemsize + 8),
                          P * (16 * n * C + 60 * n))


def coords_row(case: str, planes, coords, g_a: torch.Tensor, g_b: torch.Tensor | None) -> dict:
    """K2c ``bilinear_gather_planes_backward_coords`` on a fetch of 1 to 3
    planes (each plane's channels, split at g_a's width) into zeroed
    float32 plane gradients: both gradients against the plain version and,
    in float32, against aten's grid_sample backward with both gradients
    asked for, one call a plane (1e-5 of each one's largest), timed beside
    them, its bound and the plane branch's bound for the same fetch. In
    bfloat16 (planes and cotangents) the library call runs in bfloat16,
    timed only, as in :func:`backward_row`."""
    from ngf_tpu_torch.ops.cuda_kernels import bilinear_gather_planes_backward_coords as k2c
    from ngf_tpu_torch.ops.grid_sample import grid_sample_planes_backward_coords_plain

    P = len(planes)
    n = coords[0].numel() // 2
    shapes = [tuple(p.shape[:2]) for p in planes]
    dtype = planes[0].dtype
    got = [torch.zeros(p.shape, device=p.device) for p in planes]
    got_c = k2c(planes, coords, g_a, g_b, got)

    def plain():
        grads = [torch.zeros(p.shape, device=p.device) for p in planes]
        return grads, grid_sample_planes_backward_coords_plain(planes, coords, g_a, g_b, grads)

    ref, ref_c = plain()
    scale = max(r.abs().max().item() for r in ref)
    scale_c = ref_c.abs().max().item()
    err = max((a - b).abs().max().item() for a, b in zip(got, ref))
    err_c = (got_c - ref_c).abs().max().item()
    check(err <= GRAD_REL_TOL * scale, f"K2c {case} plane grad err {err} vs max {scale}")
    check(err_c <= GRAD_REL_TOL * scale_c, f"K2c {case} coord grad err {err_c} vs max {scale_c}")
    del ref, ref_c

    # The library's same function: aten's grid_sample backward, both
    # gradients, one call a plane (one call takes one shape), on the
    # permuted planes and each plane's whole cotangent.
    g_full = g_a if g_b is None else torch.cat([g_a, g_b], -1)
    c_fetched = g_full.shape[-1]
    lib = [(p.permute(2, 0, 1)[None].contiguous(), c.reshape(1, n, 1, 2).to(dtype).contiguous(),
            g_full[:, i].t().contiguous().view(1, c_fetched, n, 1))
           for i, (p, c) in enumerate(zip(planes, coords))]
    del g_full

    def library():
        return [torch.ops.aten.grid_sampler_2d_backward(g, p, c, 0, 0, True, [True, True])
                for p, c, g in lib]

    if dtype == torch.float32:
        lib_err = lib_err_c = 0.0
        for i, (lib_plane, lib_coords) in enumerate(library()):
            lib_err = max(lib_err, (lib_plane[0].permute(1, 2, 0) - got[i][..., :c_fetched])
                          .abs().max().item())
            lib_err_c = max(lib_err_c,
                            (lib_coords.reshape(n, 2) - got_c[:, i]).abs().max().item())
        check(lib_err <= GRAD_REL_TOL * scale and lib_err_c <= GRAD_REL_TOL * scale_c,
              f"K2c {case} vs aten grid_sampler_2d_backward: {lib_err}, {lib_err_c}")
    row = {"fetch": "coords", "case": case, "dtype": str(dtype).removeprefix("torch."),
           "P": P, "shapes": shapes, "N": n, "C": c_fetched,
           "split": g_a.shape[-1], "max_abs_err": max(err, err_c), "max_abs_err_plane": err,
           "max_abs_err_coords": err_c, "max_abs_grad": scale, "max_abs_coord_grad": scale_c}
    itemsize = planes[0].element_size()
    row["bound_ms"], row["bound_by"] = coords_bound_ms(n, c_fetched, shapes, itemsize)
    # The plane branch alone on the same fetch (bilinear_gather_2d_backward's bound).
    row["plane_branch_bound_ms"] = sum(bytes_bound_ms(
        n * c_fetched * itemsize + 8 * n + 2 * h * w * c_fetched * 4,
        8 * n * c_fetched + 30 * n)[0] for h, w in shapes)
    row["ms"] = cuda_ms(lambda: k2c(planes, coords, g_a, g_b, got), reps=20)
    row["plain_ms"] = cuda_ms(plain, reps=3)
    row["library_ms"] = cuda_ms(library, reps=10)
    del lib, got, got_c
    print("[backward] coords " + json.dumps(row))
    return row


def fetch_backward_ms(planes, coords, g_a: torch.Tensor, g_b: torch.Tensor,
                      reps: int = 20, dtype: torch.dtype | None = None) -> float:
    """ms of the backward of one ``grid_sample_planes`` fetch (split at g_a's
    width) whose planes and coordinates need gradients, by CUDA events: the
    plane and coordinate gradients as autograd asks for them, buffers
    included. It calls only the entry point, so it also times an earlier
    version of the port (one K2c launch a plane) in the same call; a
    ``dtype`` (the bfloat16 fetch of float32 planes) goes to the fetch."""
    from ngf_tpu_torch.ops.grid_sample import grid_sample_planes

    ps = [p.detach().requires_grad_(True) for p in planes]
    cs = [c.detach().requires_grad_(True) for c in coords]
    out = grid_sample_planes(ps, cs, slice(None), g_a.shape[-1],
                             **({} if dtype is None else {"dtype": dtype}))
    return cuda_ms(lambda: torch.autograd.grad(out, ps + cs, (g_a, g_b), retain_graph=True),
                   reps=reps)


def open_fetch_inputs(device: torch.device, case: str = "open step"):
    """(planes, coords, g_a, g_b) of the gauge recipe's open fetch: three
    256 x 256 x 64 planes, the projections of an open step's lego samples
    (4096 x 512, ``open_sample_cap``), a masked step's (4096 x 224) or
    random points in [-1, 1]^3 as strided views, cotangents (N, 3, 16) and
    (N, 3, 48) as the fetch's outputs get them."""
    from ngf_tpu_torch.fields.triplane import triplane_project

    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    planes = [0.1 * torch.randn((256, 256, 64), generator=gen, device=device) for _ in range(3)]
    if case == "random":
        xyz = torch.rand((TRAIN_RAYS, TRAIN_CAP, 3), generator=gen, device=device) * 2 - 1
    else:
        xyz = lego_points(device, cap=224 if case == "masked step" else TRAIN_CAP)
    n = xyz.shape[0] * xyz.shape[1]
    coords = [c.reshape(n, 2) for c in triplane_project(xyz)]
    g_a = torch.randn((n, 3, 16), generator=gen, device=device)
    g_b = torch.randn((n, 3, 48), generator=gen, device=device)
    return planes, coords, g_a, g_b


def coords_rows(device: torch.device) -> list[dict]:
    """K2c at the gauge recipe's shapes (:func:`open_fetch_inputs`): the
    three-plane launch on an open step's lego samples, a masked step's and
    random points, with the fetch's backward through autograd beside it;
    then, for comparison with the earlier design's one-plane launches, the
    xy plane alone on the same points with its cotangents as strided views."""
    rows = []
    for case in ("open step", "masked step", "random"):
        planes, coords, g_a, g_b = open_fetch_inputs(device, case)
        row = coords_row(f"{case}, three planes", planes, coords, g_a, g_b)
        row["autograd_ms"] = fetch_backward_ms(planes, coords, g_a, g_b)
        rows.append(row)
        rows.append(coords_row(case, planes[:1], coords[:1], g_a[:, :1], g_b[:, :1]))
        del planes, coords, g_a, g_b
    return rows


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
    return rows + coords_rows(device)


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
            # One three-plane gather per chunk, and no other.
            check(launches["bilinear_gather_planes"] == n_chunks
                  and launches["bilinear_gather_2d"] == 0,
                  f"gather launches {launches} for {n_chunks} chunks")
            # One K5 tri-plane composite per chunk, and no backward.
            check(launches["ray_march_triplane"] == n_chunks
                  and launches["ray_march_triplane_backward"] == 0,
                  f"composite launches {launches} for {n_chunks} chunks")

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
            # Over the CLI run and the two renders above (the plain
            # sampler's intermediates decide it); then one kernel chunk's.
            peak = torch.cuda.max_memory_allocated(device) / 2**30
            chunk_peak = chunk_peak_gib(params, model_cfg, rcfg, rays)
            ms = cuda_ms(lambda: render_rays(params, model_cfg, rcfg, rays), reps=5, warmup=1)
            plain_ms = cuda_ms(
                lambda: render_rays(params, model_cfg, rcfg, rays, sample_fn=plain),
                reps=3, warmup=1,
            )
            print(f"[render] {ms:.3f} ms/chunk ({1e3 * rays.shape[0] / ms:.0f} rays/s) with the "
                  f"kernel, {plain_ms:.3f} ms/chunk with the plain sampler, peak {peak:.2f} GiB, "
                  f"{chunk_peak:.2f} GiB in one kernel chunk")
            result.update(chunk_ms=ms, chunk_plain_ms=plain_ms, peak_gib=peak,
                          chunk_peak_gib=chunk_peak)
            result["profile"] = profile_chunk(lambda: render_rays(params, model_cfg, rcfg, rays))
            result["k5"] = step_k5_rows("render chunk",
                                        lambda: render_rays(params, model_cfg, rcfg, rays))
    return result


def chunk_peak_gib(params, model_cfg, rcfg, rays: torch.Tensor) -> float:
    """Peak device memory, GiB, while one chunk renders with the kernels,
    counted from what is allocated before it (the model, the rays)."""
    from ngf_tpu_torch.render.volume import render_rays

    with torch.inference_mode():
        render_rays(params, model_cfg, rcfg, rays)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(rays.device)
        render_rays(params, model_cfg, rcfg, rays)
        torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated(rays.device) / 2**30


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
            want = {"bilinear_gather_planes": steps + eval_chunks, "bilinear_gather_2d": 0,
                    "bilinear_gather_2d_backward": 6 * steps,
                    "bilinear_gather_planes_backward_coords": 0, "gather_rows": iters,
                    "occupancy_lookup": 0, "group_sample_compact": 0, "ray_march": 0,
                    "ray_march_backward": 0, "ray_march_triplane": steps + eval_chunks,
                    "ray_march_triplane_backward": steps, **NO_MODE_LAUNCHES}
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
        result["profile"] = profile_chunk(step, reps=2, unit="step")
        result["k5"] = step_k5_rows(
            "dense train step", lambda: trainer.compute_grads(*trainer.next_batch(), trainer.gen))
        trainer.optimizer.zero_grad()
    return result


def plain_sample(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The plain sampler of the step comparisons: ``grid_sample_2d_plain``
    on the plane widened to float32 (no copy for a float32 plane), rounded
    to the plane's dtype, so that its autograd adds the plane gradient in
    float32 as the kernels do (a bfloat16 plane's own autograd would add it
    in bfloat16)."""
    from ngf_tpu_torch.ops.grid_sample import grid_sample_2d_plain

    return grid_sample_2d_plain(p.float(), c).to(p.dtype)


def step_tolerances(trainer) -> tuple[float, float]:
    """(loss rtol, gradient tolerance of the largest) of a step comparison
    in the trainer's compute dtype."""
    if trainer.model_cfg.compute_dtype == "bfloat16":
        return BF16_STEP_LOSS_RTOL, BF16_STEP_GRAD_REL_TOL
    return STEP_LOSS_RTOL, STEP_GRAD_REL_TOL


@contextlib.contextmanager
def cotangent_dtypes():
    """Records, by kernel, the dtype variant that each launch of the two
    backward kernels (K2, K2c) inside the block took: the proof that the
    bfloat16 path hands them its bfloat16 cotangents as they are, with no
    float32 copy before the launch. Wraps the wrappers' common launch
    call, so the launch counts go on as they do."""
    from ngf_tpu_torch.ops import cuda_kernels

    seen: dict[str, set[str]] = {}
    names = {v: str(k) for k, v in cuda_kernels._GATHER_DTYPES.items()}
    launch = cuda_kernels._launch

    def recorder(lib, entry, device, what, *args):
        if what in ("bilinear_gather_2d_backward", "bilinear_gather_planes_backward_coords"):
            seen.setdefault(what, set()).add(names[args[-1]])  # the dtype code comes last
        return launch(lib, entry, device, what, *args)

    cuda_kernels._launch = recorder
    try:
        yield seen
    finally:
        cuda_kernels._launch = launch


def compare_step(trainer, rays, rgbs, need_appearance: bool = False, case: str | None = None) -> dict:
    """One step's MSE and plane gradients with the kernels and with the
    plain sampler on the same batch and jitter (tolerances by the compute
    dtype, :func:`step_tolerances`); also the share of sample rows whose
    fetch cotangent is all zero, by fetch, and the dtypes of the cotangents
    the backward kernels were handed. On the card, the backward kernel also
    runs alone on the xy plane's cotangents of this step, in their own
    dtype, against its plain version and timed (``backward``)."""
    dd = trainer.model_cfg.density_dim
    loss_rtol, grad_tol = step_tolerances(trainer)
    zero_rows: dict[str, list[float]] = {}
    cotangents: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}

    def plain(p, c, name):
        out = plain_sample(p, c)
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
        with cotangent_dtypes() as seen:
            mse[how] = trainer.compute_grads(rays, rgbs, gen, sample_fn=fn).item()
        grads[how] = {n: trainer.params[n].grad.clone() for n in planes}
        if how == "kernels":
            kernel_dtypes = {k: sorted(v) for k, v in seen.items()}
    trainer.optimizer.zero_grad()
    scale = max(grads["plain"][n].abs().max().item() for n in planes)
    err = max((grads["kernels"][n] - grads["plain"][n]).abs().max().item() for n in planes)
    app_scale = max(grads["plain"][n][..., dd:].abs().max().item() for n in planes)
    out = {"mse": mse, "max_abs_grad": scale, "max_abs_err": err,
           "max_abs_appearance_grad": app_scale, "cotangent_dtypes": kernel_dtypes,
           "zero_row_share": {k: sum(v) / len(v) for k, v in zero_rows.items()}}
    print("[train] step, kernels vs plain sampler: " + json.dumps(out))
    check(abs(mse["kernels"] - mse["plain"]) <= loss_rtol * abs(mse["plain"]), f"step mse {mse}")
    check(scale > 0 and err <= grad_tol * scale, f"plane grad err {err} vs max {scale}")
    if rays.is_cuda:
        want = str(trainer.model_cfg.dtype)
        check(kernel_dtypes == {"bilinear_gather_2d_backward": [want]},
              f"cotangents handed to the kernels {kernel_dtypes}, expected {want}")
    check(app_scale > 0 or not need_appearance, "no appearance gradient")
    if rays.is_cuda:
        H, W, c_total = trainer.params["plane_xy"].shape
        case = case or ("opaque step" if need_appearance else "trained step")
        out["backward"] = [
            backward_row(fetch, case, g, c,
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


def profile_chunk(fn, reps: int = 3, unit: str = "chunk") -> dict:
    """Where the device time of one call of ``fn`` (a render chunk or a
    train step) goes: torch.profiler over ``reps`` calls, ops sorted by
    device time. Returns the host-clock ms per call under the profiler, its
    device ms, idle share, and kernel launches and copies and sets per call."""
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
    device = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    copies = sum(e.count for e in device if e.key.startswith(("Memcpy", "Memset"))) / reps
    out = {"host_ms": wall_ms,
           "device_ms": sum(e.self_device_time_total for e in device) / 1e3 / reps,
           "launches": sum(e.count for e in device) / reps - copies, "copies_and_sets": copies}
    out["idle_share"] = max(0.0, 1.0 - out["device_ms"] / wall_ms)
    # K5's share of the device time, and no cumprod left on the path.
    out["k5_ms"] = sum(e.self_device_time_total for e in device
                       if "ray_march" in e.key) / 1e3 / reps
    out["k5_share"] = out["k5_ms"] / out["device_ms"] if out["device_ms"] else 0.0
    out["cumprod_calls"] = sum(e.count for e in events if "cumprod" in e.key) / reps
    # Each K5 kernel's device ms a launch in this run (by its name).
    out["k5_kernels"] = {}
    for e in device:
        name = re.search(r"ray_march_(\w+)_kernel", e.key)
        if name:
            out["k5_kernels"][name.group(1)] = e.self_device_time_total / 1e3 / e.count
    check(out["cumprod_calls"] == 0, f"cumprod ran in the profiled {unit}")
    print(f"[profile] {wall_ms:.3f} ms/{unit} on the host clock under the profiler, "
          f"{out['device_ms']:.3f} ms/{unit} of device time, idle share "
          f"{out['idle_share']:.3f}, {out['launches']:.1f} kernel launches and "
          f"{copies:.1f} copies and sets per {unit}; K5 {out['k5_ms']:.4f} ms "
          f"({out['k5_share']:.4f} of device time)")
    return out


# ------------------------------------------------------- K5, tri-plane mode


@contextlib.contextmanager
def composite_inputs():
    """Records the inputs of the first tri-plane composite inside the block
    (``render.volume.composite``: sigma, dist, rgb, z, the rays' last
    component, the background, the threshold, whether w is written) and,
    when a backward follows, the cotangents of its rgb_map and acc: the
    path's own inputs for K5's tri-plane rows."""
    from ngf_tpu_torch.render import volume

    seen: dict = {}
    real = volume.composite

    def spy(sigma, dist, rgb, z, ray_last, background, thres, weights=False):
        out = real(sigma, dist, rgb, z, ray_last, background, thres, weights)
        if "sigma" not in seen:
            seen.update(sigma=sigma.detach(), rgb=rgb.detach(), z=z, ray_last=ray_last,
                        dist=dist.detach() if isinstance(dist, torch.Tensor) else dist,
                        background=background, thres=thres, weights=weights)
            def keep(name):
                def hook(g):
                    if g is not None:
                        seen[name] = g.detach()
                return hook

            for name, t in (("g_rgb", out[0]), ("g_acc", out[1])):
                if t.requires_grad:
                    t.register_hook(keep(name))
        return out

    volume.composite = spy
    try:
        yield seen
    finally:
        volume.composite = real


def k5_triplane_bound_ms(n: int, s: int, backward: bool, per_sample_dist: bool,
                         weights: bool) -> tuple[float, str]:
    """Least time of one K5 tri-plane launch: each input read once and each
    output written once over HBM, its arithmetic over the float32 rate.
    Forward: sigma, z (4 bytes), dist (4, none for the grouped constant)
    and rgb (12) read a sample, w (4) written when asked; the rays' last
    component (4) read and rgb_map, y (12 each), acc and depth (4 each)
    written a ray; ~30 operations a sample (exp ~10, the scan, the sums).
    Backward: sigma, dist, rgb read, d sigma (4) and d rgb (12) written a
    sample; y, the cotangents of rgb_map (12 each) and acc (4) read a ray;
    ~45 operations a sample."""
    dist = 4 if per_sample_dist else 0
    if backward:
        nbytes = n * s * (4 + dist + 12 + 4 + 12) + n * 28
        ops = 45 * n * s
    else:
        nbytes = n * s * (4 + dist + 4 + 12 + (4 if weights else 0)) + n * 36
        ops = 30 * n * s
    return bytes_bound_ms(nbytes, ops)


def k5_triplane_rows(case: str, c: dict) -> list[dict]:
    """K5's tri-plane mode on a path's own inputs (``composite_inputs``):
    forward and, with the step's cotangents, backward against
    ``composite_plain`` / ``composite_backward_plain`` (acc, depth, w,
    gradients to F32_TOL of each one's scale; rgb_map and y against the
    plain sums under the kernel's own mask, the samples whose w falls the
    other side of the threshold counted and their rays left out of the
    gradients' comparison), timed by CUDA events (the wrapper's host time
    at these sizes) and in a CUDA graph (device time) beside the bound and
    the plain versions. The plain forward is the ``cumprod`` chain the
    renderers ran before K5; ``before_fwd_bwd_ms`` times it forward and
    backward through autograd. No single PyTorch call computes the
    composite: ``library_ms`` is null."""
    from ngf_tpu_torch.ops import compositing, cuda_kernels

    sigma, dist, rgb, z, last = c["sigma"], c["dist"], c["rgb"], c["z"], c["ray_last"]
    bg, thres, weights = c["background"], c["thres"], c["weights"]
    n, s = sigma.shape
    per_sample = isinstance(dist, torch.Tensor)

    def fwd(want_w=weights):
        return cuda_kernels.ray_march_triplane(sigma, dist, rgb, z, last, bg, thres, want_w)

    def plain():
        return compositing.composite_plain(sigma, dist, rgb, z, last, bg, thres)

    rgb_map, y, acc, depth, _ = fwd()
    w = fwd(True)[4]
    p_map, p_y, p_acc, p_depth, p_w = plain()
    flips = (w > thres) != (p_w > thres)
    y_mine = ((p_w * (w > thres).to(w.dtype))[..., None] * rgb).sum(-2)
    if bg is not None:
        y_mine = y_mine + bg * (1.0 - p_acc[:, None])
    errs, scales = {}, {}
    for what, a, b in (("rgb_map", rgb_map, y_mine.clamp(0.0, 1.0)), ("y", y, y_mine),
                       ("acc", acc, p_acc), ("depth", depth, p_depth), ("w", w, p_w)):
        errs[what] = (a - b).abs().max().item()
        scales[what] = b.abs().max().item()
        check(errs[what] <= F32_TOL * scales[what],
              f"K5 tri-plane forward {case} {what}: {errs[what]} against {scales[what]}")
    check(bool(((p_w[flips] - thres).abs() <= 1e-5 * thres).all()),
          f"K5 tri-plane {case}: a mask bit flipped far from the threshold")
    train = "g_rgb" in c
    bound, by = k5_triplane_bound_ms(n, s, False, per_sample, weights)
    reps = 20
    row = {"case": case, "N": n, "S": s, "direction": "forward", "weights": weights,
           "per_sample_dist": per_sample, "background": None if bg is None else (
               "drawn" if isinstance(bg, torch.Tensor) else float(bg)),
           "ms": cuda_ms(fwd, reps), "graph_ms": graph_ms(fwd), "bound_ms": bound, "bound_by": by,
           "plain_ms": cuda_ms(plain, 5), "library_ms": None,
           "max_abs_err": max(errs.values()), "errs": errs, "scales": scales,
           "mask_flips": int(flips.sum().item()),
           "shaded_share": (w > thres).float().mean().item()}
    rows = [row]
    if train:
        g_rgb, g_acc = c["g_rgb"], c.get("g_acc")
        args = (sigma, dist, rgb, bg, thres)

        def before_fwd_bwd():
            s_, c_ = sigma.clone().requires_grad_(True), rgb.clone().requires_grad_(True)
            out = compositing.composite_plain(s_, dist, c_, z, last, bg, thres)
            torch.autograd.backward([out[0], out[2]], [
                g_rgb, torch.zeros_like(out[2]) if g_acc is None else g_acc])

        got = cuda_kernels.ray_march_triplane_backward(*args, y, g_rgb, g_acc)
        want = compositing.composite_backward_plain(*args, p_y, g_rgb, g_acc)
        ok = ~flips.any(-1)
        b_errs = {}
        for what, a, b in zip(("d sigma", "d rgb"), got, want):
            b_errs[what] = (a[ok] - b[ok]).abs().max().item()
            scale = b[ok].abs().max().item()
            check(b_errs[what] <= F32_TOL * scale,
                  f"K5 tri-plane backward {case} {what}: {b_errs[what]} against {scale}")
        bound, by = k5_triplane_bound_ms(n, s, True, per_sample, weights)
        bwd = lambda: cuda_kernels.ray_march_triplane_backward(*args, y, g_rgb, g_acc)  # noqa: E731
        rows.append({
            "case": case, "N": n, "S": s, "direction": "backward",
            "ms": cuda_ms(bwd, reps), "graph_ms": graph_ms(bwd),
            "bound_ms": bound, "bound_by": by,
            "plain_ms": cuda_ms(lambda: compositing.composite_backward_plain(
                *args, p_y, g_rgb, g_acc), 3),
            "library_ms": None, "before_fwd_bwd_ms": cuda_ms(before_fwd_bwd, 5),
            "max_abs_err": max(b_errs.values()), "errs": b_errs,
            "rays_compared": int(ok.sum().item())})
        rows[1]["kernel_fwd_bwd_graph_ms"] = row["graph_ms"] + rows[1]["graph_ms"]
    for r in rows:
        print(f"[k5] tri-plane {r['direction']} {case} (N={n} x {s}): {r['ms']:.5f} ms, in a "
              f"CUDA graph {r['graph_ms']:.5f}, bound {r['bound_ms']:.5f} ({r['bound_by']}, "
              f"{r['bound_ms'] / r['graph_ms']:.1%} of the graph's), plain "
              f"{r['plain_ms']:.4f} ms"
              + (f", before {r['before_fwd_bwd_ms']:.4f} ms forward and backward"
                 if 'before_fwd_bwd_ms' in r else "") + ", max abs err "
              f"{r['max_abs_err']:.3g}" + (f", mask flips {r['mask_flips']}, shaded "
                                           f"{r['shaded_share']:.4f}" if 'mask_flips' in r else ""))
    return rows


def step_k5_rows(case: str, fn) -> list[dict]:
    """K5's tri-plane rows on the composite inputs of ``fn()`` (a render
    chunk, or a train step's gradients with its cotangents)."""
    with composite_inputs() as seen:
        fn()
    check("sigma" in seen, f"{case}: no tri-plane composite ran")
    return k5_triplane_rows(case, seen)


def ball_volume(res: int, device: torch.device, seed: int = SEED) -> torch.Tensor:
    """(res, res, res) uint8 occupancy like an event's: a ball of radius 0.6
    in [-1, 1]^3 with 2% of the voxels flipped, dilated by one voxel."""
    from ngf_tpu_torch.ops.grid_sample import max_pool_3d

    ax = torch.linspace(-1.0, 1.0, res, device=device)
    z, y, x = torch.meshgrid(ax, ax, ax, indexing="ij")
    gen = torch.Generator(device=device).manual_seed(seed)
    vol = (x * x + y * y + z * z < 0.36) ^ (torch.rand(x.shape, generator=gen, device=device) < 0.02)
    return (max_pool_3d(vol.float(), 3) > 0).to(torch.uint8)


AABB = ((-1.5,) * 3, (1.5,) * 3)


def grouped_inputs(device: torch.device, scattered: bool = True, train: bool = True):
    """(rays, jitter, n_samples, step) of a grouped render: TRAIN_RAYS lego
    rays (a training batch's, scattered, or a render chunk's middle rays),
    the trainer's 886 samples with one jitter a ray or an evaluation's 884
    without."""
    from ngf_tpu_torch.utils.grid import cal_n_samples, grid_n_samples, grid_step_size

    step = grid_step_size(AABB, [256] * 3, 0.5)
    S = cal_n_samples([256] * 3, 0.5) if train else grid_n_samples(AABB, step)
    gen = torch.Generator(device=device).manual_seed(SEED)
    if scattered:
        rays = chunk_rays(WH, WH * WH, device)
        rays = rays[torch.randperm(WH * WH, generator=gen, device=device)[:TRAIN_RAYS]]
    else:
        rays = chunk_rays(WH, TRAIN_RAYS, device)
    jitter = torch.rand((TRAIN_RAYS, 1), generator=gen, device=device) if train else None
    return rays, jitter, S, step


def grouped_valid(rays, jitter, S: int, step: float, vol=None):
    """(z (n, s_pad), valid (n, s_pad)) of the grouped path before its
    compaction, as the plain front end makes them: the samples, the trailing
    sample invalid, padded to groups of 8, and with a volume its two queries
    a group (:func:`query_points`)."""
    from ngf_tpu_torch.ops.grid_sample import occupancy_lookup_plain
    from ngf_tpu_torch.ops.rays import stratified_sample

    aabb = torch.tensor(AABB, device=rays.device)
    n = rays.shape[0]
    _, z, valid = stratified_sample(rays[:, :3], rays[:, 3:], aabb, 2.0, 6.0, S, step, jitter)
    valid[:, S - 1] = False
    pad = -(-S // GROUP) * GROUP - S
    z = torch.cat([z, z[:, -1:].expand(-1, pad)], 1)
    valid = torch.cat([valid, valid.new_zeros((n, pad))], 1)
    if vol is not None:
        occ = occupancy_lookup_plain(vol, query_points(rays, z), aabb)
        valid = (valid.view(n, -1, GROUP // 2) & occ[..., None]).view(n, -1)
    return z, valid


def query_points(rays: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The grouped path's occupancy query points: two a group, at its
    quarter and three-quarter samples."""
    zq = z[:, GROUP // 4 :: GROUP // 2]
    return rays[:, None, :3] + rays[:, None, 3:] * zq[..., None]


def march(rays: torch.Tensor, S: int, step: float) -> torch.Tensor:
    """(n, S, 3) sample points of the rays, as the mask event's filter and
    counts and the dense render march them: one contiguous array."""
    from ngf_tpu_torch.ops.rays import stratified_sample

    aabb = torch.tensor(AABB, device=rays.device)
    return stratified_sample(rays[:, :3], rays[:, 3:], aabb, 2.0, 6.0, S, step)[0]


def k3_row(case: str, vol: torch.Tensor, pts: torch.Tensor, aabb, time_it: bool) -> dict:
    """K3 on one point set against its plain version, byte for byte; timed
    beside its bound and ``F.grid_sample`` of the float volume: ``ms`` by
    CUDA events over back-to-back calls (the host's call where it is the
    longer), ``device_ms`` the kernel's device time (:func:`graph_ms`)."""
    from ngf_tpu_torch.ops.cuda_kernels import occupancy_lookup
    from ngf_tpu_torch.ops.grid_sample import normalize_coord, occupancy_lookup_plain

    got = occupancy_lookup(vol, pts, aabb)
    torch.cuda.synchronize()
    ref = occupancy_lookup_plain(vol, pts, aabb)
    bad = (got != ref).sum().item()
    check(bad == 0, f"K3 {case}: {bad} of {ref.numel()} lookups differ from the plain version")
    row = {"case": case, "volume": list(vol.shape), "N": ref.numel(),
           "contiguous": pts.is_contiguous(), "occupied_share": ref.float().mean().item(),
           "mismatches": bad, "max_abs_err": 0.0}
    if time_it:
        coords = pts if aabb is None else normalize_coord(pts, aabb)
        lib_vol = vol.float()[None, None]
        lib_grid = coords.reshape(1, -1, 1, 1, 3).contiguous()
        del coords

        def library():
            return F.grid_sample(lib_vol, lib_grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=True)

        lib = library()[0, 0, :, 0, 0] > 0
        check(torch.equal(lib.reshape(ref.shape), ref), f"K3 {case} vs F.grid_sample > 0")
        del lib
        n = ref.numel()
        # Each point read once (12 bytes) and its byte written once, the
        # volume read once.
        bound_ms, bound_by = bytes_bound_ms(13 * n + vol.numel(), K3_OPS_PER_POINT * n)
        row.update(ms=cuda_ms(lambda: occupancy_lookup(vol, pts, aabb), reps=50),
                   device_ms=graph_ms(lambda: occupancy_lookup(vol, pts, aabb)),
                   plain_ms=cuda_ms(lambda: occupancy_lookup_plain(vol, pts, aabb), reps=3),
                   library_ms=cuda_ms(library, reps=20), bound_ms=bound_ms, bound_by=bound_by)
    print("[occupancy] K3 " + json.dumps(row))
    return row


# Operations of the fused front end (K4): a walked sample's depth, point and
# box test, an occupancy query (normalise, three axes, eight tap weights) and
# a kept sample's depth, point and normalisation, float32.
K4_OPS_PER_SAMPLE, K4_OPS_PER_QUERY, K4_OPS_PER_SLOT_SAMPLE = 15, 70, 18


def k4_bound_ms(groups: torch.Tensor, capg: int, vol, jitter) -> tuple[float, str]:
    """The fused K4's least time on this data: the outputs (depth, mask and
    three coordinates, 20 bytes a slot sample) written once, the rays, the
    jitter and the volume read once; the operations of the groups walked up
    to each ray's capg-th valid group (or all)."""
    n, ng = groups.shape
    cnt = groups.int().cumsum(-1)
    full = cnt[:, -1] >= capg
    walked = torch.where(full, (cnt < capg).sum(-1) + 1, torch.full_like(cnt[:, -1], ng))
    walked = walked.sum().item()
    nbytes = (20 * n * capg * GROUP + 24 * n + (0 if jitter is None else 4 * n)
              + (0 if vol is None else vol.numel()))
    ops = (walked * (GROUP * K4_OPS_PER_SAMPLE + (0 if vol is None else 2 * K4_OPS_PER_QUERY))
           + n * capg * GROUP * K4_OPS_PER_SLOT_SAMPLE)
    return bytes_bound_ms(nbytes, ops)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Byte for byte, a NaN against a NaN whatever its payload."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(
        a.view(torch.int32)[~nan], b.view(torch.int32)[~nan])


def k4_row(case: str, rays, jitter, S: int, step: float, capg: int, vol) -> dict:
    """The fused K4 against its plain version, byte for byte; timed (as the
    renderer calls it, without idx and got; ``ms`` and ``device_ms`` as in
    :func:`k3_row`) beside its bound and a stable ``torch.argsort`` of the
    group keys (the library's compaction order)."""
    from ngf_tpu_torch.ops.compaction import group_sample_compact_plain
    from ngf_tpu_torch.ops.cuda_kernels import group_sample_compact

    aabb = torch.tensor(AABB, device=rays.device)
    args = (rays, jitter, aabb, 2.0, 6.0, S, step, GROUP, capg, vol,
            None if vol is None else aabb)
    got = group_sample_compact(*args, indices=True)
    torch.cuda.synchronize()
    ref = group_sample_compact_plain(*args)
    for a, b, what in zip(got, ref, ("idx", "got", "z_c", "vmask", "xyz_n")):
        check(same_bits(a, b), f"K4 {case}: {what} differs from the plain version")
    del got, ref
    n = rays.shape[0]
    groups = grouped_valid(rays, jitter, S, step, vol)[1].view(n, -1, GROUP).any(-1)
    key = (~groups).int()
    bound_ms, bound_by = k4_bound_ms(groups, capg, vol, jitter)
    row = {
        "case": case, "n": n, "groups": groups.shape[1], "capg": capg, "masked": vol is not None,
        "truncated_share": (groups.sum(-1) > capg).float().mean().item(),
        "mean_valid_groups": groups.sum(-1).float().mean().item(), "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: group_sample_compact(*args), reps=50),
        "device_ms": graph_ms(lambda: group_sample_compact(*args)),
        "plain_ms": cuda_ms(lambda: group_sample_compact_plain(*args), reps=3),
        "library_ms": cuda_ms(lambda: torch.argsort(key, dim=-1, stable=True), reps=20),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    print("[occupancy] K4 " + json.dumps(row))
    return row


class _AtK1(Exception):
    """Raised in place of K1's launch: the render's front end is over."""


def front_end_time(render, reps: int = 20) -> dict:
    """The front end of one grouped render as the renderer runs it, from its
    start to its K1 launch (which is not made): the CUDA-event interval from
    the start of ``reps`` back-to-back renders to the last one's K1 call, per
    render (``ms``: the front end's time on the stream, the host's launch time
    included where it is the longer), and under the profiler its device
    time, its kernels and its copies and sets per render."""
    from torch.autograd import DeviceType

    from ngf_tpu_torch.ops import cuda_kernels

    k1 = cuda_kernels.bilinear_gather_planes
    marks = []

    def at_k1(*args, **kwargs):
        mark = torch.cuda.Event(enable_timing=True)
        mark.record()
        marks.append(mark)
        raise _AtK1

    def front():
        try:
            render()
        except _AtK1:
            pass

    cuda_kernels.bilinear_gather_planes = at_k1
    try:
        for _ in range(3):
            front()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            front()
        torch.cuda.synchronize()
        ms = start.elapsed_time(marks[-1]) / reps
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                front()
            torch.cuda.synchronize()
    finally:
        cuda_kernels.bilinear_gather_planes = k1
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    copies = [e for e in device if e.key.startswith(("Memcpy", "Memset"))]
    return {"ms": ms, "device_ms": sum(e.self_device_time_total for e in device) / 1e3 / reps,
            "kernels": (sum(e.count for e in device) - sum(e.count for e in copies)) / reps,
            "copies_and_sets": sum(e.count for e in copies) / reps}


def front_end_rows(device: torch.device) -> list[dict]:
    """The grouped render's front end at the staged recipe's shapes, as
    ``render_rays`` runs it (:func:`front_end_time`): a masked train step
    (cap 224, the 128^3 ball), an open one (capg 64) and a masked evaluation
    chunk (all 111 groups). The model is a small random InfoInv tri-plane:
    the front end reads no weight. Only the renderer's entry points are
    called, so the rows of two versions of the port compare in one run."""
    from ngf_tpu_torch.fields.triplane import TriPlaneConfig, init_triplane
    from ngf_tpu_torch.render.volume import RenderConfig, render_rays

    cfg = dataclasses.replace(TriPlaneConfig.infoinv_preset(infoinv=True), plane_res=16)
    params = init_triplane(cfg, torch.Generator(device=device).manual_seed(SEED), device)
    vol = ball_volume(128, device)
    aabb = torch.tensor(AABB, device=device)
    rows = []
    for case, train, cap, masked in (("masked step (cap 224)", True, 224, True),
                                     ("open step (capg 64)", True, 512, False),
                                     ("evaluation chunk (all groups)", False, 0, True)):
        rays, _, S, step = grouped_inputs(device, scattered=train, train=train)
        rcfg = RenderConfig(aabb=AABB, n_samples=S, step_size=step, group_size=GROUP,
                            sample_cap=cap)
        kw = {"alpha_volume": vol, "alpha_aabb": aabb} if masked else {}
        gen = torch.Generator(device=device).manual_seed(SEED) if train else None
        row = {"case": case, **front_end_time(
            lambda: render_rays(params, cfg, rcfg, rays, generator=gen, **kw))}
        print("[occupancy] front end " + json.dumps(row))
        rows.append(row)
    return rows


def masked_step_row(device: torch.device) -> dict:
    """A masked grouped train step of the staged recipe on random weights
    (the density bias of `make_checkpoint`) and one 128 x 128 view, the
    128^3 ball as its mask and its measured cap 224: ms/step by CUDA events,
    then under the profiler its host-clock ms, device ms, idle share and
    launches per step. Masked compute makes the step's work independent of
    the weights. Only the trainer's entry points are called, so two versions
    of the port compare in one run."""
    from ngf_tpu_torch.config import config_parser
    from ngf_tpu_torch.data import load_dataset
    from ngf_tpu_torch.train.loop import TriPlaneTrainer
    from ngf_tpu_torch.train.occupancy import AlphaGrid

    datadir = f"synthetic:views=1,wh={TRAIN_WH}"
    args = config_parser([
        "--config", os.path.join(os.path.dirname(os.path.abspath(__file__)), TRAIN_CONFIG),
        "--datadir", datadir, "--device", device.type,
    ])
    trainer = TriPlaneTrainer(args, load_dataset("synthetic", datadir, split="train",
                                                 is_stack=False), device=device)
    with torch.no_grad():
        trainer.params["density_decoder"]["mlp"]["layers"][-1]["b"].fill_(
            density_bias(trainer.model_cfg))
    trainer._event_update_alpha_mask(first=True)  # the L1 weight and the sampler
    trainer.alpha = AlphaGrid.from_volume(ball_volume(128, device).float(),
                                          torch.tensor(AABB, device=device))
    trainer._auto_cap = 224
    step = lambda: trainer.train_step(*trainer.next_batch(), trainer.gen)  # noqa: E731
    row = {"case": "masked step (cap 224), random weights", "ms": cuda_ms(step, reps=10),
           **profile_chunk(step, reps=3, unit="masked step")}
    print("[occupancy] " + json.dumps(row))
    return row


def occupancy_phase(device: torch.device) -> dict:
    """K3 against its plain version at the shapes it keeps, and the fused
    K4 against its plain version at the staged recipe's, timed; the grouped
    front end and a masked step as the renderer and trainer run them."""
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    aabb = torch.tensor(AABB, device=device)
    rays, jitter, S, step = grouped_inputs(device)
    z, _ = grouped_valid(rays, jitter, S, step)
    q = query_points(rays, z)
    n_q = q.shape[0] * q.shape[1]
    k3 = []
    for res in (128, 256):
        vol = ball_volume(res, device)
        rand = (torch.rand((n_q, 3), generator=gen, device=device) * 2.0 - 1.0) * 1.05
        lattice = torch.floor(torch.rand((n_q, 3), generator=gen, device=device) * res)
        half = 0.5 * torch.randint(-1, 2, (n_q, 3), generator=gen, device=device)
        k3.append(k3_row(f"random {res}^3", vol, rand, None, time_it=False))
        k3.append(k3_row(f"texel centres and edges {res}^3", vol,
                         (lattice + half) * (2.0 / (res - 1)) - 1.0, None, time_it=False))
        k3.append(k3_row(f"train step query {res}^3", vol, q, aabb, time_it=True))
        # The same points read where they lie in the padded samples: a view.
        pts = rays[:, None, :3] + rays[:, None, 3:] * z[..., None]
        k3.append(k3_row(f"train step query, strided view {res}^3", vol,
                         pts[:, GROUP // 4 :: GROUP // 2], aabb, time_it=False))
        del pts
    # The point clouds K3 keeps, at a 128^3 mask: a filter chunk of the
    # event (51,200 rays x 256 samples), a count chunk (16,384 x 886) and a
    # render-only chunk of the dense path (4096 x 884).
    vol = ball_volume(128, device)
    every = chunk_rays(WH, WH * WH, device)
    every = every[torch.randperm(WH * WH, generator=gen, device=device)]
    for case, n, samples in (("filter chunk", 51200, 256), ("count chunk", 16384, S),
                             ("render-only chunk", TRAIN_RAYS, 884)):
        k3.append(k3_row(f"{case} 128^3", vol, march(every[:n], samples, step), aabb,
                         time_it=True))
    del every
    # The fused K4 at the staged recipe's shapes: a masked step at its
    # measured cap 224 (capg 28) and at capg 64, an open step (capg 64) and
    # a masked evaluation chunk (all 111 groups).
    k4 = [k4_row("masked step (cap 224)", rays, jitter, S, step, 28, vol),
          k4_row("masked step (capg 64)", rays, jitter, S, step, 64, vol),
          k4_row("open step (capg 64)", rays, jitter, S, step, 64, None)]
    rays_e, _, S_e, _ = grouped_inputs(device, scattered=False, train=False)
    k4.append(k4_row("evaluation chunk (all groups)", rays_e, None, S_e, step,
                     -(-S_e // GROUP), vol))
    return {"k3": k3, "k4": k4, "front_end": front_end_rows(device),
            "masked_step": masked_step_row(device)}


def staged_phase(
    device: torch.device, views: int = TRAIN_VIEWS, wh: int = TRAIN_WH, extra: tuple[str, ...] = (),
    config: str = TRAIN_CONFIG, tag: str = "staged", full: bool = True,
) -> dict:
    """``main_torch.main`` on a staged InfoInv recipe (``config``, argv
    ``extra`` after it), its mask events, launches, losses and checkpoint
    checked; then one masked step with the kernels against the plain
    sampler. ``full`` adds the two stages' ms/step by CUDA events, the
    masked step's profile and the checkpoint through the render-only CLI.
    With top-K shading (``rgb_cap``), K5's top-K rows and the group
    gather's (:func:`topk_step_rows`) on the masked step, profiled.
    ``extra`` also shrinks the run for the CPU test. The result holds the
    checkpoint's parameters and mask under ``model``."""
    import main_torch
    from ngf_tpu_torch.config import config_parser
    from ngf_tpu_torch.convert import named_leaves
    from ngf_tpu_torch.data import load_dataset
    from ngf_tpu_torch.ops import cuda_kernels
    from ngf_tpu_torch.train.loop import TriPlaneTrainer
    from ngf_tpu_torch.train.occupancy import AlphaGrid
    from ngf_tpu_torch.utils.checkpoint import load_checkpoint
    from ngf_tpu_torch.utils.lpips import lpips_available

    cuda = device.type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        argv = [
            "--config", os.path.join(os.path.dirname(os.path.abspath(__file__)), config),
            "--datadir", f"synthetic:views={views},wh={wh},test_views=1", "--render_test", "1",
            "--basedir", tmp, "--expname", tag, "--progress_refresh_rate", "100",
            "--device", device.type, *extra,
        ]
        args = config_parser(argv)
        iters = args.n_iters
        event_its = sorted({e for e in args.update_AlphaMask_list if 0 < e <= iters})
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        stats = main_torch.main(argv)
        main_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in cuda_kernels.KERNELS.items()}
        mses, events = stats["train_mses"], stats["events"]
        print(f"[{tag}] main_torch.main: {main_s:.3f} s ({stats['wall_time_s']:.3f} s in the "
              f"train loop), {iters} steps, launches {launches}, test psnr {stats['test_psnrs']}")
        print(f"[{tag}] events {json.dumps(events)}")
        print(f"[{tag}] stages {json.dumps(stats['stages'])}")
        check(len(mses) == iters and all(math.isfinite(m) for m in mses), f"losses {mses}")
        check_stages_fall(mses, [0, *event_its, iters])
        check([(e["kind"], e["iteration"], e["first"]) for e in events]
              == [("mask", it, i == 0) for i, it in enumerate(event_its)], f"events {events}")
        for ev in events:
            # Something occupied, and at the recipe's size on the card
            # something culled (a tiny run's field can be uniform).
            check(0 < ev["voxels"] <= ev["grid_voxels"]
                  and (ev["voxels"] < ev["grid_voxels"] or not cuda), f"voxels {ev}")
            check(0 < ev["rays_kept"] <= ev["rays_before"], f"rays {ev}")
            cap = args.masked_sample_cap if args.masked_sample_cap > 0 else None
            check((ev["sample_cap"] == cap) if cap else (
                32 <= ev["sample_cap"] <= ev["n_samples"]
                and (ev["sample_cap"] % 32 == 0 or ev["sample_cap"] == ev["n_samples"])),
                f"capacity {ev}")
            check(ev["capg"] == -(-ev["sample_cap"] // args.group_size), f"groups {ev}")
        for ev in events[1:]:  # later events keep the ray set
            check(not ev["refiltered"] and ev["rays_kept"] == events[0]["rays_kept"],
                  f"a later event's rays {ev}")
        psnr = stats["test_psnrs"]
        check(len(psnr) == 1 and math.isfinite(psnr[0]), f"test psnr {psnr}")
        run = os.path.join(tmp, tag)
        for f in ("model.npz", "imgs_test_all/000.png"):
            check(os.path.isfile(os.path.join(run, f)), f"training wrote no {f}")
        videos = check_videos(os.path.join(run, "imgs_test_all"), 1)
        # [PSNR] or [PSNR, SSIM, LPIPS-alex, LPIPS-vgg]; LPIPS NaN only
        # without weights.
        stats_txt = np.loadtxt(os.path.join(run, "imgs_test_all", "mean.txt"), ndmin=1)
        lpips_on = all(lpips_available(net) for net in ("alex", "vgg"))
        check(stats_txt.shape == ((4,) if args.compute_extra_metrics else (1,))
              and np.isfinite(stats_txt[:2]).all()
              and (np.isfinite(stats_txt[2:]).all() if lpips_on else np.isnan(stats_txt[2:]).all()),
              f"mean.txt {stats_txt}")
        ckpt = os.path.join(run, "model.npz")
        params, meta, vol, vaabb = load_checkpoint(ckpt, device)
        r = args.alpha_grid_res
        check(vol is not None and tuple(vol.shape) == (r, r, r)
              and int(vol.sum().item()) == events[-1]["voxels"], "model.npz without the mask")
        check(all(t.dtype == torch.float32 for _, t in named_leaves(params)),
              "model.npz parameters not float32")
        stage_ms = {f"{st['from']}-{st['to']}": 1e3 * st["s"] / (st["to"] - st["from"])
                    for st in stats["stages"]}
        ev = events[0]
        if args.export_mesh:
            # The mesh of the trained field: parsed, every vertex inside the
            # box (the trainer's last, which the checkpoint holds).
            verts = read_ply_vertices(os.path.join(run, "mesh.ply"))
            box = np.asarray(meta["aabb"])
            check(len(verts) > 0 and len(verts) == stats["export"]["vertices"]
                  and (verts >= box[0] - 1e-4).all() and (verts <= box[1] + 1e-4).all(),
                  f"mesh.ply: {len(verts)} vertices, {stats['export']}, box {box.tolist()}")
            print(f"[{tag}] mesh export: {json.dumps(stats['export'])}")
        result = {"main_s": main_s, "launches": launches, "mses": mses, "event": ev,
                  "videos": videos, "mean_txt": stats_txt.tolist(), "export": stats.get("export"),
                  "model": (params, meta, vol, vaabb), "args": args,
                  "events": events, "stages": stats["stages"], "stage_ms": stage_ms,
                  "test_psnr": psnr[0], "loop_s": stats["wall_time_s"],
                  "compute_dtype": args.compute_dtype,
                  "shaded_groups_p999": stats["shaded_groups_p999"]}
        if cuda:
            result["launches_want"] = want = staged_launches(args, events, wh)
            check(launches == want, f"launches {launches}, expected {want}")
            result["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
            print(f"[{tag}] stage ms/step on the host clock {json.dumps(stage_ms)}")

        if full:
            # The checkpoint through the render-only CLI: the dense path with
            # its mask, one K1 and one K3 launch per chunk.
            cuda_kernels.reset_launch_counts()
            psnrs = main_torch.main([
                "--render_only", "1", "--render_test", "1", "--ckpt", ckpt, "--dataset_name",
                "synthetic", "--datadir", f"synthetic:wh={wh},test_views=1", "--eval_chunk",
                str(args.eval_chunk), "--compute_extra_metrics", "0", "--expname", "render",
                "--device", device.type,
            ])
            r_launches = {k: fn.launches for k, fn in cuda_kernels.KERNELS.items()}
            chunks = -(-wh * wh // args.eval_chunk)
            print(f"[{tag}] render-only CLI on the checkpoint: psnr {psnrs}, launches "
                  f"{r_launches}")
            check(len(psnrs) == 1 and math.isfinite(psnrs[0]), f"render-only psnr {psnrs}")
            if cuda:
                check(r_launches["occupancy_lookup"] == chunks
                      and r_launches["bilinear_gather_planes"] == chunks
                      and r_launches["ray_march_triplane"] == chunks
                      and r_launches["group_sample_compact"] == 0,
                      f"render-only launches {r_launches}")
            result["render"] = {"psnr": psnrs[0], "launches": r_launches, "chunks": chunks}

    # One batch of one view through the same configuration: a masked
    # grouped step with the kernels against the plain sampler, then the
    # open and the masked stages' ms/step.
    ds = load_dataset("synthetic", f"synthetic:views=1,wh={wh}", split="train", is_stack=False)
    trainer = TriPlaneTrainer(args, ds, init_params=params, device=device)
    step = lambda: trainer.train_step(*trainer.next_batch(), trainer.gen)  # noqa: E731
    grads = lambda: trainer.compute_grads(*trainer.next_batch(), trainer.gen)  # noqa: E731
    if cuda and full:
        result["open_step_ms"] = cuda_ms(step, reps=10, warmup=2)
        result["k5_open"] = step_k5_rows("open grouped step", grads)
    trainer._event_update_alpha_mask(first=True)  # this view's rays and the L1 weight
    trainer.alpha = AlphaGrid.from_volume(vol, vaabb)
    trainer._auto_cap = events[-1]["sample_cap"]
    trainer._auto_rgb_cap = next((e["auto_rgb_cap"] for e in reversed(events)
                                  if "auto_rgb_cap" in e), 0)
    rays, rgbs = trainer.next_batch()
    result["compare"] = compare_step(trainer, rays, rgbs, case="masked step")
    if cuda and grouped_topk(args, events, args.n_iters):
        result["topk"] = topk_step_rows(trainer, f"{tag} masked step")
    elif cuda and full:
        result["packed"] = packed_step_rows(trainer, f"{tag} masked step")
    if cuda and full:
        torch.cuda.reset_peak_memory_stats(device)
        result["masked_step_ms"] = cuda_ms(step, reps=10, warmup=2)
        result["masked_step_peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        print(f"[{tag}] open stage {result['open_step_ms']:.3f} ms/step (cap "
              f"{args.open_sample_cap}), masked stage {result['masked_step_ms']:.3f} ms/step "
              f"(cap {ev['sample_cap']}, capg {ev['capg']}), event phases "
              f"{json.dumps(ev['phases_s'])}, peak {result['peak_gib']:.2f} GiB over the run")
        result["masked_step_profile"] = profile_chunk(step, reps=2, unit="masked step")
        result["k5_masked"] = step_k5_rows("masked grouped step", grads)
        trainer.optimizer.zero_grad()
    return result


def check_stages_fall(mses: list[float], bounds: list[int], start: int = 0) -> None:
    """The mean MSE of the last steps of each stage between ``bounds``
    (iterations; ``mses[0]`` is the loss of step ``start + 1``) lies below
    that of its first steps."""
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        part = mses[lo - start:hi - start]
        k = max(1, min(20, len(part) // 4))
        first, last = sum(part[:k]) / k, sum(part[-k:]) / k
        check(last < first, f"stage {lo}-{hi}: mse of the last {k} steps {last} >= first {first}")


def grouped_topk(args, events: list[dict], it: int) -> bool:
    """Whether a grouped render at iteration ``it`` (step ``it``, or an
    evaluation after it, before that iteration's events) shades top-K: the
    capacity ``rgb_cap`` resolves to (`TriPlaneTrainer._resolve_rgb_cap`;
    -2 the last pick of the events before ``it``, 0 before any) is under the
    groups the render keeps."""
    G = args.group_size
    fired = [e for e in events if e["kind"] == "mask" and e["iteration"] < it]
    if fired:
        cap, capg = fired[-1]["sample_cap"], fired[-1]["capg"]
    else:
        cap = args.sample_cap if args.sample_cap != -1 else args.open_sample_cap
    if args.rgb_cap == -2:
        rgb = next((e["auto_rgb_cap"] for e in reversed(fired) if "auto_rgb_cap" in e), 0)
    elif args.rgb_cap == -1:
        rgb = max(32, cap // 4) if cap else 0
    else:
        rgb = max(0, args.rgb_cap)
    if rgb <= 0:
        return False
    if not fired:
        ng = -(-events[0]["n_samples"] // G)
        capg = min(ng, -(-(cap or events[0]["n_samples"]) // G))
    return min(capg, max(1, rgb // G)) < capg


def staged_launches(args, events: list[dict], wh: int, start: int = 0) -> dict:
    """The launches a staged run must make: per step (microbatch chunks)
    one K1, six K2 and one K4 (the grouped front end, the occupancy test
    after the first event included), and one ``gather_rows``; per mask event
    its K1 (grid chunks), and K3: the first event's filter chunks, a later
    event's grid chunks (the lattice pre-culled by the last grid), and every
    event's count chunks; ``gather_rows`` for the first event's rebuilt
    table and for every event's count subsample; per evaluation chunk one K1
    and one K4; one K5 tri-plane composite per step (and its backward) and
    per evaluation chunk. A run resumed at ``start`` makes the steps and
    evaluations after it, and one ``gather_rows`` more: the kept rays'
    table rebuilt at the checkpoint's ids. ``--export_mesh`` adds the mesh
    export's K1 launches (EXPORT_LAUNCHES). A step or evaluation chunk with
    top-K shading (:func:`grouped_topk`) composites with K5's weight launch
    (counted as the tri-plane composite) and top-K colour pass, gathers its
    picks with one ``gather_rows`` and, without ``fused_fetch``, fetches
    their appearance with a second K1; a step also launches the colour
    pass's backward and, with ``fused_fetch`` (the gathered features take a
    gradient), one ``scatter_rows``. Every other step chunk is packed: two
    ``gather_rows`` (its kept groups' coordinates and view directions) and
    two ``scatter_rows`` (sigma and colour back into the slot layout)
    forward, and the scatters' backward, two ``gather_rows``. The final
    evaluation shades densely."""
    micro = max(1, args.microbatch)
    iters = args.n_iters - start
    r = args.alpha_grid_res
    grid_chunks = -(-r ** 3 // (256 * 256 * 8))
    k3 = rows = 0
    for ev in events:
        counted = min(ev["rays_kept"], 65536) if args.sample_cap == -1 else 0
        k3 += (-(-ev["rays_before"] // 51200) if ev["first"] else grid_chunks) + -(-counted // 16384)
        rows += int(ev["refiltered"]) + int(ev["rays_kept"] > 65536 and args.sample_cap == -1)
    rows += int(start > 0)
    chunks = -(-wh * wh // args.eval_chunk)  # one test view
    vis = [v for v in range(args.vis_every, args.n_iters + 1, args.vis_every) if v > start] if (
        args.N_vis != 0 and args.vis_every > 0) else []
    evals = len(vis) + 1  # and the final one
    topk = micro * sum(grouped_topk(args, events, i) for i in range(start + 1, args.n_iters + 1))
    topk_evals = chunks * sum(grouped_topk(args, events, v) for v in vis)
    second_fetch = 0 if args.fused_fetch else topk + topk_evals
    packed = micro * iters - topk
    export = EXPORT_LAUNCHES if args.export_mesh else 0
    return {
        "bilinear_gather_planes": (micro * iters + len(events) * grid_chunks + evals * chunks
                                   + second_fetch + export),
        "bilinear_gather_2d": 0,
        "bilinear_gather_2d_backward": 6 * micro * iters,
        "bilinear_gather_planes_backward_coords": 0,
        "gather_rows": iters + rows + topk + topk_evals + 4 * packed,
        "occupancy_lookup": k3,
        "group_sample_compact": micro * iters + evals * chunks,
        "ray_march": 0,
        "ray_march_backward": 0,
        "ray_march_triplane": micro * iters + evals * chunks,
        "ray_march_triplane_backward": micro * iters,
        **NO_MODE_LAUNCHES,
        "ray_march_triplane_topk": topk + topk_evals,
        "ray_march_triplane_topk_backward": topk,
        "scatter_rows": (topk if args.fused_fetch else 0) + 2 * packed,
    }


# ------------------------------------------------- K5's top-K mode, row scatter

TOPK_SMOKE_CONFIG = "configs/synthetic_smoke.txt"
# The -2 run against the staged phase's dense run of the same seed: -2 is
# dense shading wherever the capacity covers the shaded groups, so the two
# differ by run noise (same-seed reruns differ 0.02-0.07 dB on an H100
# through K2's atomics; LEGO_PSNR_GAP_DB holds a resumed run to the same)
# and by the rays whose shaded groups pass the capacity.
TOPK_PSNR_GAP_DB = 0.3


@contextlib.contextmanager
def topk_inputs():
    """Records the inputs of the first top-K composite inside the block (the
    colour pass ``render.volume.composite_topk``: w, acc, the picks, the
    group, the picked samples' colours, the background, the threshold) and,
    when a backward follows, the cotangent of its rgb_map; and the first
    group gather (``render.volume.gather_group_rows``: the payload, the
    picks, the group, whether the payload takes a gradient)."""
    from ngf_tpu_torch.render import volume

    seen: dict = {}
    real_topk, real_gather = volume.composite_topk, volume.gather_group_rows

    def spy(w, acc, idx, group, rgb_k, background, thres):
        out = real_topk(w, acc, idx, group, rgb_k, background, thres)
        if "w" not in seen:
            seen.update(w=w.detach(), acc=acc.detach(), idx=idx, group=group,
                        rgb_k=rgb_k.detach(), background=background, thres=thres)
            if out.requires_grad:
                out.register_hook(lambda g: seen.setdefault("g_rgb", g.detach()))
        return out

    def spy_gather(x, idx, group):
        if "payload" not in seen:
            seen.update(payload=x.detach(), payload_idx=idx, payload_group=group,
                        payload_grad=x.requires_grad)
        return real_gather(x, idx, group)

    volume.composite_topk, volume.gather_group_rows = spy, spy_gather
    try:
        yield seen
    finally:
        volume.composite_topk, volume.gather_group_rows = real_topk, real_gather


def k5_topk_bound_ms(n: int, s: int, k: int, kg: int, backward: bool) -> tuple[float, str]:
    """Least time of one launch of K5's top-K colour pass: each input read
    once and each output written once over HBM. Forward, a ray: w at the K
    picked samples (4 bytes each), the K / G group ids (8), rgb_k (12 a
    slot) and acc (4) read, rgb_map and y (12 each) written; ~8 operations a
    slot. Backward, a ray: the same w, ids and rgb_k, y and the cotangent
    (12 each) read; the whole g_w row (4 a sample), d acc (4) and d rgb_k
    (12 a slot) written; ~12 operations a slot."""
    if backward:
        nbytes = n * (k * 16 + kg * 8 + 24 + s * 4 + 4 + k * 12)
        ops = 12 * n * k
    else:
        nbytes = n * (k * 16 + kg * 8 + 4 + 24)
        ops = 8 * n * k
    return bytes_bound_ms(nbytes, ops)


def k5_topk_rows(case: str, c: dict) -> list[dict]:
    """K5's top-K colour pass and its backward on a step's own inputs
    (:func:`topk_inputs`) against ``composite_topk_plain`` and
    ``composite_topk_backward_plain`` (to F32_TOL of each output's scale:
    both read the same w, so the mask is the same), timed by CUDA events
    and in a CUDA graph beside the bound and the plain versions. No single
    PyTorch call computes it: ``library_ms`` is null."""
    from ngf_tpu_torch.ops import compositing, cuda_kernels

    w, acc, idx, G, rgb_k = c["w"], c["acc"], c["idx"], c["group"], c["rgb_k"]
    bg, thres, g_rgb = c["background"], c["thres"], c["g_rgb"]
    n, s = w.shape
    k = rgb_k.shape[1]

    def fwd():
        return cuda_kernels.ray_march_triplane_topk(w, acc, idx, G, rgb_k, bg, thres)

    def plain():
        return compositing.composite_topk_plain(w, acc, idx, G, rgb_k, bg, thres)

    rgb_map, y = fwd()
    p_map, p_y = plain()

    def bwd():
        return cuda_kernels.ray_march_triplane_topk_backward(w, idx, G, rgb_k, bg, thres, y, g_rgb)

    def plain_bwd():
        return compositing.composite_topk_backward_plain(w, idx, G, rgb_k, bg, thres, p_y, g_rgb)

    rows = []
    for direction, got, want, fn, pfn in (("forward", (rgb_map, y), (p_map, p_y), fwd, plain),
                                          ("backward", bwd(), plain_bwd(), bwd, plain_bwd)):
        errs = {}
        for what, a, b in zip(("rgb_map", "y") if direction == "forward" else (
                "g_w", "d acc", "d rgb_k"), got, want):
            errs[what] = (a - b).abs().max().item()
            scale = b.abs().max().item()
            check(errs[what] <= F32_TOL * max(scale, 1e-30),
                  f"K5 top-K {direction} {case} {what}: {errs[what]} against {scale}")
        bound, by = k5_topk_bound_ms(n, s, k, idx.shape[1], direction == "backward")
        rows.append({"case": case, "N": n, "S": s, "K": k, "G": G, "direction": direction,
                     "ms": cuda_ms(fn, 20), "graph_ms": graph_ms(fn), "bound_ms": bound,
                     "bound_by": by, "plain_ms": cuda_ms(pfn, 5), "library_ms": None,
                     "max_abs_err": max(errs.values()), "errs": errs,
                     "shaded_share": (torch.gather(
                         w, 1, compositing._topk_samples(idx, G)) > thres).float().mean().item()})
    for r in rows:
        print(f"[topk] K5 top-K {r['direction']} {case} (N={n}, S={s}, K={k}, G={G}): "
              f"{r['ms']:.5f} ms, in a CUDA graph {r['graph_ms']:.5f}, bound {r['bound_ms']:.5f} "
              f"({r['bound_by']}, {r['bound_ms'] / r['graph_ms']:.1%} of the graph's), plain "
              f"{r['plain_ms']:.4f} ms, max abs err {r['max_abs_err']:.3g}")
    return rows


def group_gather_rows(case: str, x: torch.Tensor, idx: torch.Tensor, group: int) -> list[dict]:
    """The group gather of a step's own payload and picks as one
    ``gather_rows`` launch (rows ``ray * ng + id`` of the (n * ng, G * D)
    table) and its backward ``scatter_rows`` (a random cotangent: the cost
    does not depend on its values), each against its plain version byte for
    byte, timed beside its bound and the library calls: ``index_select`` for
    the gather, ``index_copy_`` into zeros for the scatter. Each row names
    the word its kernel moved (``lane_bytes``) and the scatter its route."""
    from ngf_tpu_torch.ops import cuda_kernels
    from ngf_tpu_torch.ops.gather import gather_rows_plain, scatter_rows_plain

    n, s, d = x.shape
    ng, k = s // group, idx.shape[1]
    tab = x.reshape(n * ng, group * d)
    flat = idx.reshape(-1)
    rows = flat + torch.arange(flat.shape[0], device=flat.device) // k * ng
    R, D = tab.shape
    B = flat.shape[0]
    e, i = tab.element_size(), flat.element_size()
    got = cuda_kernels.gather_rows(tab, flat, k, ng)
    check(torch.equal(got, gather_rows_plain(tab, flat, k, ng)), f"{case}: group gather")
    g = torch.randn((B, D), device=x.device,
                    generator=torch.Generator(device=x.device).manual_seed(SEED)).to(x.dtype)
    back = cuda_kernels.scatter_rows(g, flat, R, k, ng)
    check(torch.equal(back, scatter_rows_plain(g, flat, R, k, ng)), f"{case}: group scatter")
    out = []
    # Bytes once: the gather reads the picked rows and the ids and writes
    # the rows; the scatter reads the rows and the ids and writes the whole
    # gradient once.
    for name, fn, pfn, lib, nbytes, lane in (
            ("gather_rows", lambda: cuda_kernels.gather_rows(tab, flat, k, ng),
             lambda: gather_rows_plain(tab, flat, k, ng),
             lambda: torch.index_select(tab, 0, rows), B * (2 * D * e + i),
             cuda_kernels.rows_lane_bytes(tab, got)),
            ("scatter_rows", lambda: cuda_kernels.scatter_rows(g, flat, R, k, ng),
             lambda: scatter_rows_plain(g, flat, R, k, ng),
             lambda: tab.new_zeros((R, D)).index_copy_(0, rows, g), R * D * e + B * (D * e + i),
             cuda_kernels.rows_lane_bytes(g, back))):
        bound, by = bytes_bound_ms(nbytes, 0.0)
        row = {"kernel": name, "case": case, "table": [R, D], "B": B, "dtype": str(x.dtype),
               "lane_bytes": lane, "ms": cuda_ms(fn, 50, 5), "graph_ms": graph_ms(fn),
               "bound_ms": bound, "bound_by": by, "plain_ms": cuda_ms(pfn, 20),
               "library_ms": cuda_ms(lib, 50, 5), "max_abs_err": 0.0}
        if name == "scatter_rows":
            row["route"] = cuda_kernels.scatter_rows_route(k, ng)
        print(f"[topk] {name} {case}: table ({R}, {D}) {x.dtype}, {B} rows, {lane}-byte words"
              f"{', route ' + row['route'] if 'route' in row else ''}: {row['ms']:.5f} ms, in a "
              f"CUDA graph {row['graph_ms']:.5f}, bound {bound:.5f} ({by}), plain "
              f"{row['plain_ms']:.5f}, library {row['library_ms']:.5f}")
        out.append(row)
    return out


@contextlib.contextmanager
def packed_inputs():
    """Records the row traffic of the first packed training render inside
    the block: the slot ids of its kept groups (``render.volume._pack_map``),
    its two ``gather_rows`` (the (n * capg, G * 3) coordinate table and the
    view directions, strided rows of the batch) and its two ``scatter_rows``
    (the decoded sigma (m, G) and colour (m, G * 3) rows and the slot rows
    they are written into)."""
    from ngf_tpu_torch.render import volume

    seen: dict = {"gather": [], "scatter": []}
    real_map, real_gather, real_scatter = volume._pack_map, volume.gather_rows, volume.scatter_rows

    def spy_map(got):
        ids = real_map(got)
        seen.setdefault("map", (ids, int(got.sum()), tuple(got.shape)))
        return ids

    def spy_gather(tab, idx, *a):
        if len(seen["gather"]) < 2:
            seen["gather"].append((tab.detach(), idx))
        return real_gather(tab, idx, *a)

    def spy_scatter(src, idx, rows):
        if len(seen["scatter"]) < 2:
            seen["scatter"].append((src.detach(), idx, rows))
        return real_scatter(src, idx, rows)

    volume._pack_map, volume.gather_rows, volume.scatter_rows = spy_map, spy_gather, spy_scatter
    try:
        yield seen
    finally:
        volume._pack_map, volume.gather_rows, volume.scatter_rows = (real_map, real_gather,
                                                                     real_scatter)


def packed_step_rows(trainer, case: str) -> list[dict]:
    """The row kernels of one packed step of ``trainer`` on that step's own
    ids and rows: the forward's two ``gather_rows`` (coordinates, view
    directions) and two ``scatter_rows`` (sigma, colour: per 0, so the fill
    route), and the scatters' backward, ``gather_rows`` of a (random)
    cotangent of the slot layout at the same ids. Each against its plain
    version byte for byte, timed beside its bound (each row read and written
    once, each id read once; a scatter also writes its whole output once),
    the plain version and the library call (``index_select``; ``index_copy_``
    into new zeros), with the word its kernel moved and the scatter's route."""
    from ngf_tpu_torch.ops import cuda_kernels
    from ngf_tpu_torch.ops.gather import gather_rows_plain, scatter_rows_plain

    with packed_inputs() as seen:
        trainer.compute_grads(*trainer.next_batch(), trainer.gen)
    trainer.optimizer.zero_grad()
    check("map" in seen and len(seen["gather"]) == 2 and len(seen["scatter"]) == 2,
          f"{case}: no packed render ran ({ {k: len(v) for k, v in seen.items()} })")
    ids, kept, (n, capg) = seen["map"]
    check(ids.shape[0] == kept and 0 < kept < n * capg,
          f"{case}: {ids.shape[0]} packed rows for {kept} kept of {n * capg} groups")
    gen = torch.Generator(device=ids.device).manual_seed(SEED)
    cases = []
    for what, (tab, idx) in zip(("coordinates", "view directions"), seen["gather"]):
        cases.append(("gather_rows", f"{case}: {what}", tab, idx, None))
    for what, (src, idx, R) in zip(("sigma", "colour"), seen["scatter"]):
        cases.append(("scatter_rows", f"{case}: {what}", src, idx, R))
        g = torch.randn((R, src.shape[1]), generator=gen, device=src.device).to(src.dtype)
        cases.append(("gather_rows", f"{case}: {what}'s gradient (the scatter's backward)", g,
                      idx, None))
    out = []
    for name, label, a, idx, R in cases:
        B, D = idx.shape[0], a.shape[1]
        e, i = a.element_size(), idx.element_size()
        if name == "gather_rows":
            fn = lambda a=a, idx=idx: cuda_kernels.gather_rows(a, idx)  # noqa: E731
            pfn = lambda a=a, idx=idx: gather_rows_plain(a, idx)  # noqa: E731
            lib = lambda a=a, idx=idx: torch.index_select(a, 0, idx)  # noqa: E731
            nbytes, table = B * (2 * D * e + i), [a.shape[0], D]
        else:
            fn = lambda a=a, idx=idx, R=R: cuda_kernels.scatter_rows(a, idx, R)  # noqa: E731
            pfn = lambda a=a, idx=idx, R=R: scatter_rows_plain(a, idx, R)  # noqa: E731
            lib = lambda a=a, idx=idx, R=R: a.new_zeros((R, D)).index_copy_(0, idx, a)  # noqa: E731
            nbytes, table = R * D * e + B * (D * e + i), [R, D]
        got = fn()
        check(torch.equal(got, pfn()), f"{label}: {name} differs from its plain version")
        bound, by = bytes_bound_ms(nbytes, 0.0)
        row = {"kernel": name, "case": label, "table": table, "B": B, "dtype": str(a.dtype),
               "row_stride": a.stride(0), "lane_bytes": cuda_kernels.rows_lane_bytes(a, got),
               "ms": cuda_ms(fn, 50, 5), "graph_ms": graph_ms(fn), "bound_ms": bound,
               "bound_by": by, "plain_ms": cuda_ms(pfn, 20), "library_ms": cuda_ms(lib, 50, 5),
               "max_abs_err": 0.0}
        if name == "scatter_rows":
            row["route"] = cuda_kernels.scatter_rows_route(0, 0)
        print(f"[packed] {name} {label}: table ({table[0]}, {D}) {a.dtype}, row stride "
              f"{a.stride(0)}, {B} rows of {n * capg} slots, {row['lane_bytes']}-byte words"
              f"{', route ' + row['route'] if 'route' in row else ''}: {row['ms']:.5f} ms, in a "
              f"CUDA graph {row['graph_ms']:.5f}, bound {bound:.5f} ({by}), plain "
              f"{row['plain_ms']:.5f}, library {row['library_ms']:.5f}")
        out.append(row)
    return out


def dense_topk_payload(device: torch.device, k: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """The dense path's top-K gather at ``rgb_cap`` k (group 1): a dense
    train step's (TRAIN_RAYS, TRAIN_CAP, 6) coordinates (three projections
    in [-1, 1]) and the k samples of largest random weight a ray."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    coords = torch.rand((TRAIN_RAYS, TRAIN_CAP, 6), generator=gen, device=device) * 2 - 1
    w = torch.rand((TRAIN_RAYS, TRAIN_CAP), generator=gen, device=device)
    return coords, torch.topk(w, k, dim=1).indices


def topk_step_rows(trainer, case: str) -> dict:
    """A masked top-K step of ``trainer``: K5's top-K rows on its own
    inputs and cotangent (:func:`k5_topk_rows`), the group gather and
    scatter on its own payload and picks (:func:`group_gather_rows`: the
    fused fetch's features, or without ``fused_fetch`` the coordinates,
    whose gather takes no gradient on the InfoInv path, so that its scatter
    is timed there but not launched), and the step profiled: no
    ``cumprod``, its launches and idle share. Where the payload takes a
    gradient (the fused features) also the same payload and picks in
    bfloat16, and the dense path's group-1 gather of 6-float coordinates
    (:func:`dense_topk_payload`)."""
    with topk_inputs() as seen:
        trainer.compute_grads(*trainer.next_batch(), trainer.gen)
    trainer.optimizer.zero_grad()
    check("w" in seen and "g_rgb" in seen and "payload" in seen,
          f"{case}: no top-K composite ran")
    out = {"k5": k5_topk_rows(case, seen), "payload_grad": seen["payload_grad"]}
    out["rows"] = group_gather_rows(case, seen["payload"], seen["payload_idx"],
                                    seen["payload_group"])
    if seen["payload_grad"]:
        out["rows"] += group_gather_rows(f"{case}, bfloat16",
                                         seen["payload"].to(torch.bfloat16),
                                         seen["payload_idx"], seen["payload_group"])
        coords, picks = dense_topk_payload(seen["payload"].device)
        out["rows"] += group_gather_rows(f"dense top-K coordinates, {TRAIN_RAYS} x {TRAIN_CAP}",
                                         coords, picks, 1)
    step = lambda: trainer.train_step(*trainer.next_batch(), trainer.gen)  # noqa: E731
    out["step_ms"] = cuda_ms(step, reps=10, warmup=2)
    out["profile"] = profile_chunk(step, reps=2, unit="top-K masked step")
    out["profile"]["topk_kernels"] = {k: v for k, v in out["profile"]["k5_kernels"].items()
                                      if k.startswith("topk")}
    return out


def stride_render(model, args, device: torch.device, wh: int, strides=(1, 4)) -> dict:
    """The masked model of a checkpoint rendered on the dense path
    (``group_size 0``, its full sample count) with each ``mask_stride``:
    one K3 launch a chunk (at 1/K of the samples with stride K) beside one
    K1 and one K5, the test view's PSNR and ms a chunk."""
    from ngf_tpu_torch.data import load_dataset
    from ngf_tpu_torch.fields.triplane import TriPlaneConfig
    from ngf_tpu_torch.ops import cuda_kernels
    from ngf_tpu_torch.render.volume import RenderConfig, render_rays
    from ngf_tpu_torch.utils.grid import grid_n_samples

    params, meta, vol, vaabb = model
    model_cfg = TriPlaneConfig(**meta["model_cfg"])
    test = load_dataset("synthetic", f"synthetic:wh={wh},test_views=1", split="test", is_stack=True)
    rays = torch.from_numpy(np.asarray(test.all_rays[0]).reshape(-1, 6)).to(device)
    gt = torch.from_numpy(np.asarray(test.all_rgbs[0]).reshape(-1, 3)).to(device)
    occ = (vol > 0).to(torch.uint8)
    chunk = args.eval_chunk
    chunks = -(-rays.shape[0] // chunk)
    out = {}
    for k in strides:
        rcfg = RenderConfig(aabb=tuple(map(tuple, meta["aabb"])), near=meta["near_far"][0],
                            far=meta["near_far"][1],
                            n_samples=grid_n_samples(meta["aabb"], meta["step_size"]),
                            step_size=meta["step_size"], distance_scale=args.distance_scale,
                            ray_march_weight_thres=args.rm_weight_mask_thre, white_bg=True,
                            group_size=0, mask_stride=k)

        @torch.inference_mode()
        def render():
            return torch.cat([render_rays(params, model_cfg, rcfg, rays[i:i + chunk],
                                          iteration=args.n_iters + 1, alpha_volume=occ,
                                          alpha_aabb=vaabb)["rgb_map"]
                              for i in range(0, rays.shape[0], chunk)])

        cuda_kernels.reset_launch_counts()
        rgb = render()
        launches = _counts()
        psnr = -10.0 * math.log10(((rgb - gt) ** 2).mean().item())
        out[f"stride {k}"] = {"psnr": psnr, "n_samples": rcfg.n_samples}
        if device.type == "cuda":
            want = {**{n_: 0 for n_ in launches}, "occupancy_lookup": chunks,
                    "bilinear_gather_planes": chunks, "ray_march_triplane": chunks}
            check(launches == want, f"mask_stride {k}: launches {launches}, expected {want}")
            out[f"stride {k}"]["ms_per_chunk"] = cuda_ms(render, 2, 0) / chunks
    print(f"[topk] dense render of the masked model by mask_stride: {json.dumps(out)}")
    return out


def topk_phase(device: torch.device, views: int = TRAIN_VIEWS, wh: int = TRAIN_WH,
               staged: dict | None = None, extra: tuple[str, ...] = (),
               smoke_extra: tuple[str, ...] = ()) -> dict:
    """Top-K shading on the card, each run through :func:`staged_phase`
    (exact launch totals with the top-K steps, falling losses, a masked step
    against the plain sampler, and where it shades top-K, K5's top-K rows
    and the group gather's on its own inputs and the step profiled with no
    ``cumprod``):
    - `configs/synthetic_smoke.txt` as it is (grouped, ``rgb_cap 64``: 8 of
      its 64 groups shaded, ``fused_fetch 0``: the appearance fetched again
      at the picks, ``microbatch 4``, the mask event at 600);
    - ``configs/synthetic_infoinv_tpu.txt --rgb_cap 64`` (8 of the 28 masked
      groups; ``fused_fetch 1``: the fused fetch's features gathered, so
      ``scatter_rows`` runs in its backward);
    - ``configs/synthetic_infoinv_tpu.txt --rgb_cap -2`` (the capacity
      measured at the event) against the staged phase's dense run of the
      same seed (``staged``; run here without it). Its one event picks from
      the open stage's diffuse weights (p99.9 of 48 shaded groups), above
      the masked stage's 28: -2 then shades densely, the JAX package's
      finding too (`ngf_tpu/train/loop.py:354-361`).
    Then the -2 run's masked model rendered densely with ``mask_stride`` 1
    and 4. ``extra`` and ``smoke_extra`` shrink the runs for the CPU test."""
    smoke = staged_phase(device, views, wh, extra=smoke_extra, config=TOPK_SMOKE_CONFIG,
                         tag="topk_smoke", full=False)
    fused = staged_phase(device, views, wh, extra=("--rgb_cap", "64", *extra), tag="topk_fused",
                         full=False)
    if staged is None:
        staged = staged_phase(device, views, wh, extra=extra, full=False)
    auto = staged_phase(device, views, wh, extra=("--rgb_cap", "-2", *extra), tag="topk_auto",
                        full=False)
    check(smoke["args"].rgb_cap == 64 and not smoke["args"].fused_fetch
          and smoke["args"].microbatch == 4 and fused["args"].fused_fetch,
          f"smoke args {smoke['args']}, fused args {fused['args']}")
    picks = [e.get("auto_rgb_cap") for e in auto["events"]]
    check(all(p is not None and p > 0 and p % auto["args"].group_size == 0 for p in picks),
          f"auto rgb_cap picks {picks}")
    gap = abs(auto["test_psnr"] - staged["test_psnr"])
    masked = lambda r: next(v for k, v in r["stage_ms"].items()  # noqa: E731
                            if not k.startswith("0-"))
    out = {"smoke": smoke, "fused": fused, "auto": auto, "auto_rgb_caps": picks,
           "psnr_gap_db": gap, "dense_psnr": staged["test_psnr"], "auto_psnr": auto["test_psnr"],
           "smoke_psnr": smoke["test_psnr"], "fused_psnr": fused["test_psnr"],
           "masked_step_host_ms": {"-2": masked(auto), "dense": masked(staged),
                                   "64 fused": masked(fused), "smoke": masked(smoke)},
           "launches": {"topk smoke": smoke["launches"], "topk fused": fused["launches"],
                        "topk auto": auto["launches"]}}
    print(f"[topk] -2: picked {picks}, test psnr {auto['test_psnr']:.3f} dB against the dense "
          f"run's {staged['test_psnr']:.3f} (gap {gap:.3f}, limit {TOPK_PSNR_GAP_DB}); masked "
          f"step on the host clock {out['masked_step_host_ms']['-2']:.3f} ms against dense "
          f"{out['masked_step_host_ms']['dense']:.3f}; rgb_cap 64 on the staged recipe: test "
          f"psnr {fused['test_psnr']:.3f} dB, masked step {out['masked_step_host_ms']['64 fused']:.3f} "
          f"ms; smoke recipe test psnr {smoke['test_psnr']:.3f} dB, masked step "
          f"{out['masked_step_host_ms']['smoke']:.3f} ms (microbatch 4)")
    check(gap <= TOPK_PSNR_GAP_DB, f"-2 against dense: psnr gap {gap}")
    out["stride"] = stride_render(auto["model"], auto["args"], device, wh)
    return out


# ------------------------------------------------------------- LLFF (NDC)

LLFF_VIEWS, LLFF_WH, LLFF_ITERS = 24, 96, 400
LLFF_PATH_VIEWS = 4


def write_llff_scene(root: str, views: int, wh: int) -> dict:
    """A forward-facing scene in the LLFF layout (``poses_bounds.npy`` and
    ``images_4/``) from the analytic scene (``data/synthetic.py:_view_gt``):
    cameras on an arc at z ~ 4 looking at the origin, the headers at 4x the
    written frames (the loader's ``--downsample 4``), depth bounds [2.5, 5.5].
    Returns the host seconds it took."""
    from ngf_tpu_torch.data.geometry import get_ray_directions_blender
    from ngf_tpu_torch.data.synthetic import _view_gt
    from ngf_tpu_torch.utils.image import write_png

    t0 = time.perf_counter()
    os.makedirs(os.path.join(root, "images_4"), exist_ok=True)
    focal = 0.5 * wh / np.tan(0.5 * 0.6911112070083618)
    dirs = get_ray_directions_blender(wh, wh, [focal, focal])
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    rows = []
    for i in range(views):
        az = (i / max(1, views - 1) - 0.5) * 1.0
        eye = np.array([1.4 * np.sin(az), 0.35 * np.sin(2.1 * az), 4.0], np.float32)
        back = eye / np.linalg.norm(eye)
        right = np.cross(np.array([0.0, 1.0, 0.0], np.float32), back)
        right /= np.linalg.norm(right)
        up = np.cross(back, right)
        c2w = np.stack([right, up, back, eye], axis=1)
        rd = (dirs.reshape(-1, 3) @ c2w[:3, :3].T).astype(np.float32)
        ro = np.ascontiguousarray(np.broadcast_to(eye, rd.shape), np.float32)
        rgb = _view_gt(ro, rd, c2w, (wh, wh)).reshape(wh, wh, 3)
        write_png(os.path.join(root, "images_4", f"image{i:03d}.png"),
                  np.clip(rgb * 255.0 + 0.5, 0, 255).astype(np.uint8))
        raw = np.concatenate([np.stack([-up, right, back, eye], axis=1),
                              np.array([[4.0 * wh], [4.0 * wh], [4.0 * focal]], np.float32)], 1)
        rows.append(np.concatenate([raw.reshape(-1), [2.5, 5.5]]))
    np.save(os.path.join(root, "poses_bounds.npy"), np.stack(rows).astype(np.float64))
    return {"write_s": time.perf_counter() - t0}


def llff_phase(device: torch.device, views: int = LLFF_VIEWS, wh: int = LLFF_WH,
               iters: int = LLFF_ITERS, path_views: int = LLFF_PATH_VIEWS,
               extra: tuple[str, ...] = ()) -> dict:
    """A forward-facing scene in NDC: the LLFF layout written from the
    analytic scene (:func:`write_llff_scene`), read back through
    ``load_dataset("llff", ..., downsample=4)``, trained ``iters`` steps of
    the staged InfoInv recipe's open stage through ``main_torch.main
    --dataset_name llff`` (its mask event at 600 lies past the run: an
    event at 200 of 400 steps finds no occupied voxel yet on this scene and
    culls every sample; exact launch totals; falling losses; the held-out
    views rendered), then ``path_views`` views of the spiral path rendered through
    ``evaluation_path`` (NDC rays, frames written). ``extra`` may add events
    for the CPU test."""
    import main_torch
    from ngf_tpu_torch.config import config_parser
    from ngf_tpu_torch.data import load_dataset
    from ngf_tpu_torch.ops import cuda_kernels
    from ngf_tpu_torch.render.evaluation import evaluation_path
    from ngf_tpu_torch.train.loop import TriPlaneTrainer

    cuda = device.type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        scene = os.path.join(tmp, "scene")
        out = write_llff_scene(scene, views, wh)
        test = load_dataset("llff", scene, split="test", downsample=4.0, is_stack=True)
        check(test.img_wh == (wh, wh) and test.ndc_params[:2] == (wh, wh)
              and test.n_images == -(-views // 8), f"llff test split {test.img_wh} {test.n_images}")
        here = os.path.dirname(os.path.abspath(__file__))
        argv = ["--config", os.path.join(here, TRAIN_CONFIG), "--dataset_name", "llff",
                "--datadir", scene, "--downsample_train", "4", "--downsample_test", "4",
                "--n_iters", str(iters), "--vis_every", "0", "--save_every", "0", "--ndc_ray", "1", "--render_test", "1",
                "--basedir", tmp,
                "--expname", "llff", "--device", device.type, "--progress_refresh_rate", "100",
                *extra]
        args = config_parser(argv)
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        stats = main_torch.main(argv)
        out["main_s"] = time.perf_counter() - t0
        launches = _counts()
        mses, events = stats["train_mses"], stats["events"]
        print(f"[llff] main_torch.main: {out['main_s']:.3f} s ({stats['wall_time_s']:.3f} s in "
              f"the loop), {iters} steps, test psnr {stats['test_psnrs']}, events "
              f"{json.dumps(events)}, launches {launches}")
        check(len(mses) == iters and all(math.isfinite(m) for m in mses), f"llff losses {mses}")
        check_stages_fall(mses, [0, iters])  # one stage: half the batches' background is random
        check(len(stats["test_psnrs"]) == test.n_images
              and all(math.isfinite(p) for p in stats["test_psnrs"]), f"{stats['test_psnrs']}")
        if cuda:
            want = staged_launches(args, events, wh)
            chunks = -(-wh * wh // args.eval_chunk)
            for k in ("bilinear_gather_planes", "group_sample_compact", "ray_march_triplane"):
                want[k] += (test.n_images - 1) * chunks  # the final evaluation's views
            check(launches == want, f"llff launches {launches}, expected {want}")
        # The spiral path in NDC through the trained model.
        trainer = TriPlaneTrainer.from_checkpoint(os.path.join(tmp, "llff", "model.npz"), args,
                                                  load_dataset("llff", scene, split="train",
                                                               downsample=4.0, is_stack=False),
                                                  device=device)
        path = test.render_path[:: max(1, len(test.render_path) // path_views)][:path_views]
        t0 = time.perf_counter()
        evaluation_path(test, trainer.make_eval_render_fn(full=True), path,
                        os.path.join(tmp, "path"), chunk=args.eval_chunk)
        out["path_s"] = time.perf_counter() - t0
        frames = sorted(f for f in os.listdir(os.path.join(tmp, "path")) if f.endswith(".png"))
        check(frames == [f"{i:03d}.png" for i in range(path_views)], f"path frames {frames}")
        out["videos"] = check_videos(os.path.join(tmp, "path"), path_views)
        out.update(launches=launches, mses=[mses[0], mses[-1]], test_psnrs=stats["test_psnrs"],
                   events=events, stages=stats["stages"], frames=len(frames))
        print(f"[llff] loss {mses[0]:.5f} -> {mses[-1]:.5f}, {len(frames)} spiral views in "
              f"{out['path_s']:.3f} s, scene written in {out['write_s']:.3f} s")
    return out


GAUGE_CONFIG = "configs/synthetic_triplane_tpu.txt"
# The JAX package's own float32 results on this config (NOTES.md:124, :421):
# test PSNR band and the auto caps at the mask event and after the upsample.
JAX_GAUGE_PSNR_DB = (53.91, 55.59)
JAX_GAUGE_CAPS = (224, 352)
# Its bfloat16 certificate on configs/synthetic_triplane_tpu_bf16.txt
# (VERDICT.md:14, results/gauge_cert_bf16_r5).
JAX_GAUGE_BF16_PSNR_DB = 54.02
PLANE_NAMES = ("plane_xy", "plane_yz", "plane_xz")


def gauge_phase(
    device: torch.device, views: int = TRAIN_VIEWS, wh: int = TRAIN_WH, extra: tuple[str, ...] = (),
    config: str = GAUGE_CONFIG, tag: str = "gauge", full: bool = True,
) -> dict:
    """``main_torch.main`` on a learned-gauge recipe (``config`` as it is:
    the gauge on at 400, the mask event with the shrink at 600, the upsample
    at 800): its events, launches, losses, gauge grids and checkpoint
    checked; then one step after ``gauge_start`` with the kernels against
    the plain sampler (the loss and every gradient), K2c on that step's own
    cotangents and the upsampled stage's step by CUDA events. ``full`` adds
    K1 on the step's planes of three shapes, the checkpoint through the
    render-only CLI and the step's profile. ``extra`` argv shrinks the run
    for the CPU test."""
    import numpy as np

    import main_torch
    from ngf_tpu_torch.config import config_parser
    from ngf_tpu_torch.data import load_dataset
    from ngf_tpu_torch.ops import cuda_kernels
    from ngf_tpu_torch.train.loop import TriPlaneTrainer
    from ngf_tpu_torch.train.occupancy import AlphaGrid
    from ngf_tpu_torch.utils.checkpoint import load_checkpoint
    from ngf_tpu_torch.utils.lpips import lpips_available

    cuda = device.type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        argv = [
            "--config", os.path.join(os.path.dirname(os.path.abspath(__file__)), config),
            "--datadir", f"synthetic:views={views},wh={wh},test_views=1", "--render_test", "1",
            "--basedir", tmp, "--expname", tag, "--progress_refresh_rate", "100",
            "--device", device.type, *extra,
        ]
        args = config_parser(argv)
        iters = args.n_iters
        mask_it = min(e for e in args.update_AlphaMask_list if 0 < e <= iters)
        up_it = min(e for e in args.upsamp_list if 0 < e <= iters)
        check(args.subsystem == "triplane" and 0 < args.gauge_start < mask_it < up_it,
              f"gauge recipe {args.subsystem}, gauge {args.gauge_start}, events {mask_it}, "
              f"{up_it}")
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        stats = main_torch.main(argv)
        main_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in cuda_kernels.KERNELS.items()}
        mses, events = stats["train_mses"], stats["events"]
        print(f"[{tag}] main_torch.main: {main_s:.3f} s ({stats['wall_time_s']:.3f} s in the "
              f"train loop), {iters} steps, launches {launches}, test psnr {stats['test_psnrs']}")
        print(f"[{tag}] events {json.dumps(events)}")
        print(f"[{tag}] stages {json.dumps(stats['stages'])}")
        check(len(mses) == iters and all(math.isfinite(m) for m in mses), f"losses {mses}")
        for name, part in (("open", mses[:mask_it]), ("shrunk", mses[mask_it:up_it]),
                           ("upsampled", mses[up_it:])):
            k = max(1, min(20, len(part) // 4))
            first, last = sum(part[:k]) / k, sum(part[-k:]) / k
            check(last < first, f"{name} stage: mse of the last {k} steps {last} >= first {first}")
        check([(e["kind"], e["iteration"]) for e in events] == [("mask", mask_it),
                                                               ("upsample", up_it)],
              f"events {events}")
        mask, up = events
        check(0 < mask["voxels"] <= mask["grid_voxels"] and "shrink" in mask
              and 0 < mask["rays_kept"] <= mask["rays_before"], f"mask event {mask}")
        shrink = mask["shrink"]
        check(all(0 < g <= args.plane_res for g in shrink["grid_size"]), f"shrink {shrink}")
        for ev in events:
            check(32 <= ev["sample_cap"] <= ev["n_samples"]
                  and ev["capg"] == -(-ev["sample_cap"] // args.group_size), f"capacity {ev}")
        psnr = stats["test_psnrs"]
        check(len(psnr) == 1 and math.isfinite(psnr[0]), f"test psnr {psnr}")
        run = os.path.join(tmp, tag)
        for f in ("model.npz", "imgs_test_all/000.png"):
            check(os.path.isfile(os.path.join(run, f)), f"training wrote no {f}")
        check_videos(os.path.join(run, "imgs_test_all"), 1)
        ckpt = os.path.join(run, "model.npz")
        params, meta, vol, vaabb = load_checkpoint(ckpt, device)
        shapes = [list(params[n].shape) for n in PLANE_NAMES]
        rx, ry, rz = up["grid_size"]
        check(shapes == [[ry, rx, 64], [rz, ry, 64], [rz, rx, 64]] == up["plane_shapes"]
              and meta["aabb"] == shrink["aabb"] and vol is not None,
              f"model.npz planes {shapes}, box {meta['aabb']}")
        gauge_max = {n: params[n].abs().max().item() for n in ("gauge_xy", "gauge_yz", "gauge_xz")}
        check(all(v > 0 for v in gauge_max.values()), f"gauge grids not trained: {gauge_max}")
        lo, hi = JAX_GAUGE_PSNR_DB
        print(f"[{tag}] {args.compute_dtype} test psnr {psnr[0]:.3f} dB (the JAX package's "
              f"float32 band on the recipe: {lo}-{hi} dB, its bfloat16 reading "
              f"{JAX_GAUGE_BF16_PSNR_DB} dB); caps {mask['sample_cap']} -> {up['sample_cap']} (JAX "
              f"package: {JAX_GAUGE_CAPS[0]} -> {JAX_GAUGE_CAPS[1]}); shrink {json.dumps(shrink)}; "
              f"upsample grid {up['grid_size']}; gauge grids' largest |offset| "
              f"{json.dumps(gauge_max)}")
        stage_ms = {f"{st['from']}-{st['to']}": 1e3 * st["s"] / (st["to"] - st["from"])
                    for st in stats["stages"]}
        result = {"main_s": main_s, "launches": launches, "mses": mses, "events": events,
                  "stages": stats["stages"], "stage_ms": stage_ms, "test_psnr": psnr[0],
                  "jax_psnr_band_db": JAX_GAUGE_PSNR_DB, "loop_s": stats["wall_time_s"],
                  "plane_shapes": shapes, "gauge_max": gauge_max,
                  "compute_dtype": args.compute_dtype}
        if cuda:
            result["launches_want"] = want = gauge_launches(args, events, wh)
            check(launches == want, f"launches {launches}, expected {want}")
            result["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30

        if full:
            # The checkpoint through the render-only CLI: the dense path with
            # its mask, per chunk one K1 launch for the gauge grids and one
            # for the planes of three shapes, and one K3.
            cuda_kernels.reset_launch_counts()
            psnrs = main_torch.main([
                "--render_only", "1", "--render_test", "1", "--ckpt", ckpt, "--dataset_name",
                "synthetic", "--datadir", f"synthetic:wh={wh},test_views=1", "--eval_chunk",
                str(args.eval_chunk), "--compute_extra_metrics", "0", "--expname", "render",
                "--device", device.type,
            ])
            r_launches = {k: fn.launches for k, fn in cuda_kernels.KERNELS.items()}
            chunks = -(-wh * wh // args.eval_chunk)
            print(f"[{tag}] render-only CLI on the checkpoint: psnr {psnrs}, launches "
                  f"{r_launches}")
            check(len(psnrs) == 1 and math.isfinite(psnrs[0]), f"render-only psnr {psnrs}")
            if cuda:
                want = {k: 0 for k in r_launches}
                want.update(bilinear_gather_planes=2 * chunks, occupancy_lookup=chunks,
                            ray_march_triplane=chunks)
                check(r_launches == want, f"render-only launches {r_launches}, expected {want}")
            result["render"] = {"psnr": psnrs[0], "launches": r_launches, "chunks": chunks}

    # One batch of one view through the trained model at its geometry after
    # the events: a masked grouped step after gauge_start with the kernels
    # against the plain sampler, every gradient compared.
    ds = load_dataset("synthetic", f"synthetic:views=1,wh={wh}", split="train", is_stack=False)
    trainer = TriPlaneTrainer(args, ds, init_params=params, device=device)
    trainer.aabb = np.asarray(meta["aabb"], np.float32)
    trainer.grid_size, trainer.step_size = meta["grid_size"], meta["step_size"]
    trainer.n_samples = meta["n_samples"]
    trainer.alpha = AlphaGrid.from_volume(vol, vaabb)
    trainer._auto_cap = up["sample_cap"]
    trainer.iteration = iters
    rays, rgbs = trainer.next_batch()
    result["compare"] = compare_gauge_step(trainer, rays, rgbs)
    if cuda:
        step = lambda: trainer.train_step(*trainer.next_batch(), trainer.gen)  # noqa: E731
        result["upsampled_step_ms"] = cuda_ms(step, reps=10, warmup=2)
        print(f"[{tag}] stage ms/step on the host clock {json.dumps(stage_ms)}; the upsampled "
              f"stage's step on the trained weights {result['upsampled_step_ms']:.3f} ms by "
              f"CUDA events (cap {up['sample_cap']}, capg {up['capg']}); event phases: mask "
              f"{json.dumps(mask['phases_s'])}, upsample {json.dumps(up['phases_s'])}; peak "
              f"{result['peak_gib']:.2f} GiB over the run")
    if cuda and full:
        result["k1_three_shapes"] = three_shape_row(
            [trainer.params[n].detach() for n in PLANE_NAMES], result["compare"]["coords"])
        result["packed"] = packed_step_rows(trainer, f"{tag} upsampled step")
        result["upsampled_step_profile"] = profile_chunk(step, reps=2, unit="upsampled gauge step")
        result["k5_upsampled"] = step_k5_rows(
            "upsampled gauge step",
            lambda: trainer.compute_grads(*trainer.next_batch(), trainer.gen))
        trainer.optimizer.zero_grad()
    return result


def three_shape_row(planes: list[torch.Tensor], coords) -> dict:
    """K1 over the trained planes of three shapes at a step's deformed
    coordinates (split 16), against its plain version (1e-5) and the three
    one-plane ``F.grid_sample`` calls the library needs for planes of
    different shapes, timed beside its bound."""
    from ngf_tpu_torch.ops.cuda_kernels import bilinear_gather_planes
    from ngf_tpu_torch.ops.grid_sample import grid_sample_planes_plain

    coords = [c.reshape(-1, 2).contiguous() for c in coords]
    n = coords[0].shape[0]
    got = bilinear_gather_planes(planes, coords, split=16)
    ref = grid_sample_planes_plain(planes, coords, split=16)
    err = max((a - b).abs().max().item() for a, b in zip(got, ref))
    check(err <= F32_TOL, f"K1 three shapes err {err}")
    lib = [(p.permute(2, 0, 1)[None].contiguous(), c.view(1, n, 1, 2))
           for p, c in zip(planes, coords)]

    def library():
        return [F.grid_sample(p, c, mode="bilinear", padding_mode="zeros", align_corners=True)
                for p, c in lib]

    row = {"fetch": "fused", "case": "gauge step, three shapes",
           "shapes": [list(p.shape) for p in planes], "N": n, "C": 64, "split": 16,
           "max_abs_err": err,
           "ms": cuda_ms(lambda: bilinear_gather_planes(planes, coords, split=16), reps=20),
           "plain_ms": cuda_ms(lambda: grid_sample_planes_plain(planes, coords, split=16), reps=3),
           "library_ms": cuda_ms(library, reps=10)}
    row["bound_ms"], row["bound_by"] = bytes_bound_ms(
        n * 3 * 64 * 4 + 3 * 8 * n + sum(p.numel() for p in planes) * 4, 7 * n * 3 * 64 + 90 * n)
    print("[gauge] K1 " + json.dumps(row))
    return row


def compare_gauge_step(trainer, rays, rgbs) -> dict:
    """One gauge step's MSE and every gradient (planes, gauge grids,
    decoders) with the kernels and with the plain sampler on the same batch
    and jitter, to STEP_GRAD_REL_TOL of each leaf's largest. On the card,
    K2c also runs alone on this step's own cotangents and deformed
    coordinates of the three planes (``coords_row``, and the fetch's
    backward through autograd), and on the xy plane's alone. Returns the
    three planes' deformed coordinates under ``coords``."""
    from ngf_tpu_torch import convert

    dd = trainer.model_cfg.density_dim
    loss_rtol, grad_tol = step_tolerances(trainer)
    cotangents: dict[str, dict[str, torch.Tensor]] = {n: {} for n in PLANE_NAMES}
    deformed: dict[str, torch.Tensor] = {}

    def plain(p, c, name):
        out = plain_sample(p, c)
        if name.startswith("plane_") and out.requires_grad:
            deformed[name] = c.detach()
            fetch = "density" if p.shape[-1] == dd else "appearance"
            out.register_hook(lambda g: cotangents[name].__setitem__(fetch, g.detach()))
        return out

    mse, grads = {}, {}
    leaves = dict(convert.named_leaves(trainer.params))
    for how, fn in (("kernels", None), ("plain", plain)):
        gen = torch.Generator(device=rays.device).manual_seed(SEED)
        with cotangent_dtypes() as seen:
            mse[how] = trainer.compute_grads(rays, rgbs, gen, sample_fn=fn).item()
        grads[how] = {n: t.grad.clone() for n, t in leaves.items()}
        if how == "kernels":
            kernel_dtypes = {k: sorted(v) for k, v in seen.items()}
    trainer.optimizer.zero_grad()
    errs = {}
    for n, want in grads["plain"].items():
        scale = want.abs().max().item()
        errs[n] = {"max_abs_grad": scale,
                   "max_abs_err": (grads["kernels"][n] - want).abs().max().item()}
    out = {"mse": mse, "grads": errs, "cotangent_dtypes": kernel_dtypes}
    print("[gauge] step, kernels vs plain sampler: " + json.dumps(out))
    check(abs(mse["kernels"] - mse["plain"]) <= loss_rtol * abs(mse["plain"]),
          f"gauge step mse {mse}")
    for n, e in errs.items():
        check(e["max_abs_grad"] > 0 and e["max_abs_err"] <= grad_tol * e["max_abs_grad"],
              f"gauge step grad {n}: {e}")
    if rays.is_cuda:
        # The gauge grids' K2 at C = 2 stays float32, as in the JAX package.
        want = {"bilinear_gather_2d_backward": ["torch.float32"],
                "bilinear_gather_planes_backward_coords": [str(trainer.model_cfg.dtype)]}
        check(kernel_dtypes == want, f"cotangents handed to the kernels {kernel_dtypes}, "
                                     f"expected {want}")
    out["coords"] = [deformed[n] for n in PLANE_NAMES]
    if rays.is_cuda:
        n_pts = out["coords"][0].numel() // 2
        masters = [trainer.params[n].detach() for n in PLANE_NAMES]
        dtype = trainer.model_cfg.dtype
        planes = [p.to(dtype) for p in masters]
        coords = [c.reshape(n_pts, 2) for c in out["coords"]]
        g_a, g_b = (torch.stack([cotangents[n][f].reshape(n_pts, -1) for n in PLANE_NAMES], -2)
                    for f in ("density", "appearance"))
        out["backward"] = coords_row("gauge step's own cotangents, three planes", planes, coords,
                                     g_a, g_b)
        out["backward"]["autograd_ms"] = fetch_backward_ms(masters, coords, g_a, g_b, dtype=dtype)
        out["backward_xy"] = coords_row("gauge step's own cotangents", planes[:1], coords[:1],
                                        g_a[:, :1], g_b[:, :1])
    return out


def gauge_launches(args, events: list[dict], wh: int) -> dict:
    """The launches the gauge run must make: per step (microbatch chunks)
    two K1 (the gauge grids, then the planes at the deformed coordinates),
    three K2 (the gauge grids' plane gradients), one K2c (the three planes'
    plane and coordinate gradients) and one K4, and one ``gather_rows``; the
    mask event's two K1 per grid chunk, its K3 (filter and count chunks) and
    ``gather_rows`` (the rebuilt table, the count subsample); the upsample's
    K3 count chunks and subsample; per evaluation chunk two K1 and one K4;
    one K5 tri-plane composite per step (and its backward) and per
    evaluation chunk; per step chunk the packing's four ``gather_rows`` and
    two ``scatter_rows`` (:func:`staged_launches`)."""
    iters, micro = args.n_iters, max(1, args.microbatch)
    mask, up = events
    r = args.alpha_grid_res
    grid_chunks = -(-r ** 3 // (256 * 256 * 8))
    counted = min(mask["rays_kept"], 65536) if args.sample_cap == -1 else 0
    count_chunks = -(-counted // 16384)
    subsample = int(mask["rays_kept"] > 65536 and args.sample_cap == -1)
    chunks = -(-wh * wh // args.eval_chunk)  # one test view
    vis = [v for v in range(args.vis_every, iters + 1, args.vis_every)] if (
        args.N_vis != 0 and args.vis_every > 0) else []
    evals = len(vis) + 1  # and the final one
    steps = micro * iters
    return {
        "bilinear_gather_planes": 2 * steps + 2 * grid_chunks + 2 * evals * chunks,
        "bilinear_gather_2d": 0,
        "bilinear_gather_2d_backward": 3 * steps,
        "bilinear_gather_planes_backward_coords": steps,
        "gather_rows": iters + int(mask["refiltered"]) + 2 * subsample + 4 * steps,
        "occupancy_lookup": -(-mask["rays_before"] // 51200) + 2 * count_chunks,
        "group_sample_compact": steps + evals * chunks,
        "ray_march": 0,
        "ray_march_backward": 0,
        "ray_march_triplane": steps + evals * chunks,
        "ray_march_triplane_backward": steps,
        **NO_MODE_LAUNCHES,
        "scatter_rows": 2 * steps,
    }


BF16_INFOINV_CONFIG = "configs/synthetic_infoinv_tpu30k.txt"
# The JAX package's own cut of the 30k schedule that covers its three mask
# events at 300, 2000 and 2500 (NOTES.md:236-238).
BF16_INFOINV_ITERS = 3000
BF16_GAUGE_CONFIG = "configs/synthetic_triplane_tpu_bf16.txt"


def bf16_phase(device: torch.device, views: int = TRAIN_VIEWS, wh: int = TRAIN_WH,
               infoinv_extra: tuple[str, ...] = (), gauge_extra: tuple[str, ...] = ()) -> dict:
    """bfloat16 training through ``main_torch.main``: the 30k InfoInv
    schedule cut to its three mask events (``--n_iters 3000``, masked cap
    160 after each) and the bfloat16 gauge recipe as it is, each with its
    events, exact launch totals, falling losses per stage, float32
    checkpoint, stage ms/step and test PSNR, and one bfloat16 step with the
    kernels against the plain sampler (the loss and the gradients; the
    cotangents the backward kernels were handed must be bfloat16), with K2
    and K2c timed on that step's own bfloat16 cotangents. The ``extra``
    argv shrink the runs for a CPU rehearsal."""
    infoinv = staged_phase(device, views, wh, ("--n_iters", str(BF16_INFOINV_ITERS),
                                               *infoinv_extra),
                           config=BF16_INFOINV_CONFIG, tag="infoinv_bf16", full=False)
    gauge = gauge_phase(device, views, wh, gauge_extra, config=BF16_GAUGE_CONFIG,
                        tag="gauge_bf16", full=False)
    for run in (infoinv, gauge):
        check(run["compute_dtype"] == "bfloat16", f"compute dtype {run['compute_dtype']}")
    lo, hi = JAX_GAUGE_PSNR_DB
    print(f"[bf16] test psnr: 30k InfoInv cut {infoinv['test_psnr']:.3f} dB (caps "
          f"{[e['sample_cap'] for e in infoinv['events']]}); gauge {gauge['test_psnr']:.3f} dB "
          f"beside the JAX package's bfloat16 {JAX_GAUGE_BF16_PSNR_DB} dB and float32 band "
          f"{lo}-{hi} dB")
    return {"infoinv": infoinv, "gauge": gauge}


# ----------------------------------------------------------------- lego phase

# The north star's recipe (`configs/lego_infoinv_tpu.txt`: bfloat16, grouped,
# measured capacity, mask events at 300, 2000 and 2500, mask_stride 4, an
# evaluation at 2100) cut to 2600 steps, on a Blender-format scene written
# from the synthetic views: 800 / 6.25 = 128 pixels a side.
LEGO_CONFIG = "configs/lego_infoinv_tpu.txt"
LEGO_DOWNSAMPLE = 6.25
LEGO_ITERS, LEGO_SAVE_EVERY, LEGO_SIGTERM_AFTER = 2600, 500, 1000
# Same-seed reruns on the card differ by 0.02-0.07 dB (K2's atomics).
LEGO_PSNR_GAP_DB = 0.3


def write_blender_scene(root: str, views: int, wh: int, test_views: int = 1) -> dict:
    """The synthetic scene's views as a Blender-format scene under ``root``:
    ``transforms_{train,test}.json`` (``camera_angle_x`` from the views'
    focal, each pose a Blender-convention c2w) and RGBA PNGs (opaque).
    Returns each split's rays and the colours the PNGs hold, as the loader
    must read them back."""
    from ngf_tpu_torch.data import load_dataset
    from PIL import Image

    spec = f"synthetic:views={views},wh={wh},test_views={test_views}"
    out = {}
    for split in ("train", "test"):
        ds = load_dataset("synthetic", spec, split=split, is_stack=True)
        # The focal from the corner pixel's direction: x / -z = (0.5 - w/2) / f.
        d = ds.directions[0, 0]
        focal = (0.5 - wh / 2) / (float(d[0]) / -float(d[2]))
        frames, rgbs = [], []
        os.makedirs(os.path.join(root, split), exist_ok=True)
        for i, c2w in enumerate(ds.poses):
            rgb8 = np.round(np.clip(ds.all_rgbs[i], 0.0, 1.0) * 255.0).astype(np.uint8)
            rgba = np.concatenate([rgb8, np.full(rgb8.shape[:2] + (1,), 255, np.uint8)], -1)
            Image.fromarray(rgba, "RGBA").save(os.path.join(root, split, f"r_{i}.png"))
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": np.asarray(c2w, np.float64).tolist()})
            rgbs.append(rgb8.astype(np.float32) / 255.0)
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 2.0 * math.atan(0.5 * wh / focal), "frames": frames}, f)
        out[split] = {"rays": ds.all_rays, "rgbs": np.stack(rgbs)}
    return out


def _log_iteration(path: str) -> int:
    """The last iteration ``log.txt`` has reached (0 before its first line)."""
    if not os.path.exists(path):
        return 0
    with open(path) as f:
        its = [int(m.group(1)) for m in re.finditer(r"^Iteration (\d+):", f.read(), re.M)]
    return max(its, default=0)


def _same_trainers(a, b) -> dict:
    """What a trainer restored by ``from_checkpoint`` must equal in the
    trainer that saved it: parameters, optimizer leaves and counts, grid,
    ray table, generator state and the sampler's next ids (drawn from both)."""
    from ngf_tpu_torch.convert import sorted_named_leaves

    la, lb = a.optimizer.to_optax_leaves(), b.optimizer.to_optax_leaves()
    same = {
        "params": all(torch.equal(x, y) for (_, x), (_, y) in zip(
            sorted_named_leaves(a.params), sorted_named_leaves(b.params))),
        "optimizer": len(la) == len(lb) and all(np.array_equal(x, y) for x, y in zip(la, lb))
        and a.optimizer.count == b.optimizer.count,
        "occ": torch.equal(a.alpha.occ, b.alpha.occ),
        "batch_table": torch.equal(a.batch_table, b.batch_table),
        "generator": torch.equal(a.gen.get_state(), b.gen.get_state()),
        "next_ids": torch.equal(a.sampler.nextids(), b.sampler.nextids()),
    }
    check(all(same.values()), f"restored trainer differs: {same}")
    return same


def lego_phase(device: torch.device, views: int = TRAIN_VIEWS, wh: int = TRAIN_WH,
               iters: int = LEGO_ITERS, save_every: int = LEGO_SAVE_EVERY,
               sigterm_after: int = LEGO_SIGTERM_AFTER, downsample: float = LEGO_DOWNSAMPLE,
               extra: tuple[str, ...] = (), reps: int = 3) -> dict:
    """The lego recipe on a Blender-format scene written from the synthetic
    views (`write_blender_scene`), through ``main_torch.py``: a run
    SIGTERMed once ``log.txt`` passes ``sigterm_after`` (in a subprocess;
    exit 0, a resumable ``model.npz``), resumed with ``--ckpt`` to ``iters``
    across the later events (in this process: exact launch totals, events,
    falling losses), and an uninterrupted run (exact launch totals), whose
    test PSNRs must lie within ``LEGO_PSNR_GAP_DB``. Then a trainer restored
    from a checkpoint against the trainer that saved it (bit for bit, one
    more step's loss), and the full-width checkpoint's cost: seconds the
    loop is blocked by a synchronous and a background save, the file's
    size, ``from_checkpoint``'s seconds. ``extra`` argv shrink the runs for
    a CPU rehearsal."""
    import main_torch
    from ngf_tpu_torch.config import config_parser
    from ngf_tpu_torch.convert import named_leaves
    from ngf_tpu_torch.data import load_dataset
    from ngf_tpu_torch.ops import cuda_kernels
    from ngf_tpu_torch.train.loop import TriPlaneTrainer

    cuda = device.type == "cuda"
    here = os.path.dirname(os.path.abspath(__file__))
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        scene = os.path.join(tmp, "scene")
        t0 = time.perf_counter()
        written = write_blender_scene(scene, views, wh)
        for split in ("train", "test"):
            ds = load_dataset("blender", scene, split=split, downsample=downsample, is_stack=True)
            check(ds.img_wh == (wh, wh) and np.array_equal(ds.all_rgbs, written[split]["rgbs"]),
                  f"{split}: loaded colours differ from the written pixels")
            rays = ds.all_rays.reshape(-1, 6)
            check(np.isfinite(rays).all()
                  and np.abs(np.linalg.norm(rays[:, 3:], axis=-1) - 1.0).max() < 1e-5,
                  f"{split}: rays not finite and unit-norm")
            ray_err = float(np.abs(rays - written[split]["rays"].reshape(-1, 6)).max())
            check(ray_err < 1e-4, f"{split}: rays {ray_err} from the synthetic views'")
        out["scene_s"] = time.perf_counter() - t0
        print(f"[lego] Blender scene of {views} + 1 synthetic views at {wh}^2 written and read "
              f"back in {out['scene_s']:.3f} s (rays within {ray_err:.2e} of the synthetic ones)")

        def argv(expname: str) -> list[str]:
            return ["--config", os.path.join(here, LEGO_CONFIG), "--datadir", scene,
                    "--downsample_train", str(downsample), "--downsample_test", str(downsample),
                    "--n_iters", str(iters), "--save_every", str(save_every), "--basedir", tmp,
                    "--expname", expname, "--device", device.type, *extra]

        args = config_parser(argv("lego"))
        event_its = sorted({e for e in args.update_AlphaMask_list if 0 < e <= iters})
        check(args.dataset_name == "blender" and args.compute_dtype == "bfloat16"
              and args.group_size > 0 and args.sample_cap == -1, f"lego args {args}")

        # 1. SIGTERM once log.txt passes sigterm_after.
        run = os.path.join(tmp, "lego")
        log = os.path.join(tmp, "sigterm.log")
        t0 = time.perf_counter()
        with open(log, "w") as f:
            proc = subprocess.Popen([sys.executable, os.path.join(here, "main_torch.py"),
                                     *argv("lego")], cwd=here, stdout=f, stderr=subprocess.STDOUT,
                                    env={**os.environ, "PYTHONUNBUFFERED": "1"})
            sent_at = None
            try:
                while proc.poll() is None and time.perf_counter() - t0 < 900:
                    if sent_at is None and _log_iteration(os.path.join(run, "log.txt")) > sigterm_after:
                        proc.send_signal(signal.SIGTERM)
                        sent_at = _log_iteration(os.path.join(run, "log.txt"))
                    time.sleep(0.05)
            finally:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
        text = open(log).read()
        sub_s = time.perf_counter() - t0
        check(proc.returncode == 0 and sent_at is not None
              and "[trainer] preempted at iteration" in text,
              f"main_torch under SIGTERM: rc {proc.returncode}, sent at {sent_at}\n{text[-3000:]}")
        ckpt = os.path.join(run, "model.npz")
        with np.load(ckpt) as z:
            meta = json.loads(bytes(z["meta"]).decode())
        stopped = int(meta["iteration"])
        check(sigterm_after < stopped < iters and "resume" in meta, f"SIGTERM saved {stopped}")
        rows = [json.loads(line) for line in open(os.path.join(run, "scalars.jsonl"))]
        blocked = [(r["step"], r["ckpt/blocked_s"]) for r in rows if "ckpt/blocked_s" in r]
        check([s for s, _ in blocked] == list(range(save_every, stopped + 1, save_every)),
              f"periodic saves {blocked}")
        print(f"[lego] SIGTERM after log.txt passed {sigterm_after} (sent at {sent_at}): exit 0, "
              f"model.npz at {stopped}, {sub_s:.1f} s in the subprocess; periodic saves' blocked "
              f"seconds {blocked}")
        out["sigterm"] = {"stopped": stopped, "sent_at": sent_at, "subprocess_s": sub_s,
                          "blocked_s": blocked}

        # 2. Resume with --ckpt to the end, across the later events.
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        resumed = main_torch.main(argv("lego") + ["--ckpt", ckpt])
        resume_s = time.perf_counter() - t0
        launches = _counts()
        mses, events = resumed["train_mses"], resumed["events"]
        later = [e for e in event_its if e > stopped]
        check(resumed["iterations"] == iters and len(mses) == iters - stopped
              and all(math.isfinite(m) for m in mses), f"resumed losses {len(mses)}")
        check([(e["kind"], e["iteration"], e["first"], e["refiltered"]) for e in events]
              == [("mask", it, False, False) for it in later], f"resumed events {events}")
        check_stages_fall(mses, [stopped, *later, iters], start=stopped)
        psnr = resumed["test_psnrs"]
        check(len(psnr) == 1 and math.isfinite(psnr[0]), f"resumed test psnr {psnr}")
        if cuda:
            want = staged_launches(args, events, wh, start=stopped)
            check(launches == want, f"resumed launches {launches}, expected {want}")
        print(f"[lego] resumed at {stopped} to {iters}: {resume_s:.1f} s, events "
              f"{[(e['iteration'], e['sample_cap']) for e in events]}, test psnr {psnr[0]:.3f} dB, "
              f"launches {launches}")
        out["resumed"] = {"s": resume_s, "launches": launches, "events": events,
                          "test_psnr": psnr[0], "stages": resumed["stages"]}

        # 3. The same run uninterrupted.
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        straight = main_torch.main(argv("straight"))
        straight_s = time.perf_counter() - t0
        launches = _counts()
        mses, events = straight["train_mses"], straight["events"]
        check(len(mses) == iters and all(math.isfinite(m) for m in mses), "straight losses")
        check([(e["iteration"], e["first"]) for e in events]
              == [(it, i == 0) for i, it in enumerate(event_its)], f"straight events {events}")
        check_stages_fall(mses, [0, *event_its, iters])
        if cuda:
            want = staged_launches(args, events, wh)
            check(launches == want, f"straight launches {launches}, expected {want}")
        gap = abs(psnr[0] - straight["test_psnrs"][0])
        print(f"[lego] uninterrupted: {straight_s:.1f} s, test psnr {straight['test_psnrs'][0]:.3f}"
              f" dB; resumed {psnr[0]:.3f} dB, gap {gap:.3f} dB (limit {LEGO_PSNR_GAP_DB}); "
              f"launches {launches}")
        check(gap <= LEGO_PSNR_GAP_DB, f"resumed psnr {psnr[0]} vs uninterrupted "
                                       f"{straight['test_psnrs'][0]}")
        out.update(launches=launches, straight_s=straight_s,
                   test_psnr=straight["test_psnrs"][0], psnr_gap_db=gap,
                   events=events, stages=straight["stages"])

        # 4. Restoration bit for bit, and one more step's loss.
        train_ds = load_dataset("blender", scene, split="train", downsample=downsample,
                                is_stack=False)
        a = TriPlaneTrainer.from_checkpoint(os.path.join(tmp, "straight", "model.npz"), args,
                                            train_ds, device=device)
        a.train_step(*a.next_batch(), a.gen)
        saved = os.path.join(tmp, "saved.npz")
        a.save(saved)
        b = TriPlaneTrainer.from_checkpoint(saved, args, train_ds, device=device)
        out["restored_equal"] = _same_trainers(a, b)
        rays, rgbs = a.next_batch()
        b.next_batch()
        la = float(a.train_step(rays, rgbs, a.gen))
        lb = float(b.train_step(rays, rgbs, b.gen))
        check(math.isclose(la, lb, rel_tol=1e-5), f"one more step: loss {la} vs restored {lb}")
        print(f"[lego] restored trainer equal to the saving one at {a.iteration - 1} "
              f"({', '.join(out['restored_equal'])}); one more step's loss {la} vs {lb}")

        # 5. The full-width checkpoint's cost.
        def synced(fn):
            if cuda:
                torch.cuda.synchronize(device)
            t = time.perf_counter()
            r = fn()
            if cuda:
                torch.cuda.synchronize(device)
            return time.perf_counter() - t, r

        path = os.path.join(tmp, "timed.npz")
        cost = {"sync_blocked_s": [], "background_blocked_s": [], "background_write_s": [],
                "from_checkpoint_s": []}
        for _ in range(reps):
            cost["sync_blocked_s"].append(a.save(path))
            cost["background_blocked_s"].append(a.save(path, background=True))
            cost["background_write_s"].append(synced(a._ckpt_writer.wait)[0])
            cost["from_checkpoint_s"].append(synced(lambda: TriPlaneTrainer.from_checkpoint(
                path, args, train_ds, device=device))[0])
        cost["file_bytes"] = os.path.getsize(path)
        # The parameters and Adam's two moments.
        cost["state_bytes"] = 3 * sum(t.numel() * t.element_size()
                                      for _, t in named_leaves(a.params))
        print("[lego] checkpoint " + json.dumps(cost))
        check(not cuda or max(cost["background_blocked_s"]) < min(cost["sync_blocked_s"]),
              f"a background save blocks as long as a synchronous one: {cost}")
        out["checkpoint"] = cost
    return out


# ------------------------------------------------------------------- UV phase

# The UV path's shapes (`UV-Mapping/dtu_train.sh`, `tools/uv_cert.py`): 24 x 24
# balanced rays of 64 samples a step, 2500 template points, 24 synthetic
# views of 64 x 64, six held-out views.
UV_RAYS_SIDE, UV_SAMPLES, UV_POINTS, UV_VIEWS, UV_WH = 24, 64, 2500, 24, 64
UV_STEPS, UV_SIGTERM_AT, UV_SPHERE_STEPS, UV_BF16_STEPS = 3000, 1000, 500, 500
# K5's large row: enough rays that the bound is not a launch.
UV_LARGE_RAYS = 65536
# The JAX package's 12000-step certificates at this shape (results/uv_cert_*.json).
JAX_UV_CERT = {"square float32": (0.9862, 12.83), "square bfloat16": (0.9857, 14.19),
               "sphere bfloat16": (0.9791, 13.64)}
# A tiny UV phase for the CPU test (`tests/test_torch_uv_parity.py`).
UV_CPU_REHEARSAL = dict(views=4, wh=16, rays_side=4, samples=8, points=16, steps=6,
                        sigterm_at=2, sphere_steps=2, bf16_steps=2, texture_res=8,
                        large_rays=64, steps_per_call=2, print_freq=2, sampling_blocks=1)


def host_or_cuda_ms(fn, device: torch.device, reps: int) -> float:
    """``cuda_ms`` on the card; the host clock on the CPU (a rehearsal)."""
    if device.type == "cuda":
        return cuda_ms(fn, reps)
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def k5_bound_ms(n: int, s: int, backward: bool, colour: bool = True) -> tuple[float, str]:
    """Least time of one K5 launch: each input read once and each output
    written once over HBM, its arithmetic over the float32 rate. Forward
    reads density, dist (4 bytes), valid (1) and rgb (12) a sample, writes w
    (4) a sample and colour and T_total (16) a ray; ~30 operations a sample
    (exp ~10, the products, the scan). Backward reads the same inputs and
    the cotangents of w (4 a sample) and of colour and T (16 a ray), writes
    d density (4) and d rgb (12) a sample; ~45 operations a sample."""
    rgb = 12 if colour else 0
    if backward:
        nbytes = n * s * (4 + 4 + 1 + rgb + 4 + 4 + rgb) + n * 16
        ops = 45 * n * s
    else:
        nbytes = n * s * (4 + 4 + 1 + rgb + 4) + n * 16
        ops = 30 * n * s
    return bytes_bound_ms(nbytes, ops)


def k5_inputs(device: torch.device, n: int, s: int, rays_side: int, views: int, wh: int,
              seed: int = SEED):
    """K5's inputs at n rays of s samples as the UV path makes them: a
    synthetic DTU batch's rays (cycled up to n) through
    ``cube_ray_generation`` with jitter (valid and invalid samples, jittered
    segment lengths), softplus densities of a random field, radiance in
    [0, 1.5], a zero background per 576 rays as the trainer's."""
    from ngf_tpu_torch.data.dtu import SyntheticDtuDataset
    from ngf_tpu_torch.ops.rays import cube_ray_generation

    ds = SyntheticDtuDataset(n_views=views, wh=(wh, wh), random_sample="balanced",
                             random_sample_size=rays_side, seed=seed)
    dirs, cams = [], []
    while sum(d.shape[0] for d in dirs) < n:
        it = ds.sample()
        dirs.append(it["raydir"][0])
        cams.append(np.repeat(it["campos"], it["raydir"].shape[1], axis=0))
    raydir = torch.as_tensor(np.concatenate(dirs)[:n], device=device)
    campos = torch.as_tensor(np.concatenate(cams)[:n], device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand((n, 1, s), generator=g, device=device)
    _, dist, valid, _ = cube_ray_generation(campos, raydir[:, None], s, 1.0, 0.05, u)
    density = torch.nn.functional.softplus(
        4.0 * torch.randn((n, s), generator=g, device=device))
    rgb = 1.5 * torch.rand((n, s, 3), generator=g, device=device)
    per = rays_side ** 2
    bg = torch.zeros((n // per if n % per == 0 else 1, 3), device=device)
    return density, valid.reshape(n, s), dist.reshape(n, s), rgb, bg


def k5_rows(device: torch.device, rays_side: int, samples: int, views: int, wh: int,
            large_rays: int) -> list[dict]:
    """K5 forward (and backward) against its plain version at the UV path's
    shapes: a train step (rays_side^2 rays), a ``render_view`` chunk of as
    many rays (forward only) and ``large_rays`` rays; ms by CUDA events
    beside the bound and the plain version; no single PyTorch call computes
    the march, so ``library_ms`` is null."""
    from ngf_tpu_torch.ops import compositing, cuda_kernels

    cuda = device.type == "cuda"
    fwd = cuda_kernels.ray_march if cuda else compositing.ray_march_plain
    bwd = cuda_kernels.ray_march_backward if cuda else compositing.ray_march_backward_plain
    per = rays_side ** 2
    rows = []
    for case, n, with_bwd in (("train step", per, True), ("render chunk", per, False),
                              (f"{large_rays} rays", large_rays, True)):
        density, valid, dist, rgb, bg = k5_inputs(device, n, samples, rays_side, views, wh)
        if case == "render chunk":
            bg = None  # render_view's zero background, as the kernel sees it
        got = fwd(density, valid, dist, rgb, bg)
        want = compositing.ray_march_plain(density, valid, dist, rgb, bg)
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        scale = max(b.abs().max().item() for b in want)
        check(err <= F32_TOL * scale, f"K5 forward {case}: {err} against {scale}")
        reps = 50 if n <= 4096 else 20
        bound, by = k5_bound_ms(n, samples, backward=False)
        row = {"case": case, "N": n, "S": samples, "direction": "forward",
               "invalid_share": 1.0 - valid.float().mean().item(),
               "ms": host_or_cuda_ms(lambda: fwd(density, valid, dist, rgb, bg), device, reps),
               "graph_ms": graph_ms(lambda: fwd(density, valid, dist, rgb, bg)) if cuda else None,
               "plain_ms": host_or_cuda_ms(
                   lambda: compositing.ray_march_plain(density, valid, dist, rgb, bg), device, 5),
               "bound_ms": bound, "bound_by": by, "library_ms": None, "max_abs_err": err,
               "max_value": scale}
        rows.append(row)
        if with_bwd:
            g = torch.Generator(device=device).manual_seed(SEED + n)
            cots = (torch.randn((n, 3), generator=g, device=device),
                    torch.randn((n, samples), generator=g, device=device),
                    torch.randn((n,), generator=g, device=device))
            got = bwd(density, valid, dist, rgb, bg, *cots)
            want = compositing.ray_march_backward_plain(density, valid, dist, rgb, bg, *cots)
            errs = [(a - b).abs().max().item() for a, b in zip(got, want)]
            scales = [b.abs().max().item() for b in want]
            for e, sc, what in zip(errs, scales, ("d density", "d rgb")):
                check(e <= F32_TOL * sc, f"K5 backward {case} {what}: {e} against {sc}")
            bound, by = k5_bound_ms(n, samples, backward=True)
            rows.append({
                "case": case, "N": n, "S": samples, "direction": "backward",
                "ms": host_or_cuda_ms(lambda: bwd(density, valid, dist, rgb, bg, *cots), device, reps),
                "graph_ms": graph_ms(lambda: bwd(density, valid, dist, rgb, bg, *cots))
                if cuda else None,
                "plain_ms": host_or_cuda_ms(lambda: compositing.ray_march_backward_plain(
                    density, valid, dist, rgb, bg, *cots), device, 3),
                "bound_ms": bound, "bound_by": by, "library_ms": None,
                "max_abs_err": max(errs), "max_value": max(scales)})
    for r in rows:
        print(f"[uv] K5 {r['direction']} {r['case']} (N={r['N']} x {r['S']}, invalid share "
              f"{r.get('invalid_share', '-')}): "
              f"{r['ms']:.5f} ms, in a CUDA graph {r['graph_ms']}, bound {r['bound_ms']:.5f} "
              f"({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, max abs err {r['max_abs_err']:.3g} of {r['max_value']:.3g}")
    return rows


def novel_metrics(trainer, views: int, wh: int, seed: int = 0) -> dict:
    """Held-out silhouette IoU and colour PSNR as `tools/uv_cert.py:70-86`
    computes them: render each novel view (the ring offset half a step),
    PSNR of its colour, IoU of (1 - transmittance) > 0.5 with the mask."""
    from ngf_tpu_torch.data.dtu import SyntheticDtuDataset

    test = SyntheticDtuDataset(n_views=views, wh=(wh, wh), use_test_data=True, seed=seed)
    psnrs, ious = [], []
    chunk = trainer.dataset.random_sample_size ** 2
    for i in test.indexes:
        rgb, trans = trainer.render_view(test.campos[i], test.height, test.width, test.focal[i],
                                         test.extrinsics[i, :3, :3], test.princpt[i], chunk=chunk)
        mse = float(np.mean((rgb - test.gt_image[i]) ** 2))
        psnrs.append(-10.0 * np.log10(max(mse, 1e-12)))
        pred, gt = (1.0 - trans) > 0.5, test.gt_mask[i] > 0.5
        ious.append(float(np.logical_and(pred, gt).sum()) / max(float(np.logical_or(pred, gt).sum()), 1.0))
    return {"novel_psnr_db": float(np.mean(psnrs)), "novel_iou": float(np.mean(ious)),
            "per_view_psnr": psnrs, "views": len(test.indexes),
            "chunks_per_view": -(-test.height * test.width // chunk)}


def _counts() -> dict:
    from ngf_tpu_torch.ops import cuda_kernels

    return {k: fn.launches for k, fn in cuda_kernels.KERNELS.items()}


def _parsed_counts(text: str, tag: str) -> dict:
    from ngf_tpu_torch.ops import cuda_kernels

    line = next(ln for ln in text.splitlines() if ln.startswith(f"[{tag}] kernel launches "))
    got = json.loads(line.split("kernel launches ", 1)[1])
    return {k: int(got.get(k, 0)) for k in cuda_kernels.KERNELS}


def _mean_losses(save_dir: str) -> list[dict]:
    with open(os.path.join(save_dir, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def uv_step_row(trainer, device: torch.device, tag: str, reps: int = 20) -> dict:
    """One run's step on the card, on its trained weights, after the
    warm-up and the capture (`UVTrainer`'s steps are replays from there):
    ms a step by CUDA events over a block of ``reps`` steps (the block's
    host stacking and one read of its losses included), rays/s, peak
    memory, one step's profile (device time, idle share under the profiler,
    launches; the top device ops, the products' (``gemm``) and K5's
    shares), K5's kernels a step in that profile's device trace (the
    replays launch none from the host), and the block's idle share, 1 -
    that device time / its ms a step."""
    from ngf_tpu_torch.train.uv_loop import GRAPH_WARMUP

    items = [trainer.dataset.sample() for _ in range(reps)]
    rays = items[0]["raydir"].shape[1]
    trainer.train_block([trainer.dataset.sample() for _ in range(GRAPH_WARMUP + 2)])  # warm
    if device.type != "cuda":
        t0 = time.perf_counter()
        trainer.train_block(items)
        return {"ms": 1e3 * (time.perf_counter() - t0) / reps, "rays": rays}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    trainer.train_block(items)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    out = {"ms": ms, "rays": rays, "rays_per_s": 1e3 * rays / ms,
           "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30}
    from torch.autograd import DeviceType

    one = items[:1]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            trainer.train_block(one)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / 3
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation]
    total = sum(e.self_device_time_total for e in kern) / 1e3 / 3
    k5 = tuple(sum(e.count for e in kern if f"ray_march_neutex_{d}_kernel" in e.key) / 3
               for d in ("forward", "backward"))
    check(k5 == (1.0, 1.0), f"{tag}: K5 kernels a step in the device trace {k5}, want one "
          "forward and one backward")
    out["k5_kernels_per_step"] = k5
    if total > 0:
        by = sorted(kern, key=lambda e: -e.self_device_time_total)
        share = lambda pred: sum(e.self_device_time_total for e in kern if pred(e.key)) / 1e3 / 3 / total  # noqa: E731
        copies = sum(e.count for e in kern if e.key.startswith(("Memcpy", "Memset"))) / 3
        out["profile"] = {
            "host_ms": wall, "device_ms": total, "idle_share": max(0.0, 1.0 - total / wall),
            "launches": sum(e.count for e in kern) / 3 - copies, "copies_and_sets": copies,
            "gemm_share": share(lambda k: "gemm" in k.lower()),
            "k5_share": share(lambda k: "ray_march" in k),
            "top": [{"op": e.key[:90], "ms": e.self_device_time_total / 1e3 / 3,
                     "share": e.self_device_time_total / 1e3 / 3 / total} for e in by[:8]],
        }
        # the 20-step block's idle share: its kernels' time against its span
        out["block_idle_share"] = max(0.0, 1.0 - total / ms)
    else:
        out["profile"] = {"host_ms": wall, "device_ms": "not measured: the profiler saw no kernels"}
    print(f"[uv] {tag} step: {ms:.3f} ms by CUDA events ({out['rays_per_s']:.0f} rays/s), K5 "
          f"{k5} kernels a step, peak {out['peak_gib']:.2f} GiB, block idle share "
          f"{out.get('block_idle_share', 'not measured')}; profile " + json.dumps(out["profile"]))
    return out


def uv_sampling_rows(trainer, device: torch.device, tag: str, steps_per_call: int,
                     blocks: int) -> dict:
    """Where the CLI's batches come from, on a run's trained weights: ms a
    step over ``blocks`` blocks of ``steps_per_call`` steps (each block
    ending in its loss read, as the CLI's), with the batches sampled inline
    before each block, as `uv_train_torch.py` does, and, for comparison,
    by a host thread that samples the next block while the card runs this
    one (the JAX CLI's `BlockPrefetcher`). Four segments, inline, thread,
    thread, inline; each way's ms is the mean of its two."""
    from concurrent.futures import ThreadPoolExecutor

    ds = trainer.dataset
    sample = lambda: [ds.sample() for _ in range(steps_per_call)]  # noqa: E731
    trainer.train_block(sample())  # warm

    def segment(mode):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "inline":
            for _ in range(blocks):
                trainer.train_block(sample())
        else:
            with ThreadPoolExecutor(1) as pool:
                ahead = pool.submit(sample)
                for b in range(blocks):
                    items = ahead.result()
                    if b + 1 < blocks:
                        ahead = pool.submit(sample)
                    trainer.train_block(items)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / (blocks * steps_per_call)

    got = {"inline": [], "thread": []}
    for mode in ("inline", "thread", "thread", "inline"):
        got[mode].append(segment(mode))
    out = {k: float(np.mean(v)) for k, v in got.items()}
    out["segments"] = got
    out["thread_gain"] = 1.0 - out["thread"] / out["inline"]
    print(f"[uv] {tag} batches: inline {out['inline']:.4f} ms a step, a block ahead on a host "
          f"thread {out['thread']:.4f} ({100 * out['thread_gain']:.2f}% faster; segments "
          f"{json.dumps(got)}; {blocks} blocks of {steps_per_call})")
    return out


def uv_phase(device: torch.device, views: int = UV_VIEWS, wh: int = UV_WH,
             rays_side: int = UV_RAYS_SIDE, samples: int = UV_SAMPLES, points: int = UV_POINTS,
             steps: int = UV_STEPS, sigterm_at: int = UV_SIGTERM_AT,
             sphere_steps: int = UV_SPHERE_STEPS, bf16_steps: int = UV_BF16_STEPS,
             sphere_dtype: str = "float32", texture_res: int = 512, large_rays: int = UV_LARGE_RAYS, steps_per_call: int = 20,
             print_freq: int = 100, sampling_blocks: int = 8) -> dict:
    """The UV-Mapping path: K5 against its plain version; the square recipe
    in float32 through ``uv_train_torch.py`` in a subprocess, SIGTERMed once
    it logs step ``sigterm_at``, resumed in this process to ``steps``, then
    ``uv_test_torch.py`` (the texture, the held-out views, an edited render
    with a checkerboard ``--target_texture``); the sphere primitive (cube
    and equirect exports, an edited cube render) and the square recipe in
    bfloat16. Each run's K5 launches, losses, novel IoU and PSNR and its
    step on the card; for the square runs, inline batches against a host
    thread (`uv_sampling_rows`)."""
    import uv_test_torch
    import uv_train_torch
    from ngf_tpu_torch.fields.neutex import export_sphere_equirect, export_texture
    from ngf_tpu_torch.ops import cuda_kernels
    from ngf_tpu_torch.train.uv_loop import GRAPH_WARMUP, UVTrainer
    from ngf_tpu_torch.utils.cubemap import merge_cube_to_single_texture
    from ngf_tpu_torch.utils.image import write_png

    cuda = device.type == "cuda"

    def expect_k5(counts: dict, fwd: int, bwd: int, what: str) -> None:
        """On the card: the host's K5 launches over a run are exactly
        ``fwd`` forward and ``bwd`` backward (one each an eager step and at
        the capture, none a replayed step, one forward a render chunk);
        `uv_step_row` counts a replayed step's K5 kernels in the device
        trace."""
        if cuda:
            check((counts["ray_march"], counts["ray_march_backward"]) == (fwd, bwd),
                  f"{what}: K5 launched {counts['ray_march']} forward and "
                  f"{counts['ray_march_backward']} backward, want {fwd} and {bwd}")

    out = {"k5": k5_rows(device, rays_side, samples, views, wh, large_rays), "runs": {},
           "launches": {}}
    here = os.path.dirname(os.path.abspath(__file__))
    per_view = -(-wh * wh // rays_side ** 2)
    test_freq = uv_train_torch.parse_args(["--sample_num", "1", "--primitive_type", "square",
                                           "--points_per_primitive", "1"]).test_freq

    def launched(start: int, end: int) -> int:
        """The host's K5 launches of one direction in a trainer's steps from
        ``start`` to ``end``: on the card the eager warm-up's and the
        capture's (the replays launch none), on the CPU one a step."""
        n = end - start
        return min(n, GRAPH_WARMUP) + (n > GRAPH_WARMUP) if cuda else n

    def steps_and_renders(start: int, end: int) -> int:
        """K5 forward launches of training from ``start`` to ``end``: the
        steps' (``launched``), and one a chunk of the test view the CLI
        renders at every multiple of its ``test_freq`` (one view by
        default)."""
        return launched(start, end) + per_view * (end // test_freq - start // test_freq)
    with tempfile.TemporaryDirectory() as tmp:
        x = np.indices((256, 256)).sum(0) // 32 % 2
        checker = os.path.join(tmp, "checker.png")
        write_png(checker, (np.stack([x, 1 - x, 0.5 + 0 * x], -1) * 255).astype(np.uint8))

        def argv(name, primitive, n, dtype="float32"):
            return ["--dataset_name", "synthetic_dtu", "--random_sample", "balanced",
                    "--random_sample_size", str(rays_side), "--sample_num", str(samples),
                    "--primitive_type", primitive, "--points_per_primitive", str(points),
                    "--lr", "1e-4", "--synthetic_views", str(views), "--synthetic_wh", str(wh),
                    "--niter", str(n), "--compute_dtype", dtype, "--checkpoints_dir", tmp,
                    "--name", name, "--steps_per_call", str(steps_per_call),
                    "--print_freq", str(print_freq), "--save_iter_freq", "0",
                    "--device", device.type]

        def finish(tag, name, primitive, dtype, n):
            cfg = uv_train_torch.make_config(uv_train_torch.parse_args(argv(name, primitive, n, dtype)))
            ds = uv_train_torch.make_dataset(uv_train_torch.parse_args(argv(name, primitive, n, dtype)))
            trainer = UVTrainer(cfg, ds, device=device, save_dir=os.path.join(tmp, name))
            meta = trainer.load_networks("latest")
            check(meta["total_steps"] == n, f"{tag}: checkpoint at {meta['total_steps']}, want {n}")
            cuda_kernels.reset_launch_counts()
            run = novel_metrics(trainer, views, wh)
            expect_k5(_counts(), run["views"] * per_view, 0, f"{tag}: novel renders")
            losses = _mean_losses(os.path.join(tmp, name))
            run["loss_first"], run["loss_last"] = losses[0]["loss/total"], losses[-1]["loss/total"]
            check(all(np.isfinite(r["loss/total"]) for r in losses), f"{tag}: losses {losses}")
            if len(losses) >= 3:  # print_freq's rows; a rehearsal may log fewer
                check(run["loss_last"] < run["loss_first"],
                      f"{tag}: loss {run['loss_first']} -> {run['loss_last']}")
            run["step"] = uv_step_row(trainer, device, tag)
            print(f"[uv] {tag}: {n} steps, loss {run['loss_first']:.5f} -> {run['loss_last']:.5f}, "
                  f"novel IoU {run['novel_iou']:.4f}, PSNR {run['novel_psnr_db']:.3f} dB"
                  + (f" (JAX package, 12000 steps: IoU {JAX_UV_CERT[tag][0]}, "
                     f"{JAX_UV_CERT[tag][1]} dB)" if tag in JAX_UV_CERT else ""))
            return trainer, run

        # 1. square float32: SIGTERM, resume, test CLI
        name, sq = "uv_square", argv("uv_square", "square", steps)
        env = {**os.environ, "PYTHONUNBUFFERED": "1"}
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, os.path.join(here, "uv_train_torch.py"), *sq],
                                cwd=here, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        text, sent = [], False
        try:
            for line in proc.stdout:
                text.append(line)
                if not sent and line.startswith("End of iteration ") and int(line.split()[3]) >= sigterm_at:
                    proc.send_signal(signal.SIGTERM)
                    sent = True
            proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        text = "".join(text)
        check(proc.returncode == 0 and "preempted at step" in text,
              f"uv_train_torch under SIGTERM: rc {proc.returncode}\n{text[-3000:]}")
        save_dir = os.path.join(tmp, name)
        with np.load(os.path.join(save_dir, "latest_net_NeuTex.npz")) as z:
            stopped = json.loads(bytes(z["meta"]).decode())["total_steps"]
        check(sigterm_at <= stopped < steps, f"SIGTERM saved step {stopped}")
        launches = {"uv square to SIGTERM": _parsed_counts(text, "uv_train_torch")}
        sub_s = time.perf_counter() - t0
        expect_k5(launches["uv square to SIGTERM"], steps_and_renders(0, stopped),
                  launched(0, stopped),
                  "square float32 to the SIGTERM")
        print(f"[uv] square float32: SIGTERM after step {sigterm_at} was logged, 'latest' at "
              f"{stopped}, {sub_s:.1f} s in the subprocess")
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        uv_train_torch.main(sq + ["--resume_dir", save_dir])
        resume_s = time.perf_counter() - t0
        launches["uv square resumed"] = _counts()
        expect_k5(launches["uv square resumed"], steps_and_renders(stopped, steps),
                  launched(stopped, steps), "square float32 resumed")
        cuda_kernels.reset_launch_counts()
        uv_test_torch.main(sq + ["--target_texture", checker])
        launches["uv test CLI"] = _counts()
        n_test = len(uv_train_torch.make_dataset(uv_train_torch.parse_args(sq), True).indexes)
        expect_k5(launches["uv test CLI"], n_test * per_view, 0, "uv_test_torch")
        outs = sorted(os.listdir(os.path.join(save_dir, "test_output")))
        check(outs == sorted(["texture.png"] + [f"{k}-{i:03d}.png" for i in range(n_test)
                                               for k in ("render", "transmittance")]),
              f"uv_test_torch outputs {outs}")
        trainer, run = finish("square float32", name, "square", "float32", steps)
        run.update(resumed_from=stopped, subprocess_s=sub_s, resume_s=resume_s,
                   sampling=uv_sampling_rows(trainer, device, "square float32", steps_per_call,
                                             sampling_blocks))
        out["runs"]["square float32"] = run

        # 2. the sphere (float32 unless asked), its exports and an edited cube render
        sphere = f"sphere {sphere_dtype}"
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        uv_train_torch.main(argv("uv_sphere", "sphere", sphere_steps, sphere_dtype))
        train_s = time.perf_counter() - t0
        launches["uv sphere"] = _counts()
        expect_k5(launches["uv sphere"], steps_and_renders(0, sphere_steps),
                  launched(0, sphere_steps), sphere)
        trainer, run = finish(sphere, "uv_sphere", "sphere", sphere_dtype, sphere_steps)
        faces = export_texture(trainer.params, trainer.cfg, texture_res).cpu().numpy()
        eq = export_sphere_equirect(trainer.params, trainer.cfg, texture_res).cpu().numpy()
        check(faces.shape == (6, texture_res, texture_res, 3) and np.isfinite(faces).all()
              and eq.shape == (texture_res, 2 * texture_res, 3) and np.isfinite(eq).all(),
              f"sphere exports {faces.shape} {eq.shape}")
        cross = merge_cube_to_single_texture(faces)
        write_png(os.path.join(tmp, "uv_sphere", "texture_cube.png"),
                  uv_train_torch.to_png(cross))
        cube = np.stack([np.stack([x, 1 - x, 0.5 + 0 * x], -1)] * 6).astype(np.float32)
        test = uv_train_torch.make_dataset(uv_train_torch.parse_args(
            argv("uv_sphere", "sphere", sphere_steps, sphere_dtype)), True)
        i = test.indexes[0]
        rgb, _ = trainer.render_view(test.campos[i], test.height, test.width, test.focal[i],
                                     test.extrinsics[i, :3, :3], test.princpt[i],
                                     chunk=rays_side ** 2, edit_texture=cube)
        check(rgb.shape == (wh, wh, 3) and np.isfinite(rgb).all(), "edited sphere render")
        run.update(train_s=train_s, cross_shape=list(cross.shape))
        if sphere in JAX_UV_CERT:
            # A novel IoU more than 0.02 below the JAX package's
            # certificate (12000 steps) is a fault to record.
            run["iou_gap_to_jax"] = JAX_UV_CERT[sphere][0] - run["novel_iou"]
            print(f"[uv] {sphere}: {sphere_steps} steps, novel IoU {run['novel_iou']:.4f} "
                  f"against the JAX package's {JAX_UV_CERT[sphere][0]} (gap "
                  f"{run['iou_gap_to_jax']:.4f}; more than 0.02 is a fault), PSNR "
                  f"{run['novel_psnr_db']:.3f} dB against {JAX_UV_CERT[sphere][1]}")
        out["runs"][sphere] = run

        # 3. square bfloat16
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        uv_train_torch.main(argv("uv_bf16", "square", bf16_steps, "bfloat16"))
        train_s = time.perf_counter() - t0
        launches["uv bf16"] = _counts()
        expect_k5(launches["uv bf16"], steps_and_renders(0, bf16_steps), launched(0, bf16_steps),
                  "square bfloat16")
        trainer, run = finish("square bfloat16", "uv_bf16", "square", "bfloat16", bf16_steps)
        run.update(train_s=train_s,
                   sampling=uv_sampling_rows(trainer, device, "square bfloat16", steps_per_call,
                                             sampling_blocks))
        out["runs"]["square bfloat16"] = run
    out["launches"] = launches
    return out


# The parallel phase: two ranks share the one card over gloo.
# The I/O tail.
# The mesh export of `TriPlaneTrainer.export_mesh` (`ngf_tpu/train/loop.py:1647-1675`):
# a 256^3 lattice in chunks of 256 * 256 * 8 points, one K1 launch each.
EXPORT_GRID, EXPORT_CHUNK = 256, 256 * 256 * 8
EXPORT_LAUNCHES = -(-EXPORT_GRID ** 3 // EXPORT_CHUNK)
# LPIPS timed on an 800 x 800 view, held against its CPU forward on a crop.
LPIPS_WH, LPIPS_CROP, LPIPS_RTOL = 800, 256, 1e-4
# Run (c) of the parallel phase: the UV trainer on a data mesh of two ranks
# at the `dtu_train.sh` shape (the uv phase's), against one rank.
UV_MESH_STEPS, UV_MESH_BLOCK = 200, 20
UV_MESH_SIZES = dict(views=24, wh=64, rays_side=24, samples=64, points=2500)
# The first step of two ranks against one rank: every loss term, and each
# gradient leaf after the all-reduce to this share of the leaf's largest
# entry. Only the order of float32 sums differs there (each rank's half of
# the rays, the gloo sum). Later steps drift apart further: Adam scales
# each update by its gradient's own size, so a gradient entry that is
# rounding noise moves its weight as far as a real one.
UV_MESH_FIRST_RTOL = 1e-4
UV_RAY_TOL = 1e-6

PARALLEL_ITERS = 700  # run (a): across the recipe's mask event at 600
# Run (b): a third of the train phase's run, so that the whole script keeps
# to its time limit with the topk, llff and tail phases; held to a one-rank
# run of the same length.
PARALLEL_SP_ITERS = TRAIN_ITERS // 3
PARALLEL_PSNR_GAP_DB = 0.3
# Run (a) against the one-rank run: two runs on the card never train the
# same weights (K2's float atomics add in another order each run, so
# same-seed reruns differ 0.02-0.07 dB), and the mask event thresholds
# them: the masks may differ in voxels at the threshold. They must agree on
# all but 0.1 % of the one-rank mask's occupied voxels, and the kept rays
# within 0.1 %; the measured capacity (a multiple of 32) exactly. The ranks
# of one run hold the same weights: equal bit for bit.
PARALLEL_MASK_REL = 1e-3
# Run (b) against a one-rank dense run of the same function (all 884
# samples, ``--sample_cap 0``): the mean loss of the last 50 steps within
# 5 % (the PSNR limit allows 7 %). Against the train phase's dense run,
# which compacts each ray to its first 512 valid samples (open_sample_cap)
# and so is another function, within 10 %; that run's PSNR is reported, not
# held to the limit (0.196 dB below (b)'s on an H100 at 700 W).
PARALLEL_SP_LOSS_RTOL = 0.05
PARALLEL_SP_TRAIN_LOSS_RTOL = 0.1
# Two chained shard launches against one whole-ray launch: the same float32
# scan with its products associated at the split.
SPLIT_TOL = 1e-6
PARALLEL_TIMEOUT_S = 420


def shard_inputs(device: torch.device, n: int, s: int, seed: int, t0_kind: str):
    """A shard of the sample-parallel path at its shapes: sigma over five
    decades with runs of sigma dist = 20 on every other ray, the path's one
    length (step 0.01 x 25), rgb, z, and t0 random in (0, 1] or, for
    ``zero``, 0 (behind an opaque shard) on a quarter of the rays."""
    g = torch.Generator(device=device).manual_seed(seed)
    dist = float(np.float32(0.01 * 25.0))
    sigma = 24.0 * torch.rand((n, s), generator=g, device=device) * (
        torch.rand((n, s), generator=g, device=device) < 0.6)
    sigma = sigma * torch.logspace(-5, 0, n, device=device)[:, None]
    sigma[::2, 3:3 + 48] = 20.0 / dist
    rgb = torch.rand((n, s, 3), generator=g, device=device)
    z = torch.sort(2.0 + 4.0 * torch.rand((n, s), generator=g, device=device), dim=-1).values
    t0 = 1.0 - torch.rand((n,), generator=g, device=device)
    if t0_kind == "zero":
        t0[: n // 4] = 0.0
    return sigma, dist, rgb, z, t0


def k5_shard_bound_ms(n: int, s: int, which: str) -> tuple[float, str]:
    """Least time of one K5 shard-mode launch: each input read once and each
    output written once over HBM, its arithmetic over the float32 rate.
    Totals: sigma (4) read a sample, t_end (4) written a ray, ~15 operations
    a sample (exp, the scan). Forward: sigma, z (4 each) and rgb (12) read a
    sample; t0 (4) read and y (12), acc, depth (4 each) and the local sums
    (16) written a ray; ~35 operations a sample. Backward: sigma (4) and rgb
    (12) read, d sigma (4) and d rgb (12) written a sample; t0, the
    cotangents of y (12), acc and t_end read and d t0 written a ray (4
    each but y's); ~50 operations a sample. The constant length is no
    input."""
    per_sample, per_ray, ops = {"totals": (4, 4, 15), "forward": (20, 40, 35),
                                "backward": (32, 28, 50)}[which]
    return bytes_bound_ms(n * s * per_sample + n * per_ray, ops * n * s)


def k5_shard_rows(device: torch.device) -> dict:
    """K5's shard mode against its plain versions at the sample-parallel
    path's shapes (4096 rays, 884 samples over 2 shards of 442 and 4 of
    221), t0 random in (0, 1] and t0 = 0 behind opaque runs, both
    directions (every output and gradient to F32_TOL of its scale, y
    against the plain sums under the kernel's mask, the rays whose mask
    flips near the threshold left out of the gradients), no NaN; timed by
    CUDA events and in a CUDA graph beside the bound and the plain
    versions (no single PyTorch call computes it: ``library_ms`` null).
    Then the split identity: the shards chained from t0 = 1, each from the
    last one's t_end, against one whole-ray tri-plane launch of 884
    samples: w, acc, depth and rgb_map within SPLIT_TOL of their scale, the
    shading mask equal."""
    from ngf_tpu_torch.ops import compositing, cuda_kernels

    thres = 1e-4
    rows, errs = [], []
    for n, s, shards in ((RAYS_PER_CHUNK, 442, 2), (RAYS_PER_CHUNK, 221, 4)):
        for t0_kind in ("random", "zero"):
            sigma, dist, rgb, z, t0 = shard_inputs(device, n, s, 11, t0_kind)
            g = torch.Generator(device=device).manual_seed(12)
            g_y, g_acc, g_tend = (torch.randn(sh, generator=g, device=device)
                                  for sh in ((n, 3), (n,), (n,)))
            t_end = cuda_kernels.ray_march_triplane_totals(sigma, dist)
            y, acc, depth, local, w = cuda_kernels.ray_march_triplane_shard(
                sigma, dist, rgb, z, t0, thres, True)
            got_b = cuda_kernels.ray_march_triplane_shard_backward(sigma, dist, rgb, t0, thres,
                                                                   g_y, g_acc, g_tend)
            p_y, p_acc, p_depth, p_local, p_w = compositing.composite_shard_plain(
                sigma, dist, rgb, z, t0, thres)
            flips = (w > thres) != (p_w > thres)
            check(bool(((p_w[flips] - thres).abs() <= 1e-5 * thres).all()),
                  f"K5 shard {n}x{s} {t0_kind}: a mask bit flipped far from the threshold")
            mine = (w > thres).to(w.dtype)
            err = {}
            for what, a, b in (
                    ("t_end", t_end, compositing.composite_shard_totals_plain(sigma, dist)),
                    ("y", y, ((p_w * mine)[..., None] * rgb).sum(-2)), ("acc", acc, p_acc),
                    ("depth", depth, p_depth), ("w", w, p_w), ("acc_loc", local[:, 3], p_local[:, 3])):
                err[what] = (a - b).abs().max().item()
                check(err[what] <= F32_TOL * max(b.abs().max().item(), 1e-30)
                      and bool(torch.isfinite(a).all()),
                      f"K5 shard forward {n}x{s} {t0_kind} {what}: {err[what]}")
            want_b = compositing.composite_shard_backward_plain(sigma, dist, rgb, t0, thres, g_y,
                                                                g_acc, g_tend)
            ok = ~flips.any(-1)
            for what, a, b in zip(("d sigma", "d rgb", "d t0"), got_b, want_b):
                err[what] = (a[ok] - b[ok]).abs().max().item()
                check(err[what] <= F32_TOL * max(b[ok].abs().max().item(), 1e-30)
                      and bool(torch.isfinite(a).all()),
                      f"K5 shard backward {n}x{s} {t0_kind} {what}: {err[what]}")
            errs.append(max(err.values()))
            if t0_kind != "random":
                continue
            calls = {
                "totals": (lambda: cuda_kernels.ray_march_triplane_totals(sigma, dist),
                           lambda: compositing.composite_shard_totals_plain(sigma, dist)),
                "forward": (lambda: cuda_kernels.ray_march_triplane_shard(
                    sigma, dist, rgb, z, t0, thres),
                    lambda: compositing.composite_shard_plain(sigma, dist, rgb, z, t0, thres)),
                "backward": (lambda: cuda_kernels.ray_march_triplane_shard_backward(
                    sigma, dist, rgb, t0, thres, g_y, g_acc, g_tend),
                    lambda: compositing.composite_shard_backward_plain(
                        sigma, dist, rgb, t0, thres, g_y, g_acc, g_tend)),
            }
            for which, (kernel, plain) in calls.items():
                bound, by = k5_shard_bound_ms(n, s, which)
                row = {"case": f"{shards} shards", "N": n, "S": s, "direction": which,
                       "ms": cuda_ms(kernel, 20), "graph_ms": graph_ms(kernel),
                       "bound_ms": bound, "bound_by": by,
                       "plain_ms": cuda_ms(plain, 3 if which == "backward" else 5),
                       "library_ms": None, "max_abs_err": max(err.values()),
                       "mask_flips": int(flips.sum().item())}
                rows.append(row)
                print(f"[parallel] K5 shard {which} {n} x {s} ({shards} shards): {row['ms']:.5f} "
                      f"ms, in a CUDA graph {row['graph_ms']:.5f}, bound {bound:.5f} ({by}, "
                      f"{bound / row['graph_ms']:.1%} of the graph's), plain "
                      f"{row['plain_ms']:.4f} ms, max abs err {row['max_abs_err']:.3g}, mask "
                      f"flips {row['mask_flips']}")
    # The split identity.
    sigma, dist, rgb, z, _ = shard_inputs(device, RAYS_PER_CHUNK, 884, 13, "random")
    last = torch.zeros((RAYS_PER_CHUNK,), device=device)
    rgb_map, _, acc, depth, w = cuda_kernels.ray_march_triplane(sigma, dist, rgb, z, last, 1.0,
                                                                thres, True)
    split = {}
    for shards in (2, 4):
        k = 884 // shards
        t0 = torch.ones((RAYS_PER_CHUNK,), device=device)
        parts = []
        for j in range(shards):
            cols = slice(j * k, (j + 1) * k)
            t_end = cuda_kernels.ray_march_triplane_totals(sigma[:, cols], dist)
            parts.append(cuda_kernels.ray_march_triplane_shard(sigma[:, cols], dist, rgb[:, cols],
                                                               z[:, cols], t0, thres, True))
            t0 = t0 * t_end
        acc2 = sum(p[1] for p in parts)
        w2 = torch.cat([p[4] for p in parts], 1)
        map2 = (sum(p[0] for p in parts) + (1.0 - acc2[:, None])).clamp(0.0, 1.0)
        e = {what: (a - b).abs().max().item() / max(b.abs().max().item(), 1.0)
             for what, a, b in (("w", w2, w), ("acc", acc2, acc),
                                ("depth", sum(p[2] for p in parts), depth),
                                ("rgb_map", map2, rgb_map))}
        mask_equal = torch.equal(w2 > thres, w > thres)
        split[f"{shards} shards"] = {"rel_err": e, "mask_equal": mask_equal}
        print(f"[parallel] K5 split identity, {shards} chained shards of {k} against one launch "
              f"of 884: relative errors {json.dumps(e)}, mask equal {mask_equal}")
        check(max(e.values()) <= SPLIT_TOL and mask_equal,
              f"K5 split identity over {shards} shards: {e}, mask equal {mask_equal}")
    return {"rows": rows, "max_abs_err": max(errs), "split": split}


def nccl_check(device: torch.device, numel: int) -> dict:
    """One world-1 NCCL group, initialised and torn down in this process,
    reduces a gradient-sized buffer once: the backend loads on the card."""
    import torch.distributed as dist

    port = _free_port()
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        buf = torch.arange(numel, device=device, dtype=torch.float32)
        want = buf.clone()
        dist.all_reduce(buf)
        torch.cuda.synchronize(device)
        check(torch.equal(buf, want), "NCCL world-1 all-reduce changed the buffer")
    finally:
        dist.destroy_process_group()
    out = {"numel": numel, "s": time.perf_counter() - t0, "backend": "nccl"}
    print(f"[parallel] NCCL: a world-1 group reduced a {numel}-float buffer "
          f"({out['s']:.3f} s with the group's set-up)")
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def host_ms_per_step(stages: list[dict]) -> float:
    """Milliseconds a step on the host clock over a run's stages (its
    evaluations and events left out)."""
    return 1e3 * sum(st["s"] for st in stages) / sum(st["to"] - st["from"] for st in stages)


def parallel_rank(spec_path: str) -> int:
    """One rank of the parallel phase, started by :func:`run_ranks`:
    ``main_torch.main`` on the spec's argv with every launch count from 0,
    then the rank's launches, statistics, the all-reduce of its gradient
    buffer timed (host clock between two synchronisations, each step) and a
    digest of its final parameters, written to ``<spec>.rank<i>.json``."""
    import hashlib

    import main_torch
    import torch.distributed as dist
    from ngf_tpu_torch.convert import sorted_named_leaves
    from ngf_tpu_torch.ops import cuda_kernels
    from ngf_tpu_torch.train import loop

    with open(spec_path) as f:
        spec = json.load(f)
    if "uv" in spec:
        return uv_rank(spec, spec_path)
    held = {}
    run = loop.TriPlaneTrainer.run

    def keep(self, *a, **kw):
        held["trainer"] = self
        return run(self, *a, **kw)

    loop.TriPlaneTrainer.run = keep
    reduce_ms = time_all_reduces()
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    stats = main_torch.main(spec["argv"])
    main_s = time.perf_counter() - t0
    trainer = held["trainer"]
    digest = hashlib.sha1()
    for _, leaf in sorted_named_leaves(trainer.params):
        digest.update(leaf.detach().cpu().numpy().tobytes())
    rank = dist.get_rank()
    out = {"rank": rank, "main_s": main_s, "mses": stats["train_mses"],
           "events": stats["events"], "test_psnrs": stats["test_psnrs"],
           "loop_s": stats["wall_time_s"], "iterations": stats["iterations"],
           "stages": stats["stages"],
           "launches": {k: fn.launches for k, fn in cuda_kernels.KERNELS.items()},
           "params_sha1": digest.hexdigest(), "reduce_ms": reduce_ms,
           "reduce_numel": int(sum(p.numel() for _, p in sorted_named_leaves(trainer.params))),
           "ray_ids_sha1": hashlib.sha1(trainer._ray_ids.tobytes()).hexdigest(),
           "occ_sha1": None if trainer.alpha is None else hashlib.sha1(
               trainer.alpha.occ.cpu().numpy().tobytes()).hexdigest(),
           "auto_cap": trainer._auto_cap, "rgb_stat": int(trainer.rgb_stat.item())}
    with open(f"{spec_path}.rank{rank}.json", "w") as f:
        json.dump(out, f)
    return 0


def time_all_reduces(min_numel: int = 1 << 20) -> list[float]:
    """Wrap ``torch.distributed.all_reduce`` so that each call on a buffer of
    ``min_numel`` values or more (the gradients') is timed on the host clock
    between two synchronisations; returns the list the milliseconds go
    into."""
    import torch.distributed as dist

    reduce_ms: list[float] = []
    all_reduce = dist.all_reduce
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)

    def timed(tensor, *a, **kw):
        if tensor.numel() < min_numel:
            return all_reduce(tensor, *a, **kw)
        sync()
        t0 = time.perf_counter()
        out = all_reduce(tensor, *a, **kw)
        sync()
        reduce_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    dist.all_reduce = timed
    return reduce_ms


def uv_rank(spec: dict, spec_path: str) -> int:
    """One rank of the parallel phase's run (c): :func:`uv_mesh_run` on a
    data mesh of every rank, its record and the all-reduce's milliseconds
    written to ``<spec>.rank<i>.json``, its first step's gradients to
    ``<spec>.rank<i>.grads.npz``."""
    import torch.distributed as dist
    from ngf_tpu_torch.parallel import make_mesh, maybe_initialize_distributed

    device = torch.device(spec["device"])
    maybe_initialize_distributed(device_type=device.type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    reduce_ms = time_all_reduces(0)  # the trainer's one all-reduce a step
    out = uv_mesh_run(device, spec["uv"]["steps"], spec["uv"]["sizes"], make_mesh())
    out["reduce_ms"] = reduce_ms
    np.savez(f"{spec_path}.rank{dist.get_rank()}.grads.npz", *out.pop("first_grads"))
    with open(f"{spec_path}.rank{dist.get_rank()}.json", "w") as f:
        json.dump(out, f)
    return 0


def run_ranks(tmp: str, tag: str, argv: list[str], device: str, n: int = 2,
              uv: dict | None = None) -> list[dict]:
    """``n`` ranks of ``main_torch.main(argv)`` (or, with ``uv``, of
    :func:`uv_mesh_run` at ``uv["steps"]`` and ``uv["sizes"]``) as processes
    sharing one device over gloo (``--device cuda:0``, or ``cpu`` in a
    rehearsal; NGF_DIST_BACKEND=gloo), each through :func:`parallel_rank`.
    A rank that fails, or a run that outlasts PARALLEL_TIMEOUT_S, fails the
    phase; every rank is stopped."""
    spec = os.path.join(tmp, f"{tag}.json")
    with open(spec, "w") as f:
        json.dump({"uv": uv, "device": device} if uv else {"argv": argv + ["--device", device]},
                  f)
    port = _free_port()
    procs = []
    logs = []
    try:
        for rank in range(n):
            env = dict(os.environ, NGF_COORDINATOR=f"localhost:{port}",
                       NGF_NUM_PROCESSES=str(n), NGF_PROCESS_ID=str(rank),
                       NGF_DIST_BACKEND="gloo")
            env.pop("NGF_DISTRIBUTED", None)
            log = open(os.path.join(tmp, f"{tag}.rank{rank}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--parallel_rank", spec],
                env=env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.time() + PARALLEL_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    results = []
    for rank, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(tmp, f"{tag}.rank{rank}.log")) as f:
                tail = f.read()[-6000:]
            raise RuntimeError(f"chip_smoke check failed: {tag} rank {rank} exited "
                               f"{p.returncode}:\n{tail}")
        with open(f"{spec}.rank{rank}.json") as f:
            results.append(json.load(f))
    return results


def parallel_phase(device: torch.device, views: int = TRAIN_VIEWS, wh: int = TRAIN_WH,
                   train: dict | None = None, iters: int = PARALLEL_ITERS,
                   sp_iters: int = PARALLEL_SP_ITERS, extra: tuple[str, ...] = (),
                   uv_steps: int = UV_MESH_STEPS, uv_sizes: dict = UV_MESH_SIZES) -> dict:
    """The parallel modes on the card: K5's shard mode (:func:`k5_shard_rows`),
    the NCCL check, then two ranks sharing the card over gloo at full width
    (planes 256^2 x 96, 4096-ray global batches), on a Blender-format scene
    written from the synthetic views (each rank loads it in seconds):

    (a) ``--mesh_shape 2x1`` on ``configs/synthetic_infoinv_tpu.txt
        --n_iters 700`` (the grouped path, K1 to K5, across the mask event
        at 600) against a one-rank run of the same in this process: the
        mask, kept rays and measured capacity equal, the test PSNR within
        PARALLEL_PSNR_GAP_DB, the two ranks' parameter digests equal, each
        rank's launches exact (the final evaluation's on rank 0 only);
    (b) ``--mesh_shape 1x2 --group_size 0`` for ``sp_iters`` steps against
        a one-rank run of the same dense function (``--sample_cap 0``) in
        this process: the last 50 steps' mean loss within
        PARALLEL_SP_LOSS_RTOL, the PSNR within PARALLEL_PSNR_GAP_DB; against
        the train phase's dense run (``train``, when it ran and is as long)
        the loss within PARALLEL_SP_TRAIN_LOSS_RTOL and the PSNR reported;
        K5's shard
        launches exact (a totals, a composite and a backward launch a step
        on each rank) and the two ranks' digests equal;
    (c) ``UVTrainer(mesh=make_mesh())`` (:func:`uv_mesh_run`), ``uv_steps``
        steps at the `dtu_train.sh` shape (``uv_sizes``), each rank half of
        every step's rays, against one rank in this process: the two ranks'
        digests equal, the first step's loss terms and gradients within
        UV_MESH_FIRST_RTOL, the last 50 steps' mean colour loss within
        PARALLEL_SP_LOSS_RTOL, K5's NeuTex launches exact (one forward and
        one backward a step on each rank).

    Prints each run's ms a step on the host clock and the gradient
    all-reduce's ms a step: two ranks on one card over gloo, no multi-GPU
    figure. ``extra`` argv shrink the runs for a CPU rehearsal (then the
    ranks run ``--device cpu``)."""
    import main_torch
    from ngf_tpu_torch.config import config_parser
    from ngf_tpu_torch.ops import cuda_kernels
    from ngf_tpu_torch.utils.checkpoint import load_checkpoint

    cuda = device.type == "cuda"
    here = os.path.dirname(os.path.abspath(__file__))
    out: dict = {"k5_shard": k5_shard_rows(device)} if cuda else {}
    if cuda:
        out["nccl"] = nccl_check(device, 3 * 256 * 256 * 96)
    with tempfile.TemporaryDirectory() as tmp:
        scene = os.path.join(tmp, "scene")
        write_blender_scene(scene, views, wh)
        down = str(800 / wh)

        def argv(tag: str, *more: str) -> list[str]:
            return ["--config", os.path.join(here, TRAIN_CONFIG), "--dataset_name", "blender",
                    "--datadir", scene, "--downsample_train", down, "--downsample_test", down,
                    "--render_test", "1", "--basedir", tmp, "--expname", tag,
                    "--progress_refresh_rate", "100", *more, *extra]

        # (a) Data-parallel, grouped, across the mask event.
        a_argv = argv("a", "--n_iters", str(iters))
        rank_device = "cuda:0" if cuda else "cpu"
        ranks = run_ranks(tmp, "a", a_argv + ["--mesh_shape", "2x1"], rank_device)
        cuda_kernels.reset_launch_counts()
        ref = main_torch.main(a_argv + ["--expname", "a1", "--device", device.type])
        ref_launches = {k: fn.launches for k, fn in cuda_kernels.KERNELS.items()}
        args = config_parser(a_argv)
        vol = {tag: load_checkpoint(os.path.join(tmp, tag, "model.npz"), "cpu")[2]
               for tag in ("a", "a1")}
        a = {"ranks": ranks, "one_rank": {k: ref[k] for k in ("events", "test_psnrs",
                                                               "wall_time_s", "stages")}}
        ev2, ev1 = ranks[0]["events"], ref["events"]
        keys = ("voxels", "rays_kept", "sample_cap", "capg")
        a["events"] = {"two ranks": [{k: e[k] for k in keys} for e in ev2],
                       "one rank": [{k: e[k] for k in keys} for e in ev1]}
        check(vol["a"] is not None and vol["a1"] is not None, "(a) a checkpoint without its mask")
        occ = {k: v > 0 for k, v in vol.items()}
        a["mask_equal"] = torch.equal(occ["a"], occ["a1"])
        a["mask_voxels_differ"] = int((occ["a"] != occ["a1"]).sum().item())
        a["mask_voxels"] = int(occ["a1"].sum().item())
        a["psnr_gap_db"] = abs(ranks[0]["test_psnrs"][0] - ref["test_psnrs"][0])
        a["ms_per_step"] = host_ms_per_step(ranks[0]["stages"])
        a["one_rank_ms_per_step"] = host_ms_per_step(ref["stages"])
        a["reduce_ms"] = float(np.mean(ranks[0]["reduce_ms"])) if ranks[0]["reduce_ms"] else None
        a["reduce_numel"] = ranks[0]["reduce_numel"]
        print(f"[parallel] (a) --mesh_shape 2x1, {iters} grouped steps across the mask event, "
              f"two ranks on one card over gloo: {a['ms_per_step']:.3f} ms/step on the host "
              f"clock (one rank alone {a['one_rank_ms_per_step']:.3f}), the gradient all-reduce "
              f"{a['reduce_ms']} ms/step ({a['reduce_numel']} floats); events "
              f"{json.dumps(a['events'])}; mask equal {a['mask_equal']} "
              f"({a['mask_voxels_differ']} of {a['mask_voxels']} voxels differ); test psnr "
              f"{ranks[0]['test_psnrs']} against one rank's {ref['test_psnrs']}; rank digests "
              f"{[r['params_sha1'][:12] for r in ranks]}")
        out["a"] = a
        # (b) Sample-parallel, dense.
        b_argv = argv("b", "--group_size", "0", "--n_iters", str(sp_iters),
                      "--mesh_shape", "1x2")
        b_ranks = run_ranks(tmp, "b", b_argv, rank_device)
        one_argv = [x for x in b_argv if x not in ("--mesh_shape", "1x2")]
        cuda_kernels.reset_launch_counts()
        got = main_torch.main(one_argv + ["--sample_cap", "0", "--expname", "b1",
                                          "--device", device.type])
        sp_ref_launches = {k: fn.launches for k, fn in cuda_kernels.KERNELS.items()}
        last = lambda m: float(np.mean(m[-50:]))  # noqa: E731
        b = {"ranks": b_ranks, "loss_last50": last(b_ranks[0]["mses"]),
             "one_rank_loss_last50": last(got["train_mses"]),
             "one_rank_test_psnr": got["test_psnrs"][0],
             "one_rank_ms_per_step": host_ms_per_step(got["stages"])}
        b["loss_rel_gap"] = abs(b["loss_last50"] - b["one_rank_loss_last50"]) / b[
            "one_rank_loss_last50"]
        b["psnr_gap_db"] = abs(b_ranks[0]["test_psnrs"][0] - b["one_rank_test_psnr"])
        if train is not None and len(train["mses"]) != sp_iters:
            train = None  # another length: another function to hold (b) to
        if train is not None:
            b["train_loss_last50"], b["train_test_psnr"] = last(train["mses"]), train["test_psnr"]
            b["train_loss_rel_gap"] = abs(b["loss_last50"] - b["train_loss_last50"]) / b[
                "train_loss_last50"]
            b["train_psnr_gap_db"] = b_ranks[0]["test_psnrs"][0] - train["test_psnr"]
        b["ms_per_step"] = host_ms_per_step(b_ranks[0]["stages"])
        b["reduce_ms"] = float(np.mean(b_ranks[0]["reduce_ms"])) if b_ranks[0]["reduce_ms"] else None
        print(f"[parallel] (b) --mesh_shape 1x2 --group_size 0, {sp_iters} dense steps of 884 "
              f"samples over 2 shards, two ranks on one card over gloo: {b['ms_per_step']:.3f} "
              f"ms/step on the host clock (one rank alone, all 884 samples, "
              f"{b['one_rank_ms_per_step']:.3f}), the gradient all-reduce {b['reduce_ms']} "
              f"ms/step; last-50 mean loss {b['loss_last50']:.6f} against one rank's "
              f"{b['one_rank_loss_last50']:.6f} (gap {b['loss_rel_gap']:.3%}); test psnr "
              f"{b_ranks[0]['test_psnrs']} against one rank's {b['one_rank_test_psnr']}; "
              + (f"against the train phase's cap-512 run: loss {b['train_loss_last50']:.6f} (gap "
                 f"{b['train_loss_rel_gap']:.3%}), psnr {b['train_test_psnr']} ((b) minus it "
                 f"{b['train_psnr_gap_db']:+.3f} dB); " if train is not None else "")
              + f"rank digests {[r['params_sha1'][:12] for r in b_ranks]}")
        out["b"] = b
        # (c) The UV trainer on a data mesh.
        c = uv_mesh_compare(tmp, device, rank_device, uv_steps, uv_sizes)
        c_ranks, one = c["ranks"], c["one_rank"]
        out["c"] = c

    # The checks, after every number is printed.
    check(all(r["iterations"] == iters for r in ranks), "(a) ranks' iterations")
    check(ranks[0]["params_sha1"] == ranks[1]["params_sha1"], "(a) ranks' parameters differ")
    check(ranks[0]["occ_sha1"] == ranks[1]["occ_sha1"]
          and ranks[0]["ray_ids_sha1"] == ranks[1]["ray_ids_sha1"]
          and ranks[0]["auto_cap"] == ranks[1]["auto_cap"], "(a) ranks' masks, rays or caps differ")
    check(len(ev2) == len(ev1) == 1 and ev2[0]["sample_cap"] == ev1[0]["sample_cap"]
          and ev2[0]["capg"] == ev1[0]["capg"]
          and abs(ev2[0]["rays_kept"] - ev1[0]["rays_kept"]) <= PARALLEL_MASK_REL * ev1[0]["rays_kept"]
          and a["mask_voxels_differ"] <= PARALLEL_MASK_REL * a["mask_voxels"],
          f"(a) mask, kept rays or capacity against one rank: {a['events']}, "
          f"{a['mask_voxels_differ']} of {a['mask_voxels']} voxels differ")
    check(a["psnr_gap_db"] <= PARALLEL_PSNR_GAP_DB, f"(a) psnr gap {a['psnr_gap_db']}")
    check(all(r["iterations"] == sp_iters for r in b_ranks), "(b) ranks' iterations")
    check(b_ranks[0]["params_sha1"] == b_ranks[1]["params_sha1"], "(b) ranks' parameters differ")
    check(all(math.isfinite(m) for m in b_ranks[0]["mses"]), "(b) losses")
    check(b["loss_rel_gap"] <= PARALLEL_SP_LOSS_RTOL, f"(b) loss gap {b['loss_rel_gap']}")
    check(b["psnr_gap_db"] <= PARALLEL_PSNR_GAP_DB, f"(b) psnr gap {b['psnr_gap_db']}")
    check(train is None or b["train_loss_rel_gap"] <= PARALLEL_SP_TRAIN_LOSS_RTOL,
          f"(b) loss gap to the train phase's run {b.get('train_loss_rel_gap')}")
    if cuda:
        chunks = -(-wh * wh // args.eval_chunk)
        want = staged_launches(args, ev1, wh)
        for rank, r in enumerate(ranks):
            w = staged_launches(args, ev2, wh)
            if rank:  # the final evaluation runs on rank 0 alone
                for k in ("bilinear_gather_planes", "group_sample_compact", "ray_march_triplane"):
                    w[k] -= chunks
            check(r["launches"] == w, f"(a) rank {rank} launches {r['launches']}, expected {w}")
        check(ref_launches == want, f"(a) one rank's launches {ref_launches}, expected {want}")
        for rank, r in enumerate(b_ranks):
            evals = chunks if rank == 0 else 0
            w = {**{k: 0 for k in cuda_kernels.KERNELS}, "bilinear_gather_planes": sp_iters + evals,
                 "bilinear_gather_2d_backward": 6 * sp_iters, "gather_rows": sp_iters,
                 "ray_march_triplane": evals, "ray_march_triplane_totals": sp_iters,
                 "ray_march_triplane_shard": sp_iters,
                 "ray_march_triplane_shard_backward": sp_iters}
            check(r["launches"] == w, f"(b) rank {rank} launches {r['launches']}, expected {w}")
    check(all(len(r["mses"]) == uv_steps and all(math.isfinite(m) for m in r["mses"])
              for r in c_ranks), "(c) ranks' losses")
    check(c_ranks[0]["params_sha1"] == c_ranks[1]["params_sha1"], "(c) ranks' parameters differ")
    check(all(over <= 1.0 for over in c["first_step_over"].values()),
          f"(c) the first step against one rank: {c['first_step_over']}")
    check(c["loss_rel_gap"] <= PARALLEL_SP_LOSS_RTOL, f"(c) loss gap {c['loss_rel_gap']}")
    if cuda:
        w = {**{k: 0 for k in cuda_kernels.KERNELS}, "ray_march": uv_steps,
             "ray_march_backward": uv_steps}
        for r in c_ranks + [one]:
            check(r["launches"] == w, f"(c) rank {r['rank']} launches {r['launches']}, "
                                      f"expected {w}")
    out["launches"] = {f"parallel 2x1 rank {i}": r["launches"] for i, r in enumerate(ranks)}
    out["launches"].update({f"parallel 1x2 rank {i}": r["launches"] for i, r in enumerate(b_ranks)})
    out["launches"]["parallel one rank"] = ref_launches
    out["launches"]["parallel one rank dense"] = sp_ref_launches
    out["launches"].update({f"parallel uv rank {i}": r["launches"] for i, r in enumerate(c_ranks)})
    out["launches"]["parallel uv one rank"] = one["launches"]
    return out


# ---------------------------------------------------------------- the I/O tail



def write_lpips_weights(root: str) -> float:
    """Random LPIPS alex and vgg weights (`utils/lpips.py:random_weights`,
    the tests' generators, seeds 0 and 1) written as ``root/lpips_{net}.npz``,
    the stand-in for the pretrained files, which are not in the repository:
    the metric then runs, on the card, wherever an evaluation asks for it.
    Returns the seconds it took."""
    from ngf_tpu_torch.utils.lpips import random_weights

    t0 = time.perf_counter()
    os.makedirs(root, exist_ok=True)
    for seed, net in enumerate(("alex", "vgg")):
        np.savez(os.path.join(root, f"lpips_{net}.npz"),
                 **random_weights(net, np.random.default_rng(seed)))
    return time.perf_counter() - t0


def video_frames(path: str) -> int:
    """The frames of a video, read back through OpenCV."""
    import cv2

    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def check_videos(folder: str, frames: int, prtx: str = "") -> dict:
    """``{prtx}video.mp4`` and ``{prtx}depthvideo.mp4`` in ``folder``, each of
    ``frames`` frames."""
    got = {name: video_frames(os.path.join(folder, f"{prtx}{name}"))
           for name in ("video.mp4", "depthvideo.mp4")}
    check(all(n == frames for n in got.values()), f"{folder}: video frames {got}, want {frames}")
    return got


def read_ply_vertices(path: str) -> np.ndarray:
    """The (V, 3) vertices of an ASCII PLY, its header and face count checked."""
    with open(path) as f:
        lines = f.read().splitlines()
    end = lines.index("end_header")
    nv = int(next(ln for ln in lines if ln.startswith("element vertex")).split()[-1])
    nf = int(next(ln for ln in lines if ln.startswith("element face")).split()[-1])
    check(len(lines) == end + 1 + nv + nf, f"{path}: {len(lines)} lines for {nv} vertices, "
                                           f"{nf} faces")
    verts = np.array([ln.split() for ln in lines[end + 1:end + 1 + nv]], np.float64)
    return verts.reshape(-1, 3)


def export_k1_row(device: torch.device, model=None) -> dict:
    """K1 at the mesh export's shape: one chunk of the 256^3 lattice (524,288
    points over the box) projected on the three planes, the density channels
    0:24 of the planes (the staged phase's trained model, else random planes
    of its width), as ``compute_alpha_grid_chunk`` fetches them; against
    ``grid_sample_planes_plain`` (1e-5) and one batched ``F.grid_sample`` of
    the three planes' density channels, timed beside its bound."""
    from ngf_tpu_torch.fields.triplane import triplane_project
    from ngf_tpu_torch.ops.cuda_kernels import bilinear_gather_planes
    from ngf_tpu_torch.ops.grid_sample import grid_sample_planes_plain, normalize_coord
    from ngf_tpu_torch.train.occupancy import dense_grid_points

    if model is not None:
        params, meta = model[0], model[1]
        planes, aabb = [params[n] for n in PLANE_NAMES], meta["aabb"]
        which = "the staged phase's trained planes"
    else:
        gen = torch.Generator(device=device).manual_seed(SEED + 5)
        planes = [0.1 * torch.randn((256, 256, 96), generator=gen, device=device)
                  for _ in range(3)]
        aabb, which = AABB, "random planes"
    dens = slice(0, 24)
    aabb_t = torch.as_tensor(np.asarray(aabb, np.float32), device=device)
    pts = dense_grid_points(aabb, (EXPORT_GRID,) * 3, device).reshape(-1, 3)[:EXPORT_CHUNK]
    coords = triplane_project(normalize_coord(pts, aabb_t))
    n = pts.shape[0]
    got, _ = bilinear_gather_planes(planes, coords, dens)
    ref, _ = grid_sample_planes_plain(planes, coords, dens)
    err = (got - ref).abs().max().item()
    check(err <= F32_TOL, f"K1 at the export chunk: err {err}")
    lib_planes = torch.stack([p[..., dens].permute(2, 0, 1) for p in planes]).contiguous()
    lib_grid = torch.stack([c.reshape(n, 2) for c in coords]).view(3, n, 1, 2)
    ms = cuda_ms(lambda: bilinear_gather_planes(planes, coords, dens), reps=20)
    plain_ms = cuda_ms(lambda: grid_sample_planes_plain(planes, coords, dens), reps=3)
    library_ms = cuda_ms(lambda: F.grid_sample(lib_planes, lib_grid, mode="bilinear",
                                               padding_mode="zeros", align_corners=True), reps=10)
    # The output written once, the points read once (the projections are
    # views of one xyz), the three planes' density channels read once.
    bound_ms, bound_by = bytes_bound_ms(n * 3 * 24 * 4 + 12 * n + 3 * 256 * 256 * 24 * 4,
                                        7 * n * 3 * 24 + 30 * n * 3)
    row = {"case": "mesh export chunk", "N": n, "C": 24, "planes": which, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bound_share": bound_ms / ms,
           "launches_per_export": EXPORT_LAUNCHES}
    print("[tail] K1 " + json.dumps(row))
    return row


def pdf_draw_bound(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """How far a draw of ``sample_pdf`` may move between two devices. Each
    float32 CDF value is a sum of B terms, which another order of summation
    may round up to delta = B * eps32 apart; that moves a draw by up to
    3 * delta * (bin width / CDF step) in its bin (the step taken as 1e-5 at
    least), and a draw within delta of a bin's edge may fall into the next
    bin, whose slope then counts too."""
    nb = weights.shape[-1]
    delta = nb * torch.finfo(torch.float32).eps
    w = weights.double() + 1e-5
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    slope = bins.double().diff(dim=-1).abs() / cdf.diff(dim=-1).clamp_min(1e-5)
    u = u.double().contiguous()
    i = (torch.searchsorted(cdf, u, right=True) - 1).clamp(0, nb - 1)
    k = slope.gather(-1, i)
    k = torch.where(u - cdf.gather(-1, i) < delta,
                    torch.maximum(k, slope.gather(-1, (i - 1).clamp_min(0))), k)
    k = torch.where(cdf.gather(-1, i + 1) - u < delta,
                    torch.maximum(k, slope.gather(-1, (i + 1).clamp_max(nb - 1))), k)
    return 3.0 * delta * k


def uv_ray_bounds(want: tuple, draws: tuple | None = None, refined: bool = False,
                  domain: float = 1.0) -> list:
    """For each output of a UV ray function, how far the card may be from
    the CPU's ``want``: UV_RAY_TOL of each value, plus the move of the
    inverse-CDF ``draws`` (bins, weights, u) behind it. Sorting moves no
    value further than its ray's largest move; a segment length has two
    ends; directions are unit. For a mask, the entries that must agree: all,
    but samples of a refined ray within their bound of the cube's face."""
    move = 0.0 if draws is None else pdf_draw_bound(*draws).float()
    if refined:
        move = move.amax(-1, keepdim=True)
        raypos, seg, valid, mid = want
        pos_tol = UV_RAY_TOL * (1 + raypos.abs()) + move[..., None]
        near_face = ((raypos.abs() - domain).abs() <= pos_tol).any(-1)
        return [pos_tol, UV_RAY_TOL * (1 + seg.abs()) + 2 * move, ~near_face,
                UV_RAY_TOL * (1 + mid.abs()) + move]
    return [torch.ones_like(w) if w.dtype == torch.bool else UV_RAY_TOL * (1 + w.abs()) + move
            for w in want]


def uv_ray_rows(device: torch.device, rays_side: int = UV_RAYS_SIDE,
                samples: int = UV_SAMPLES, views: int = UV_VIEWS, wh: int = UV_WH) -> dict:
    """The UV ray functions that nothing in the trainer calls yet
    (``cube_ray_generation_with_end``, ``sample_pdf``,
    ``refine_cube_ray_generation``) on the card at the UV step's shape (one
    view's rays x samples, a synthetic DTU batch), each against the same
    call on CPU copies within ``uv_ray_bounds`` (1e-6 of each value, plus
    what float32 CDF rounding moves a draw), timed by CUDA events."""
    from ngf_tpu_torch.data.dtu import SyntheticDtuDataset
    from ngf_tpu_torch.ops import rays

    ds = SyntheticDtuDataset(n_views=views, wh=(wh, wh), random_sample="balanced",
                             random_sample_size=rays_side, seed=SEED)
    item = ds.sample()
    g = torch.Generator(device=device).manual_seed(SEED + 6)
    campos = torch.as_tensor(item["campos"], device=device)
    d = torch.as_tensor(item["raydir"], device=device)
    r, s = d.shape[1], samples
    end = campos[:, None] + d * (campos.norm() * (0.6 + 0.6 * torch.rand(
        (1, r, 1), generator=g, device=device)))
    prev_ts = torch.sort(campos.norm() - 1.0 + 2.0 * torch.rand(
        (1, r, s), generator=g, device=device)).values
    inputs = {"campos": campos, "d": d, "end": end, "prev_ts": prev_ts,
              "prev_w": torch.rand((1, r, s), generator=g, device=device),
              "u": torch.rand((1, r, s), generator=g, device=device),
              "u2": torch.rand((1, r, s + 1), generator=g, device=device)}
    inputs["bins"] = 0.5 * (prev_ts[..., 1:] + prev_ts[..., :-1])
    calls = {
        "cube_ray_generation_with_end": lambda t: rays.cube_ray_generation_with_end(
            t["campos"], t["d"], t["end"], s, 1.0, 0.5, t["u"]),
        "sample_pdf": lambda t: (rays.sample_pdf(t["bins"], t["prev_w"][..., 1:-1], s + 1,
                                                 u=t["u2"]),),
        "refine_cube_ray_generation": lambda t: rays.refine_cube_ray_generation(
            t["campos"], t["d"], s, t["prev_ts"], t["prev_w"], 1.0, False, u=t["u2"]),
    }
    cpu = {k: v.cpu() for k, v in inputs.items()}
    draws = (cpu["bins"], cpu["prev_w"][..., 1:-1], cpu["u2"])
    out = {}
    for name, fn in calls.items():
        got = fn(inputs)
        want = fn(cpu)
        bounds = uv_ray_bounds(want, None if name == "cube_ray_generation_with_end" else draws,
                               refined=name == "refine_cube_ray_generation")
        err, excused = 0.0, 0
        for a, w, bound in zip(got, want, bounds):
            check(a.device == d.device, f"{name}: output on {a.device}")
            a = a.cpu()
            if w.dtype == torch.bool:
                check(torch.equal(a[bound], w[bound]), f"{name}: mask differs from the CPU's")
                excused += int((a != w).sum())
            else:
                over = ((a - w).abs() / bound).max().item()
                check(over <= 1.0, f"{name}: {over} times its bound from the CPU's")
                err = max(err, (a - w).abs().max().item())
        out[name] = {"rays": r, "samples": s, "max_abs_err": err,
                     "mask_flips_at_the_face": excused,
                     "ms": host_or_cuda_ms(lambda: fn(inputs), device, reps=20)}
    print("[tail] UV ray functions on the card: " + json.dumps(out))
    return out


def lpips_rows(device: torch.device, wh: int = LPIPS_WH, crop: int = LPIPS_CROP) -> dict:
    """LPIPS alex and vgg (the random weights of ``NGF_LPIPS_WEIGHTS_DIR``)
    on the card: ms per ``wh`` x ``wh`` view as ``evaluation`` pays it (the
    two images' upload, the forward, one read of the five taps), and the
    card's value against the CPU forward on a ``crop`` x ``crop`` crop (rtol
    LPIPS_RTOL)."""
    from ngf_tpu_torch.utils import lpips

    rng = np.random.default_rng(SEED)
    a = rng.uniform(0, 1, (wh, wh, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    out = {}
    for net in ("alex", "vgg"):
        check(lpips.lpips_available(net), f"no LPIPS-{net} weights at {lpips.weights_path(net)}")
        value = lpips.rgb_lpips(a, b, net, device)
        ms = host_or_cuda_ms(lambda: lpips.rgb_lpips(a, b, net, device), device, reps=5)
        ca, cb = a[:crop, :crop], b[:crop, :crop]
        card, cpu = lpips.rgb_lpips(ca, cb, net, device), lpips.rgb_lpips(ca, cb, net, "cpu")
        check(math.isfinite(value) and abs(card - cpu) <= LPIPS_RTOL * abs(cpu),
              f"LPIPS-{net} on the card {card} against the CPU's {cpu}")
        out[net] = {"wh": wh, "value": value, "ms": ms, "crop": crop, "card": card, "cpu": cpu,
                    "rel_err": abs(card - cpu) / abs(cpu)}
    print("[tail] LPIPS " + json.dumps(out))
    return out


def trace_steps(device: torch.device, steps: int = 3, wh: int = TRAIN_WH,
                extra: tuple[str, ...] = ()) -> dict:
    """``utils.profiling.trace`` around ``steps`` dense train steps of
    ``configs/synthetic_infoinv_tpu.txt --group_size 0`` (one view): the
    Chrome trace it writes beside ``ngf_spans.json`` must name K1's kernel
    symbol (on the card) and the ``annotate`` region around the steps, and
    hold as many K1 events as K1's launch count over those steps."""
    from ngf_tpu_torch.config import config_parser
    from ngf_tpu_torch.ops import cuda_kernels
    from ngf_tpu_torch.data import load_dataset
    from ngf_tpu_torch.train.loop import TriPlaneTrainer
    from ngf_tpu_torch.utils.profiling import annotate, trace

    here = os.path.dirname(os.path.abspath(__file__))
    args = config_parser(["--config", os.path.join(here, TRAIN_CONFIG), "--group_size", "0",
                          "--device", device.type, *extra])
    ds = load_dataset("synthetic", f"synthetic:views=1,wh={wh}", split="train", is_stack=False)
    trainer = TriPlaneTrainer(args, ds, device=device)
    step = lambda: trainer.train_step(*trainer.next_batch(), trainer.gen)  # noqa: E731
    step()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    with tempfile.TemporaryDirectory() as tmp:
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with trace(tmp):
            with annotate("chip_smoke_train_steps"):
                for _ in range(steps):
                    step()
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
        traced_s = time.perf_counter() - t0
        launched = cuda_kernels.KERNELS["bilinear_gather_planes"].launches
        files = os.listdir(tmp)
        chrome = [f for f in files if f.endswith(".pt.trace.json")]
        check(len(files) == 2 and "ngf_spans.json" in files and len(chrome) == 1,
              f"trace files {files}")
        with open(os.path.join(tmp, chrome[0])) as f:
            events = json.load(f)["traceEvents"]
        size = os.path.getsize(os.path.join(tmp, chrome[0]))
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    k1 = [k for k in kernels if "bilinear_gather_planes_kernel" in k]
    out = {"steps": steps, "events": len(events), "kernels": len(kernels), "k1": len(k1),
           "k1_launches": launched, "k1_symbol": k1[0] if k1 else None, "bytes": size,
           "traced_s": traced_s}
    print("[tail] trace " + json.dumps(out))
    check(any(e.get("name") == "chip_smoke_train_steps" for e in events), "trace: no region")
    check(device.type != "cuda" or launched >= steps, f"trace: K1 launched {launched} times "
                                                      f"in {steps} steps")
    check(len(k1) == launched, f"trace: K1 {len(k1)} times in {len(kernels)} kernels, "
                               f"launched {launched} times")
    return out


def trace_in_subprocess() -> dict:
    """:func:`trace_steps` in a fresh process (``--trace_steps``): late in a
    whole run, after the earlier phases' profiles, this process's profiler
    keeps fewer kernel events than were launched (K1's counter 3 over the
    traced steps, its trace 2)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--trace_steps", path],
                              capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"the trace subprocess exited {proc.returncode}:\n"
                                    f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        with open(path) as f:
            out = json.load(f)
    print("[tail] trace " + json.dumps(out))
    return out


def tail_phase(device: torch.device, staged: dict | None = None) -> dict:
    """The I/O tail on the card: the UV ray functions against the CPU, LPIPS
    timed and held against its CPU forward, K1 at the mesh export's chunk,
    and ``trace()`` around three train steps (in a fresh process)."""
    return {"uv_rays": uv_ray_rows(device), "lpips": lpips_rows(device),
            "export_k1": export_k1_row(device, None if staged is None else staged["model"]),
            "trace": trace_in_subprocess()}


def uv_mesh_compare(tmp: str, device: torch.device, rank_device: str, uv_steps: int,
                    uv_sizes: dict) -> dict:
    """The parallel phase's run (c): :func:`uv_mesh_run` on two ranks
    (:func:`run_ranks` into ``tmp``) and on one rank in this process, and
    the numbers that it is held to; prints them."""
    c_ranks = run_ranks(tmp, "c", [], rank_device, uv={"steps": uv_steps, "sizes": uv_sizes})
    one = uv_mesh_run(device, uv_steps, uv_sizes)
    c = {"ranks": c_ranks, "one_rank": one,
         "loss_last50": float(np.mean(c_ranks[0]["mses"][-50:])),
         "one_rank_loss_last50": float(np.mean(one["mses"][-50:])),
         "ms_per_step": c_ranks[0]["ms_per_step"],
         "reduce_ms": float(np.mean(c_ranks[0]["reduce_ms"])) if c_ranks[0]["reduce_ms"]
         else None, "reduce_numel": c_ranks[0]["reduce_numel"]}
    c["loss_rel_gap"] = abs(c["loss_last50"] - c["one_rank_loss_last50"]) / c[
        "one_rank_loss_last50"]
    # The first step against one rank, in units of its limit: each loss
    # term (allclose's rule, atol 1e-8) and each gradient leaf (the
    # largest difference over the leaf's largest entry); then the colour
    # loss's gap as the steps go on.
    with np.load(os.path.join(tmp, "c.json.rank0.grads.npz")) as f:
        two_grads = [f[f"arr_{i}"] for i in range(len(f.files))]
    c["first_step_over"] = {
        k: abs(c_ranks[0]["first_losses"][k] - b) / (1e-8 + UV_MESH_FIRST_RTOL * abs(b))
        for k, b in one["first_losses"].items()}
    c["first_step_over"]["gradients"] = max(
        float(np.abs(a - b).max() / (UV_MESH_FIRST_RTOL * max(np.abs(b).max(), 1e-30)))
        for a, b in zip(two_grads, one.pop("first_grads")))
    c["first_losses"] = one["first_losses"]
    c["color_gap_at_step"] = {
        t: abs(c_ranks[0]["mses"][t - 1] - one["mses"][t - 1]) / one["mses"][t - 1]
        for t in (1, 2, 5, 10, 20, 50, 100, uv_steps) if t <= uv_steps}
    print(f"[parallel] (c) UVTrainer(mesh=make_mesh()), {uv_steps} steps of "
          f"{uv_sizes['rays_side'] ** 2} rays x {uv_sizes['samples']} samples, half the rays "
          f"on each of two ranks on one card over gloo: {c['ms_per_step']:.3f} ms/step on the "
          f"host clock (one rank alone {one['ms_per_step']:.3f}), the gradient all-reduce "
          f"{c['reduce_ms']} ms/step ({c['reduce_numel']} floats); last-50 mean colour loss "
          f"{c['loss_last50']:.6f} against one rank's {c['one_rank_loss_last50']:.6f} (gap "
          f"{c['loss_rel_gap']:.3%}); the first step against one rank's in units of its "
          f"limit (rtol {UV_MESH_FIRST_RTOL}): {json.dumps(c['first_step_over'])} (its "
          f"losses {json.dumps(c['first_losses'])}); the colour loss's gap at step "
          f"{json.dumps(c['color_gap_at_step'])}; rank digests "
          f"{[r['params_sha1'][:12] for r in c_ranks]}")
    return c


def uv_mesh_run(device: torch.device, steps: int, sizes: dict, mesh=None) -> dict:
    """The UV trainer at ``sizes`` (the `dtu_train.sh` shape by default), seed
    0, ``steps`` steps in blocks of UV_MESH_BLOCK sampled as the CLI samples
    them, on ``mesh`` (or one rank): the colour losses, every loss term and
    the gradients (after the all-reduce) of the first step, ms a step on
    the host clock (after the first block), the launches, a digest of the
    parameters."""
    import hashlib

    from ngf_tpu_torch.convert import sorted_named_leaves
    from ngf_tpu_torch.data.dtu import SyntheticDtuDataset
    from ngf_tpu_torch.fields.neutex import NeuTexConfig
    from ngf_tpu_torch.ops import cuda_kernels
    from ngf_tpu_torch.train.uv_loop import UVTrainer

    ds = SyntheticDtuDataset(n_views=sizes["views"], wh=(sizes["wh"], sizes["wh"]),
                             random_sample="balanced", random_sample_size=sizes["rays_side"],
                             seed=0)
    cfg = NeuTexConfig(primitive_type="square", sample_num=sizes["samples"],
                       points_per_primitive=sizes["points"], **sizes.get("widths", {}))
    trainer = UVTrainer(cfg, ds, niter=steps, seed=0, device=device, mesh=mesh)
    cuda_kernels.reset_launch_counts()
    mses, t0 = [], None
    # The first step alone, for its losses and gradients; then blocks.
    ends = sorted({1, *range(UV_MESH_BLOCK, steps, UV_MESH_BLOCK), steps})
    for start, end in zip([0, *ends], ends):
        losses = trainer.train_block([ds.sample() for _ in range(end - start)])
        mses += losses["color"].tolist()
        if start == 0:
            first = {k: float(v[0]) for k, v in losses.items()}
            grads = [t.grad.cpu().numpy() for t in trainer.trainable]
        if end == min(UV_MESH_BLOCK, steps):
            t0 = time.perf_counter()
    digest = hashlib.sha1()
    for _, leaf in sorted_named_leaves(trainer.params):
        digest.update(leaf.detach().cpu().numpy().tobytes())
    timed = steps - min(UV_MESH_BLOCK, steps)
    return {"mses": mses, "first_losses": first, "first_grads": grads,
            "ms_per_step": 1e3 * (time.perf_counter() - t0) / max(timed, 1),
            "launches": {k: fn.launches for k, fn in cuda_kernels.KERNELS.items()},
            "params_sha1": digest.hexdigest(), "rank": 0 if mesh is None else mesh.rank,
            "reduce_numel": sum(t.numel() for t in trainer.trainable)}


PHASES = ("kernel", "rows", "backward", "occupancy", "uv", "render", "train", "staged", "gauge",
          "bf16", "topk", "llff", "lego", "tail", "parallel")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of %(default)s; the result lines are "
                             "printed only when all run")
    parser.add_argument("--uv_steps", type=int, default=UV_STEPS,
                        help="steps of the uv phase's square float32 run (SIGTERM after "
                             f"{UV_SIGTERM_AT}, resumed to the end)")
    parser.add_argument("--uv_bf16_steps", type=int, default=UV_BF16_STEPS,
                        help="steps of the uv phase's square bfloat16 run")
    parser.add_argument("--uv_sphere_steps", type=int, default=UV_SPHERE_STEPS,
                        help="steps of the uv phase's sphere run")
    parser.add_argument("--uv_sphere_dtype", default="float32", choices=("float32", "bfloat16"),
                        help="compute dtype of the uv phase's sphere run")
    parser.add_argument("--parallel_rank", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--trace_steps", default=None, help=argparse.SUPPRESS)
    parsed = parser.parse_args(argv)
    if parsed.parallel_rank:  # one rank of the parallel phase (run_ranks)
        return parallel_rank(parsed.parallel_rank)
    if parsed.trace_steps:  # the tail phase's trace (trace_in_subprocess)
        out = trace_steps(torch.device("cuda" if torch.cuda.is_available() else "cpu"))
        with open(parsed.trace_steps, "w") as f:
            json.dump(out, f)
        return 0
    phases = parsed.phases.split(",")
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
    k2c_fp = cuda_kernels.backward_coords_footprint(4)
    print("[device] K2c float4 footprint: " + json.dumps(k2c_fp))
    k2c_bf16_fp = cuda_kernels.backward_coords_footprint(4, torch.bfloat16)
    print("[device] K2c bfloat16 4-channel footprint: " + json.dumps(k2c_bf16_fp))
    rows_fp = cuda_kernels.rows_footprint()
    print("[device] row kernels' footprint (int64 ids): " + json.dumps(rows_fp))
    check(all(f["local_bytes"] == 0 for f in rows_fp.values()), f"row kernels spill: {rows_fp}")
    # LPIPS weights for every evaluation that asks for the metric (the staged
    # phase's CLI run, the gauge and lego recipes' final evaluations).
    lpips_dir = tempfile.TemporaryDirectory()
    os.environ["NGF_LPIPS_WEIGHTS_DIR"] = lpips_dir.name
    print(f"[device] random LPIPS weights written in {write_lpips_weights(lpips_dir.name):.3f} s "
          "(set-up)")

    run = {
        "kernel": lambda: kernel_phase(device, RAYS_PER_CHUNK * 884),
        "rows": lambda: row_gather_phase(device, TRAIN_VIEWS * TRAIN_WH * TRAIN_WH),
        "backward": lambda: backward_phase(device),
        "render": lambda: render_phase(device),
        "train": lambda: train_phase(device),
        "occupancy": lambda: occupancy_phase(device),
        "staged": lambda: staged_phase(device, extra=("--export_mesh", "1",
                                                      "--compute_extra_metrics", "1")),
        "gauge": lambda: gauge_phase(device),
        "bf16": lambda: bf16_phase(device),
        "uv": lambda: uv_phase(device, steps=parsed.uv_steps, bf16_steps=parsed.uv_bf16_steps,
                               sphere_steps=parsed.uv_sphere_steps,
                               sphere_dtype=parsed.uv_sphere_dtype),
        "topk": lambda: topk_phase(device, staged=out.get("staged")),
        "llff": lambda: llff_phase(device),
        "lego": lambda: lego_phase(device),
        "tail": lambda: tail_phase(device, staged=out.get("staged")),
        "parallel": lambda: parallel_phase(device, train=out.get("train")),
    }
    out = {}
    for phase in PHASES:
        if phase in phases:
            t0 = time.perf_counter()
            out[phase] = run[phase]()
            print(f"[device] {phase} phase: {time.perf_counter() - t0:.3f} s")
    lpips_dir.cleanup()
    if set(phases) != set(PHASES):
        print(card)
        return 0
    rows, train = out["kernel"], out["train"]
    bwd_rows = [r for r in out["backward"] if r["fetch"] != "coords"]
    coord_rows = [r for r in out["backward"] if r["fetch"] == "coords"]
    gauge = out["gauge"]
    row_cases = out["rows"]["cases"]

    # Each main path's launches, counted from 0 just before it.
    bf16 = out["bf16"]
    paths = {"render": out["render"]["launches"], "train": out["train"]["launches"],
             "staged": out["staged"]["launches"],
             "staged render-only": out["staged"]["render"]["launches"],
             "gauge": gauge["launches"], "gauge render-only": gauge["render"]["launches"],
             "bf16 infoinv": bf16["infoinv"]["launches"], "bf16 gauge": bf16["gauge"]["launches"],
             "lego": out["lego"]["launches"], "lego resumed": out["lego"]["resumed"]["launches"],
             **out["topk"]["launches"], "llff": out["llff"]["launches"],
             **out["uv"]["launches"], **out["parallel"]["launches"]}
    # The bfloat16 InfoInv paths, whose K2 launches are its bfloat16 variant.
    bf16_infoinv = ("bf16 infoinv", "lego", "lego resumed")
    uv_paths = tuple(out["uv"]["launches"]) + tuple(
        p for p in out["parallel"]["launches"] if p.startswith("parallel uv"))

    def entry(name, source, replaces, row, max_abs_err, at, counters=None, skip=()):
        """A kernel's line; its launches over the main paths but ``skip``
        (the paths that launch its other dtype's variant)."""
        counters = counters or (name,)
        by_path = {path: sum(counts[c] for c in counters) for path, counts in paths.items()
                   if path not in skip}
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max_abs_err,
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "at": at,
        }

    step_rows = [r for state in train["compare"].values() for r in state.get("backward", [])]
    step_rows += out["staged"]["compare"].get("backward", [])
    bf16_k2 = bf16["infoinv"]["compare"]["backward"]
    bf16_k2c = bf16["gauge"]["compare"]["backward"]
    k3, k4 = out["occupancy"]["k3"], out["occupancy"]["k4"]
    fused = [r for r in rows if r["fetch"] == "fused"]
    probe = next(r for r in rows if r["fetch"] == "probe")
    gauge_coord_rows = [gauge["compare"][k] for k in ("backward", "backward_xy")]
    kernels = [
        entry("bilinear_gather_planes", "ngf_tpu_torch/ops/kernels/bilinear_gather.cu",
              "ngf_tpu/ops/pallas_kernels.py:58",
              next(r for r in fused if r["case"] == "train step" and r["dtype"] == "float32"),
              max(r["max_abs_err"] for r in rows if r["dtype"] == "float32"),
              "fused fetch: three planes 256x256x96 float32, split 24, "
              f"N={TRAIN_RAYS * TRAIN_CAP}, train step coordinates",
              ("bilinear_gather_planes", "bilinear_gather_2d")),
        entry("bilinear_gather_2d_backward", "ngf_tpu_torch/ops/kernels/bilinear_gather_backward.cu",
              "ngf_tpu/ops/grid_sample.py:421",
              next(r for r in bwd_rows if r["fetch"] == "appearance" and r["case"] == "train"),
              max(r["max_abs_err"] for r in bwd_rows + step_rows),
              "appearance fetch: plane gradient 256x256x96 float32, channels 24:96, "
              f"N={TRAIN_RAYS * TRAIN_CAP}, train coordinates, random cotangents",
              skip=bf16_infoinv),
        entry("gather_rows", "ngf_tpu_torch/ops/kernels/gather_rows.cu",
              "tools/probe_pallas.py:21,44,68",
              next(r for r in row_cases if r["case"] == "rays"), 0.0,
              f"rays table ({TRAIN_VIEWS * TRAIN_WH * TRAIN_WH}, 6) float32 at {TRAIN_RAYS} ids"),
        entry("occupancy_lookup", "ngf_tpu_torch/ops/kernels/occupancy_lookup.cu",
              "ngf_tpu/ops/grid_sample.py:526",
              next(r for r in k3 if r["case"] == "filter chunk 128^3"), 0.0,
              "mask event's ray filter chunk: 51200 rays x 256 points, 128^3 uint8 volume, "
              "byte for byte"),
        entry("group_sample_compact", "ngf_tpu_torch/ops/kernels/group_compact.cu",
              "ngf_tpu/ops/compaction.py:26",
              next(r for r in k4 if r["case"] == "masked step (cap 224)"), 0.0,
              f"masked train step's front end: {TRAIN_RAYS} rays x {N_GROUPS} groups of {GROUP}, "
              "128^3 uint8 volume, capg 28, byte for byte"),
        entry("bilinear_gather_planes_backward_coords",
              "ngf_tpu_torch/ops/kernels/bilinear_gather_backward.cu",
              "ngf_tpu/ops/grid_sample.py:434",
              next(r for r in coord_rows if r["case"] == "open step, three planes"),
              max(r["max_abs_err"] for r in coord_rows + gauge_coord_rows),
              "gauge open step's fetch in one launch: plane and coordinate gradients of three "
              f"256x256x64 float32 planes, split 16, N={TRAIN_RAYS * TRAIN_CAP}, lego "
              "projections, random cotangents", skip=("bf16 gauge",)),
        entry("bilinear_gather_2d_backward (bfloat16)",
              "ngf_tpu_torch/ops/kernels/bilinear_gather_backward.cu",
              "ngf_tpu/ops/grid_sample.py:421",
              next(r for r in bf16_k2 if r["fetch"] == "appearance"),
              max(r["max_abs_err"] for r in bf16_k2),
              "bfloat16 30k InfoInv cut, a masked step's own bfloat16 cotangents of the xy "
              "plane's appearance fetch into its float32 gradient, channels 24:96",
              counters=("bilinear_gather_2d_backward",),
              skip=tuple(p for p in paths if p not in bf16_infoinv)),
        entry("bilinear_gather_planes_backward_coords (bfloat16)",
              "ngf_tpu_torch/ops/kernels/bilinear_gather_backward.cu",
              "ngf_tpu/ops/grid_sample.py:434", bf16_k2c, bf16_k2c["max_abs_err"],
              "bfloat16 gauge recipe, a step's own bfloat16 cotangents and bfloat16 values of "
              f"three planes {bf16_k2c['shapes']} x 64, split 16, in one launch, float32 "
              "gradients", counters=("bilinear_gather_planes_backward_coords",),
              skip=tuple(p for p in paths if p != "bf16 gauge")),
    ]
    tri_rows = (out["render"]["k5"] + train["k5"] + out["staged"]["k5_open"]
                + out["staged"]["k5_masked"] + gauge["k5_upsampled"])
    k5_fp = cuda_kernels.ray_march_footprint(TRAIN_CAP)
    print("[device] K5 footprint: " + json.dumps(k5_fp))
    profiles = {"render chunk": out["render"]["profile"], "dense train step": train["profile"],
                "masked grouped step": out["staged"]["masked_step_profile"],
                "upsampled gauge step": gauge["upsampled_step_profile"]}
    k5_shares = {k: {f: p[f] for f in ("host_ms", "device_ms", "k5_ms", "k5_share")}
                 for k, p in profiles.items()}
    print("[k5] tri-plane share of the profiled steps: " + json.dumps(k5_shares))
    for r in tri_rows:
        if r["case"] in profiles:
            r["step_device_ms"] = profiles[r["case"]]["k5_kernels"].get(f"triplane_{r['direction']}")
    for direction, name in (("forward", "ray_march_triplane"),
                            ("backward", "ray_march_triplane_backward")):
        rows_d = [r for r in tri_rows if r["direction"] == direction]
        kernels.append(entry(
            name, "ngf_tpu_torch/ops/kernels/ray_march.cu", "ngf_tpu/ops/compositing.py:32",
            next(r for r in rows_d if r["case"] == "dense train step"),
            max(r["max_abs_err"] for r in rows_d),
            f"K5 tri-plane mode, dense InfoInv train step: {TRAIN_RAYS} rays x {TRAIN_CAP} "
            "samples of the trained model, float32, per-sample lengths, white background"
            + ("; the step's own cotangents" if direction == "backward" else ""),
            skip=uv_paths))
        kernels[-1]["rows"] = [{k: r.get(k) for k in (
            "case", "N", "S", "ms", "graph_ms", "step_device_ms", "bound_ms", "bound_by",
            "plain_ms", "library_ms", "before_fwd_bwd_ms", "kernel_fwd_bwd_graph_ms", "max_abs_err", "mask_flips",
            "shaded_share")} for r in rows_d]
        kernels[-1]["footprint"] = k5_fp[f"triplane_{direction}"]
    kernels[-1]["k5_share_of_profiled_steps"] = k5_shares
    k5 = out["uv"]["k5"]
    for direction, name in (("forward", "ray_march"), ("backward", "ray_march_backward")):
        rows_d = [r for r in k5 if r["direction"] == direction]
        kernels.append(entry(
            name, "ngf_tpu_torch/ops/kernels/ray_march.cu", "ngf_tpu/ops/compositing.py:49",
            next(r for r in rows_d if r["case"] == "train step"),
            max(r["max_abs_err"] for r in rows_d),
            f"UV train step: 1 x {UV_RAYS_SIDE ** 2} rays x {UV_SAMPLES} samples, float32, "
            "valid and invalid samples, the colour part with the tone map"
            + ("; random cotangents of colour, w and T_total" if direction == "backward" else ""),
            skip=tuple(p for p in paths if p not in uv_paths)))
        kernels[-1]["rows"] = [{k: r.get(k) for k in (
            "case", "N", "S", "invalid_share", "ms", "graph_ms", "bound_ms", "bound_by", "plain_ms",
            "library_ms", "max_abs_err", "max_value")} for r in rows_d]
        kernels[-1]["footprint"] = k5_fp[f"neutex_{direction}"]
    shard = out["parallel"]["k5_shard"]
    sp_paths = tuple(p for p in paths if p.startswith("parallel 1x2"))
    for direction, name, line in (("totals", "ray_march_triplane_totals", 99),
                                  ("forward", "ray_march_triplane_shard", 105),
                                  ("backward", "ray_march_triplane_shard_backward", 105)):
        rows_d = [r for r in shard["rows"] if r["direction"] == direction]
        kernels.append(entry(
            name, "ngf_tpu_torch/ops/kernels/ray_march.cu",
            f"ngf_tpu/parallel/sample_parallel.py:{line}",
            next(r for r in rows_d if r["case"] == "2 shards"), shard["max_abs_err"],
            f"K5 shard mode, the sample-parallel path's shard: {RAYS_PER_CHUNK} rays x 442 of "
            "884 samples, float32, the path's one length, t0 random in (0, 1]"
            + ("; random cotangents of y, acc and t_end" if direction == "backward" else ""),
            skip=tuple(p for p in paths if p not in sp_paths)))
        kernels[-1]["rows"] = [{k: r[k] for k in ("case", "N", "S", "ms", "graph_ms", "bound_ms",
                                                  "bound_by", "plain_ms", "library_ms")}
                               for r in rows_d]
        kernels[-1]["footprint"] = k5_fp[f"shard_{direction}"]
    kernels[-1]["split_identity"] = shard["split"]
    topk = out["topk"]
    topk_paths = tuple(topk["launches"])
    topk_runs = [k for k in ("smoke", "fused", "auto") if "topk" in topk[k]]
    for direction, name in (("forward", "ray_march_triplane_topk"),
                            ("backward", "ray_march_triplane_topk_backward")):
        rows_d = [r for k in topk_runs for r in topk[k]["topk"]["k5"]
                  if r["direction"] == direction]
        kernels.append(entry(
            name, "ngf_tpu_torch/ops/kernels/ray_march.cu", "ngf_tpu/render/volume.py:315",
            rows_d[0], max(r["max_abs_err"] for r in rows_d),
            f"K5 top-K mode, configs/synthetic_smoke.txt's masked step: a microbatch chunk of "
            f"{rows_d[0]['N']} rays x {rows_d[0]['S']} samples, the top {rows_d[0]['K'] // 8} "
            "groups of 8 shaded, float32, its own inputs"
            + ("; its own cotangent" if direction == "backward" else ""),
            skip=tuple(p for p in paths if p not in topk_paths)))
        kernels[-1]["rows"] = [{k: r[k] for k in ("case", "N", "S", "K", "G", "ms", "graph_ms",
                                                  "bound_ms", "bound_by", "plain_ms",
                                                  "library_ms", "max_abs_err", "shaded_share")}
                               for r in rows_d]
        kernels[-1]["footprint"] = k5_fp[f"topk_{direction}"]
    kernels[-1]["profiles"] = {k: {f: topk[k]["topk"]["profile"][f] for f in (
        "host_ms", "device_ms", "launches", "idle_share", "k5_ms", "cumprod_calls")}
        for k in topk_runs}
    group_rows = [r for k in topk_runs for r in topk[k]["topk"]["rows"]]
    scatter = [r for r in group_rows if r["kernel"] == "scatter_rows"]
    packed_rows = out["staged"]["packed"] + gauge["packed"]
    kernels.append(entry(
        "scatter_rows", "ngf_tpu_torch/ops/kernels/gather_rows.cu", "ngf_tpu/ops/compaction.py:50",
        next(r for r in scatter if r["case"].startswith("topk_fused")), 0.0,
        "the group gather's backward on the staged recipe's masked step at rgb_cap 64: the "
        "fused fetch's features of the kept groups as one table, the picked groups' rows "
        "written, byte for byte (and, in packed_rows, the packed training render's scatters "
        "back into the slot layout)"))
    kernels[-1]["rows"] = scatter
    kernels[-1]["packed_rows"] = [r for r in packed_rows if r["kernel"] == "scatter_rows"]
    kernels[-1]["footprint"] = {k: v for k, v in rows_fp.items() if k.startswith("scatter")}
    kernels[2]["group_gather_rows"] = [r for r in group_rows if r["kernel"] == "gather_rows"]
    kernels[2]["packed_rows"] = [r for r in packed_rows if r["kernel"] == "gather_rows"]
    kernels[2]["footprint"] = {k: v for k, v in rows_fp.items() if k.startswith("gather")}
    kernels[0]["rows"] = [
        {k: r[k] for k in ("case", "dtype", "ms", "bound_ms", "plain_ms", "library_ms",
                           "taps_per_point")} for r in fused]
    kernels[0]["rows"].append({k: gauge["k1_three_shapes"][k] for k in (
        "case", "shapes", "N", "ms", "bound_ms", "plain_ms", "library_ms")})
    kernels[0]["rows"].append({k: out["tail"]["export_k1"][k] for k in (
        "case", "N", "C", "ms", "bound_ms", "bound_by", "plain_ms", "library_ms",
        "launches_per_export")})
    kernels[0]["probe_row"] = {k: probe[k] for k in (
        "case", "N", "ms", "bound_ms", "plain_ms", "library_ms")}
    kernels[5]["rows"] = [{k: r.get(k) for k in ("case", "P", "shapes", "N", "ms", "bound_ms",
                                                 "plane_branch_bound_ms", "plain_ms", "library_ms",
                                                 "autograd_ms")}
                          for r in coord_rows + gauge_coord_rows]
    kernels[5].update(k2c_fp)
    kernels[6]["rows"] = [{k: r.get(k) for k in ("case", "fetch", "dtype", "C", "ms", "bound_ms",
                                                 "plain_ms", "library_ms")} for r in bf16_k2]
    kernels[7].update(k2c_bf16_fp)
    kernels[7]["autograd_ms"] = bf16_k2c.get("autograd_ms")
    kernels[1]["random_coords_ms"] = next(
        r["ms"] for r in bwd_rows if r["fetch"] == "appearance" and r["case"] == "random")
    kernels[1]["step_cotangent_ms"] = {
        r["case"]: r["ms"] for r in step_rows if r["fetch"] == "appearance"}
    kernels[3]["rows"] = [{k: r[k] for k in ("case", "N", "ms", "device_ms", "bound_ms",
                                             "plain_ms", "library_ms")} for r in k3 if "ms" in r]
    kernels[4]["rows"] = [{k: r[k] for k in ("case", "capg", "ms", "device_ms", "bound_ms",
                                             "plain_ms", "library_ms")} for r in k4]
    kernels[4]["front_end"] = out["occupancy"]["front_end"]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} never launched on its main paths: "
                                 f"{k['launches_by_path']}")
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
