#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`ngf_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Device: requires CUDA, prints the card and its power limit, builds every
   kernel of the port from the sources in this checkout.
2. Kernel phase: ``bilinear_gather_2d`` at the render path's shapes (a
   256 x 256 x 96 plane, N = 4096 rays x 884 samples, the density channels
   0:24 and the appearance channels 24:96, float32 and bfloat16) against its
   plain PyTorch version, timed beside its bound and ``F.grid_sample``.
3. Render phase: a random InfoInv tri-plane model at full width, saved as a
   checkpoint with the lego geometry, rendered through ``main_torch.main``
   (render-only, one 800 x 800 synthetic test view, 4096-ray chunks). The
   kernel's launch count over that run must be 6 per chunk; one chunk is
   rendered again with the plain sampler and compared, timed, and profiled
   (device time by op, torch.profiler).

Prints per-phase lines, then the card line, a JSON line of kernel numbers,
and last ``{"ok": true, "device": {...}}``. Any failure raises: the script
then exits non-zero and prints no ``ok`` line. It imports nothing of JAX or
of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

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

RAYS_PER_CHUNK = 4096
WH = 800


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


def profile_chunk(render, reps: int = 3) -> None:
    """Where one render chunk's device time goes: torch.profiler over
    ``reps`` calls of ``render()``, ops sorted by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            render()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    events = prof.key_averages()
    print(events.table(sort_by="self_device_time_total", row_limit=25))
    # Kernel events only: the aten ops above them report the same time again.
    device_ms = sum(
        e.self_device_time_total for e in events
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation
    ) / 1e3 / reps
    print(f"[profile] {wall_ms:.3f} ms/chunk on the host clock under the profiler, "
          f"{device_ms:.3f} ms/chunk of device time, idle share "
          f"{max(0.0, 1.0 - device_ms / wall_ms):.3f}")


def main() -> int:
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

    rows = kernel_phase(device, RAYS_PER_CHUNK * 884)
    render = render_phase(device)

    main_row = next(r for r in rows if r["fetch"] == "appearance" and r["dtype"] == "float32")
    kernels = [{
        "name": "bilinear_gather_2d",
        "route": "cuda",
        "source": "ngf_tpu_torch/ops/kernels/bilinear_gather.cu",
        "replaces": "ngf_tpu/ops/pallas_kernels.py:57",
        "launches": render["launches"]["bilinear_gather_2d"],
        "max_abs_err": max(r["max_abs_err"] for r in rows if r["dtype"] == "float32"),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "at": "appearance fetch: plane 256x256x96 float32, channels 24:96, N=3620864",
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
