"""Chunked full-image evaluation: PSNR/SSIM/LPIPS and image dumps.

Port of `ngf_tpu/render/evaluation.py:23-198` (reference
`InfoInv/main.py:61-188`): each held-out view is rendered in ray chunks,
metered, and written as ``{idx:03d}.png`` plus an ``rgbd/`` composite;
``mean.txt`` holds [PSNR, SSIM, LPIPS-alex, LPIPS-vgg] (or [PSNR] without
the extra metrics). The port has no video encoder: it prints that it skips
the videos, as the JAX package does when ffmpeg is missing.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..data.dataset import RayDataset
from ..data.geometry import get_rays
from ..utils.image import visualize_depth, write_png
from ..utils.metrics import mse2psnr, rgb_lpips, rgb_ssim


def render_image(render_fn, rays: np.ndarray, chunk: int = 4096):
    """Render (N, 6) host rays in chunks -> (rgb (N, 3), depth (N,)) numpy.

    ``render_fn`` takes a (n, 6) CPU float32 tensor and returns (rgb, depth)
    tensors on any device. PyTorch runs eagerly, so the last chunk is not
    padded to the chunk size as the JAX package pads it for one compilation.
    """
    rgbs, depths = [], []
    for i in range(0, rays.shape[0], chunk):
        rgb, depth = render_fn(torch.from_numpy(np.ascontiguousarray(rays[i : i + chunk])))
        rgbs.append(rgb.float().cpu().numpy())
        depths.append(depth.float().cpu().numpy())
    return np.concatenate(rgbs), np.concatenate(depths)


def _write_view(save_path: str, name: str, rgb8: np.ndarray, depth_vis: np.ndarray) -> None:
    write_png(os.path.join(save_path, name), rgb8)
    write_png(os.path.join(save_path, "rgbd", name), np.concatenate([rgb8, depth_vis], axis=1))


def _skip_videos(tag: str) -> None:
    print(f"[{tag}] video write skipped: the port has no video encoder")


def evaluation(
    test_dataset: RayDataset,
    render_fn,
    save_path: str | None = None,
    n_vis: int = 5,
    chunk: int = 4096,
    compute_extra_metrics: bool = True,
    prtx: str = "",
) -> list[float]:
    """Render held-out views, meter them, dump images. Returns the PSNRs
    (`ngf_tpu/render/evaluation.py:62-144`)."""
    if save_path is not None:
        os.makedirs(os.path.join(save_path, "rgbd"), exist_ok=True)

    w, h = test_dataset.img_wh
    n_img = test_dataset.all_rays.shape[0]
    interval = 1 if n_vis < 0 else max(n_img // n_vis, 1)

    psnrs, ssims, l_alex, l_vgg = [], [], [], []
    for out_i, img_i in enumerate(range(0, n_img, interval)):
        rays = np.asarray(test_dataset.all_rays[img_i]).reshape(-1, 6)
        t0 = time.perf_counter()
        rgb, depth = render_image(render_fn, rays, chunk)
        secs = time.perf_counter() - t0
        n_chunks = -(-rays.shape[0] // chunk)
        print(
            f"[evaluation] view {out_i:03d}: {n_chunks} chunks of {chunk} rays in "
            f"{secs:.3f} s ({1e3 * secs / n_chunks:.2f} ms/chunk, "
            f"{rays.shape[0] / secs:.0f} rays/s)"
        )
        rgb = np.clip(rgb, 0.0, 1.0).reshape(h, w, 3)
        depth = depth.reshape(h, w)
        depth_vis, _ = visualize_depth(depth, test_dataset.near_far)

        if test_dataset.all_rgbs is not None and len(test_dataset.all_rgbs):
            gt = np.asarray(test_dataset.all_rgbs[img_i]).reshape(h, w, 3)
            psnrs.append(mse2psnr(float(np.mean((rgb - gt) ** 2))))
            if compute_extra_metrics:
                ssims.append(rgb_ssim(rgb, gt, 1))
                l_alex.append(rgb_lpips(gt, rgb, "alex"))
                l_vgg.append(rgb_lpips(gt, rgb, "vgg"))

        if save_path is not None:
            _write_view(save_path, f"{prtx}{out_i:03d}.png", (rgb * 255).astype(np.uint8), depth_vis)

    if save_path is not None and n_img:
        _skip_videos("evaluation")

    if psnrs and save_path is not None:
        if compute_extra_metrics:
            stats = [np.mean(psnrs), np.mean(ssims), np.mean(l_alex), np.mean(l_vgg)]
            if np.isnan(stats[2]) or np.isnan(stats[3]):
                with open(os.path.join(save_path, f"{prtx}lpips_unavailable.txt"), "w") as f:
                    f.write("LPIPS not computed: the port has no LPIPS weights yet. "
                            "mean.txt slots 3-4 are NaN.\n")
        else:
            stats = [np.mean(psnrs)]
        np.savetxt(os.path.join(save_path, f"{prtx}mean.txt"), np.asarray(stats))
    return psnrs


def evaluation_path(
    test_dataset: RayDataset,
    render_fn,
    c2ws: np.ndarray,
    save_path: str | None = None,
    chunk: int = 8192,
) -> None:
    """Render a novel camera path, no ground truth
    (`ngf_tpu/render/evaluation.py:147-198`). The port's datasets have no
    NDC projection, so the rays are cast as they are."""
    if save_path is not None:
        os.makedirs(os.path.join(save_path, "rgbd"), exist_ok=True)
    w, h = test_dataset.img_wh
    for idx, c2w in enumerate(c2ws):
        rays_o, rays_d = get_rays(test_dataset.directions, np.asarray(c2w, np.float32))
        rgb, depth = render_image(render_fn, np.concatenate([rays_o, rays_d], 1), chunk)
        rgb = np.clip(rgb, 0, 1).reshape(h, w, 3)
        depth_vis, _ = visualize_depth(depth.reshape(h, w), test_dataset.near_far)
        if save_path is not None:
            _write_view(save_path, f"{idx:03d}.png", (rgb * 255).astype(np.uint8), depth_vis)
    if save_path is not None and len(c2ws):
        _skip_videos("evaluation_path")
