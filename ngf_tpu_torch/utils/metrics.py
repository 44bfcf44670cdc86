"""Evaluation metrics: port of `ngf_tpu/utils/metrics.py` (reference
`InfoInv/utils.py:10,85-175`). SSIM is the mipnerf separable-Gaussian
formulation on the host with scipy. LPIPS needs pretrained backbones that
the port does not carry yet: it returns NaN, as the JAX package does when it
has no weights."""

from __future__ import annotations

import warnings

import numpy as np
import scipy.signal
import torch


def mse2psnr(mse: float) -> float:
    """PSNR from MSE (`InfoInv/utils.py:10`)."""
    return float(-10.0 * np.log(mse) / np.log(10.0))


def rgb_ssim(
    img0: np.ndarray,
    img1: np.ndarray,
    max_val: float,
    filter_size: int = 11,
    filter_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> float:
    """mipnerf SSIM (`ngf_tpu/utils/metrics.py:21-70`)."""
    img0 = np.asarray(img0, dtype=np.float64)
    img1 = np.asarray(img1, dtype=np.float64)
    if not (img0.ndim == 3 and img0.shape[-1] == 3 and img0.shape == img1.shape):
        raise ValueError(f"rgb_ssim wants two (H, W, 3) images, got {img0.shape}, {img1.shape}")

    hw = filter_size // 2
    shift = (2 * hw - filter_size + 1) / 2
    f_i = ((np.arange(filter_size) - hw + shift) / filter_sigma) ** 2
    filt = np.exp(-0.5 * f_i)
    filt /= np.sum(filt)

    def convolve2d(z, f):
        return scipy.signal.convolve2d(z, f, mode="valid")

    def filt_fn(z):
        return np.stack(
            [convolve2d(convolve2d(z[..., i], filt[:, None]), filt[None, :]) for i in range(z.shape[-1])],
            -1,
        )

    mu0 = filt_fn(img0)
    mu1 = filt_fn(img1)
    mu00 = mu0 * mu0
    mu11 = mu1 * mu1
    mu01 = mu0 * mu1
    sigma00 = np.maximum(0.0, filt_fn(img0 ** 2) - mu00)
    sigma11 = np.maximum(0.0, filt_fn(img1 ** 2) - mu11)
    sigma01 = filt_fn(img0 * img1) - mu01
    sigma01 = np.sign(sigma01) * np.minimum(np.sqrt(sigma00 * sigma11), np.abs(sigma01))
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
    denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    return float(np.mean(numer / denom))


_warned: set[str] = set()


def rgb_lpips(np_gt: np.ndarray, np_im: np.ndarray, net_name: str = "alex") -> float:
    """LPIPS distance: NaN with a one-time ``lpips_unavailable`` warning, as
    `ngf_tpu/utils/lpips.py:rgb_lpips` returns without weights."""
    del np_gt, np_im
    if net_name not in _warned:
        _warned.add(net_name)
        warnings.warn(
            f"lpips_unavailable: the port has no LPIPS-{net_name} weights yet "
            "(ROADMAP.md, items still missing). Recording NaN.",
            stacklevel=2,
        )
    return float("nan")


def tv_loss_2d(x: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """Total variation over an (H, W, C) plane (`ngf_tpu/utils/metrics.py:81-91`,
    `InfoInv/utils.py:159-175` in channels-last form)."""
    h, w, c = x.shape
    count_h = (h - 1) * w * c
    count_w = h * (w - 1) * c
    h_tv = ((x[1:] - x[:-1]) ** 2).sum()
    w_tv = ((x[:, 1:] - x[:, :-1]) ** 2).sum()
    return weight * 2.0 * (h_tv / count_h + w_tv / count_w)
