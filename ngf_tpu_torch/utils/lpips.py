"""LPIPS v0.1 (alex / vgg) from a weights ``.npz``: port of
`ngf_tpu/utils/lpips.py`.

The reference writes LPIPS-alex and LPIPS-vgg into ``mean.txt``
(`InfoInv/utils.py:85-97`) through the pip ``lpips`` package, which fetches
pretrained backbones at first use. Here, as in the JAX package, the metric
resolves in this order:

- the pip ``lpips`` package, where it is installed;
- the LPIPS v0.1 forward below (the scaling layer, the backbone's taps, the
  per-channel unit normalisation, the squared difference, the calibrated
  1x1 heads, the spatial mean, the sum over taps) with the weights of
  ``lpips_{net}.npz`` in ``NGF_LPIPS_WEIGHTS_DIR`` or
  ``~/.cache/ngf_tpu`` (the JAX package's lookup: one file serves both;
  ``tools/export_lpips_weights.py`` writes it from the pip package's
  checkpoint);
- NaN, with a one-time ``lpips_unavailable`` warning.

The forward runs on the evaluation's device as ``F.conv2d`` and
``F.max_pool2d`` (library calls, as in the JAX package, which runs LPIPS
outside any Pallas kernel), with float32 sums: cuDNN's TF32, on by default
for convolutions, is off while it runs (``utils.precision``). Both images
go through the backbone as one batch of two; the five taps' values are read
from the device once and summed on the host in the JAX package's order.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from .device import resolve_device
from .precision import float32_accumulation

_SHIFT = np.array([-0.030, -0.088, -0.188], dtype=np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], dtype=np.float32)

# (out_ch, in_ch, kernel, stride, pad, maxpool_before) per conv of alexnet's
# features; a tap after every ReLU.
_ALEX = [
    (64, 3, 11, 4, 2, False),
    (192, 64, 5, 1, 2, True),
    (384, 192, 3, 1, 1, True),
    (256, 384, 3, 1, 1, False),
    (256, 256, 3, 1, 1, False),
]
_ALEX_TAPS = [0, 1, 2, 3, 4]

# vgg16's convs: (out_ch, maxpool_before), all 3x3, stride 1, pad 1; taps
# at relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3.
_VGG = [
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False),
    (512, True), (512, False), (512, False),
    (512, True), (512, False), (512, False),
]
_VGG_TAPS = [1, 3, 6, 9, 12]


def weights_path(net: str) -> str:
    """``lpips_{net}.npz`` in ``NGF_LPIPS_WEIGHTS_DIR``, else in ``~/.cache/ngf_tpu``."""
    base = os.environ.get("NGF_LPIPS_WEIGHTS_DIR", os.path.expanduser("~/.cache/ngf_tpu"))
    return os.path.join(base, f"lpips_{net}.npz")


def random_weights(net: str, rng: np.random.Generator) -> dict[str, np.ndarray]:
    """Random weights of the npz's layout (``conv{i}_w``, ``conv{i}_b``,
    ``lin{i}_w``), drawn from ``rng`` in the order `tests/test_lpips.py`'s
    generators draw them: a stand-in for the pretrained file, which is not
    in the repository, to exercise the metric."""
    if net == "alex":
        convs = [(co, ci, k) for co, ci, k, _, _, _ in _ALEX]
    else:
        chans = [c for c, _ in _VGG]
        convs = [(co, ci, 3) for co, ci in zip(chans, [3] + chans[:-1])]
    data = {}
    for i, (co, ci, k) in enumerate(convs):
        data[f"conv{i}_w"] = rng.normal(0, 0.05, (co, ci, k, k)).astype(np.float32)
        data[f"conv{i}_b"] = rng.normal(0, 0.05, (co,)).astype(np.float32)
    for i, tap in enumerate(_ALEX_TAPS if net == "alex" else _VGG_TAPS):
        c = convs[tap][0]
        data[f"lin{i}_w"] = np.abs(rng.normal(0, 0.1, (1, c, 1, 1))).astype(np.float32)
    return data


_warned: set[str] = set()
_models: dict[tuple, object] = {}


def _build(net: str, device: torch.device):
    """The LPIPS forward with the npz's weights on ``device``, or None when
    there is no file."""
    path = weights_path(net)
    if not os.path.isfile(path):
        return None
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    on = lambda a: torch.from_numpy(a).float().to(device)  # noqa: E731
    convs = []
    while f"conv{len(convs)}_w" in data:
        i = len(convs)
        convs.append((on(data[f"conv{i}_w"]), on(data[f"conv{i}_b"])))
    lins = []
    while f"lin{len(lins)}_w" in data:
        lins.append(on(data[f"lin{len(lins)}_w"]))
    if net == "alex":
        arch, taps, pool = _ALEX, _ALEX_TAPS, 3
    else:
        arch, taps, pool = [(c, 3, 3, 1, 1, p) for (c, p) in _VGG], _VGG_TAPS, 2
    assert len(convs) == len(arch), (len(convs), len(arch))
    assert len(lins) == len(taps)
    shift = on(_SHIFT).view(1, 3, 1, 1)
    scale = on(_SCALE).view(1, 3, 1, 1)

    @torch.no_grad()
    @float32_accumulation()
    def forward(a: np.ndarray, b: np.ndarray) -> float:
        """a, b: (H, W, 3) float images in [0, 1]."""
        x = torch.stack([torch.from_numpy(np.ascontiguousarray(img)).float() for img in (a, b)])
        x = x.to(device).permute(0, 3, 1, 2) * 2.0 - 1.0  # [-1, 1]
        x = (x - shift) / scale
        values = []
        for li, (_, _, _, stride, pad, pool_before) in enumerate(arch):
            if pool_before:
                x = F.max_pool2d(x, pool, 2)
            w, bias = convs[li]
            x = F.relu(F.conv2d(x, w, bias, stride=stride, padding=pad))
            if len(values) < len(taps) and taps[len(values)] == li:
                n = x / (x.square().sum(1, keepdim=True).sqrt() + 1e-10)
                d = (n[:1] - n[1:]).square()
                values.append(F.conv2d(d, lins[len(values)]).mean(dim=(2, 3)).reshape(()))
        total = 0.0
        for v in torch.stack(values).tolist():
            total = total + v
        return float(total)

    return forward


def lpips_available(net: str = "alex") -> bool:
    """Whether :func:`rgb_lpips` computes the metric (the pip package or the
    weights file is there)."""
    try:
        import lpips  # noqa: F401

        return True
    except ImportError:
        pass
    return os.path.isfile(weights_path(net))


def rgb_lpips(np_gt: np.ndarray, np_im: np.ndarray, net_name: str = "alex",
              device: torch.device | str = "cuda") -> float:
    """LPIPS distance of two (H, W, 3) images in [0, 1] on ``device``
    (`ngf_tpu/utils/lpips.py:150-186`, reference `InfoInv/utils.py:85-97`):
    the pip package, else the weights npz, else NaN with a one-time
    ``lpips_unavailable`` warning."""
    try:
        import lpips  # type: ignore

        dev = resolve_device(str(device))
        key = ("pip", net_name, str(dev))
        if key not in _models:
            _models[key] = lpips.LPIPS(net=net_name, version="0.1").eval().to(dev)
        gt = torch.from_numpy(np.ascontiguousarray(np_gt)).permute(2, 0, 1).float().to(dev)
        im = torch.from_numpy(np.ascontiguousarray(np_im)).permute(2, 0, 1).float().to(dev)
        with torch.no_grad(), float32_accumulation():
            return float(_models[key](gt, im, normalize=True).item())
    except ImportError:
        pass

    if os.path.isfile(weights_path(net_name)):
        dev = resolve_device(str(device))
        key = ("npz", net_name, weights_path(net_name), str(dev))
        if key not in _models:
            _models[key] = _build(net_name, dev)
        return _models[key](np_gt, np_im)

    if net_name not in _warned:
        _warned.add(net_name)
        warnings.warn(
            f"lpips_unavailable: no pip 'lpips' package and no weights at "
            f"{weights_path(net_name)} (see tools/export_lpips_weights.py). Recording NaN.",
            stacklevel=2,
        )
    return float("nan")
