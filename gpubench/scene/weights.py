"""The starting weights of a cell, made on the device from the seed in a
few large calls (one normal draw for the three planes, one uniform draw
for the decoder layers, one for the gauge's density layer), in float32,
the type they train in.

The tree and the distributions are the port's initialiser's
(`InfoInv/models/Field.py:14-37`, `TriPlane/models/Field.py:17-32`): planes
0.1 N(0, 1); the learned gauge's grids zero; ``nn.Linear``'s init (weights
and biases uniform in +-1/sqrt(fan_in)), the last bias of each MLP zero;
the gauge's density decoder one xavier-uniform layer with a zero bias. Both
the program and the reference start from these tensors.
"""

from __future__ import annotations

import math

import torch


def _mlp_dims(cfg: dict) -> dict:
    w = cfg["widths"]
    feat_rgb = 3 * (w["plane_dim"] - w["density_dim"])
    rgb_in = feat_rgb + 3 + 6 * w["view_pe"]
    out = {"basis": (feat_rgb, feat_rgb),
           "rgb": [rgb_in, w["rgb_mid"], w["rgb_mid"], 3]}
    if cfg["args"]["subsystem"] == "triplane":
        out["density"] = None
    else:
        out["density"] = [3 * w["density_dim"], w["density_mid"], w["density_mid"], 1]
    return out


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The parameter tree of ``cfg`` drawn from ``seed`` on ``device``."""
    w = cfg["widths"]
    res, dim = w["plane_res"], w["plane_dim"]
    gen = torch.Generator(device=device).manual_seed(seed)
    planes = 0.1 * torch.randn((3, res, res, dim), generator=gen, device=device)
    dims = _mlp_dims(cfg)

    layers = [(dims["basis"][0], dims["basis"][1], "nobias")]
    mlps = [("rgb", dims["rgb"])] + ([("density", dims["density"])] if dims["density"] else [])
    for _, ds in mlps:
        for i, (a, b) in enumerate(zip(ds[:-1], ds[1:])):
            layers.append((a, b, "zerobias" if i == len(ds) - 2 else "bias"))
    total = sum(a * b + (b if kind == "bias" else 0) for a, b, kind in layers)
    u = 2.0 * torch.rand((total,), generator=gen, device=device) - 1.0
    pos = 0

    def take(n, shape, bound):
        nonlocal pos
        t = (u[pos:pos + n] * bound).reshape(shape)
        pos += n
        return t

    def layer(a, b, kind):
        bound = 1.0 / math.sqrt(a)
        p = {"w": take(a * b, (a, b), bound)}
        if kind == "bias":
            p["b"] = take(b, (b,), bound)
        elif kind == "zerobias":
            p["b"] = torch.zeros((b,), device=device)
        return p

    it = iter(layers)
    basis = layer(*next(it))
    rgb = [layer(*next(it)) for _ in range(len(dims["rgb"]) - 1)]
    params = {"plane_xy": planes[0], "plane_yz": planes[1], "plane_xz": planes[2]}
    if dims["density"]:
        params["density_decoder"] = {"mlp": {"layers": [layer(*next(it)) for _ in range(3)]}}
    else:
        g = w["gauge_res"]
        for name in ("gauge_xy", "gauge_yz", "gauge_xz"):
            params[name] = torch.zeros((g, g, 2), device=device)
        fan_in = 3 * w["density_dim"]
        bound = math.sqrt(6.0 / (fan_in + 1))
        params["density_decoder"] = {
            "w": (2.0 * torch.rand((fan_in, 1), generator=gen, device=device) - 1.0) * bound,
            "b": torch.zeros((1,), device=device)}
    params["rgb_decoder"] = {"basis": basis, "mlp": {"layers": rgb}}
    return params
