"""Operations of the tri-plane field that a batch of samples needs: the
fetch (7 flops an output value and ~30 a point of each plane, as
``counts.kernels``), the InfoInv modulation, the decoders' products (2
flops a multiply-add) and the composite. The density path runs at the
samples inside the box and the mask, the appearance path at the samples
the reference shades (blend weight over the threshold); padding and
capacity count nothing. Training counts the backward as twice the
forward."""

from __future__ import annotations


def _mlp(dims: list[int]) -> int:
    return sum(2 * a * b + b for a, b in zip(dims[:-1], dims[1:]))


def per_sample(cfg: dict) -> tuple[int, int]:
    """(density-path flops, appearance-path flops) of one sample, forward."""
    w, a = cfg["widths"], cfg["args"]
    cd, ca = w["density_dim"], w["plane_dim"] - w["density_dim"]
    fetch = lambda c: 3 * (7 * c + 30)  # noqa: E731
    gauge = a["subsystem"] == "triplane"
    infoinv = bool(a.get("infoinv", False))
    dens = fetch(cd) + (3 * cd + 4 * 3 * w["density_pe"] if infoinv else 0) + 10
    dens += _mlp([3 * cd, 1]) if gauge else _mlp([3 * cd, w["density_mid"], w["density_mid"], 1])
    if gauge:
        dens += fetch(2) + 12
    app = fetch(ca) + (3 * ca + 4 * 3 * w["rgb_pe"] if infoinv else 0)
    app += 2 * (3 * ca) ** 2 + _mlp([3 * ca + 3 + 6 * w["view_pe"], w["rgb_mid"], w["rgb_mid"], 3])
    app += 4 * 3 * w["view_pe"] + 3 + 8
    return dens, app


def flops(cfg: dict, valid: float, shaded: float, train: bool) -> float:
    dens, app = per_sample(cfg)
    fwd = valid * dens + shaded * app
    return 3 * fwd if train else fwd
