"""Readings that the per-layer metrics share, from a traced run's context:
``ops`` (device seconds and launches by kernel name inside the window),
``window_s``, ``busy_s``, ``launches``, ``window_peak``, the window's
``steps`` (train) or ``chunks`` and ``rays`` (render), the ``counts`` of
samples inside the box and the mask (``valid``) and shaded (``shaded``)
over every step or chunk of the window (``reference/check.py``), the
configuration and the planes' shapes. A reader returns None where its cell
has nothing to read."""

from __future__ import annotations

from gpubench.counts import field, kernels

K1 = "bilinear_gather_planes_kernel"
K2 = "bilinear_gather_2d_backward_kernel"
K2C = "bilinear_gather_planes_backward_coords_kernel"
GEMM = ("gemm", "gemv", "xmma", "cutlass")


def kernel_s(ctx: dict, pattern) -> float:
    pats = (pattern,) if isinstance(pattern, str) else pattern
    return sum(v["s"] for k, v in ctx["ops"].items() if any(p in k for p in pats))


def is_train(ctx: dict) -> bool:
    return "steps" in ctx


def units(ctx: dict) -> int:
    """Steps (train) or chunks (render) in the window."""
    return ctx["steps"] if is_train(ctx) else ctx["chunks"]


def samples_per_unit(ctx: dict) -> float | None:
    """Samples in the box and the mask a step or chunk, over the window."""
    c = ctx.get("counts")
    return c["valid"] / units(ctx) if c else None


def gauge(ctx: dict) -> bool:
    return ctx["config"]["args"]["subsystem"] == "triplane"


def k1_bound_s(ctx: dict) -> float | None:
    n = samples_per_unit(ctx)
    if n is None:
        return None
    w = ctx["config"]["widths"]
    b = kernels.k1(round(n), ctx["planes"], w["plane_dim"])
    if gauge(ctx):
        b += kernels.k1(round(n), [(w["gauge_res"], w["gauge_res"])] * 3, 2)
    return b * units(ctx)


def k2_bound_s(ctx: dict) -> float | None:
    n = samples_per_unit(ctx)
    if n is None:
        return None
    w = ctx["config"]["widths"]
    if gauge(ctx):
        g = w["gauge_res"]
        b = 3 * kernels.k2(round(n), g, g, 2)
    else:
        d = w["density_dim"]
        b = sum(kernels.k2(round(n), h, ww, d) + kernels.k2(round(n), h, ww, w["plane_dim"] - d)
                for h, ww in ctx["planes"])
    return b * units(ctx)


def k2c_bound_s(ctx: dict) -> float | None:
    n = samples_per_unit(ctx)
    if n is None or not gauge(ctx):
        return None
    return kernels.k2c(round(n), ctx["config"]["widths"]["plane_dim"], ctx["planes"]) * units(ctx)


def share(bound: float | None, seconds: float) -> float | None:
    """100 bound / seconds; None where the kernel did not run or nothing was
    counted."""
    if bound is None or seconds <= 0:
        return None
    return 100.0 * bound / seconds


def mfu(ctx: dict) -> float | None:
    c = ctx.get("counts")
    if not c:
        return None
    ops = field.flops(ctx["config"], c["valid"], c["shaded"], is_train(ctx))
    return 100.0 * ops / ctx["window_s"] / kernels.FP32_FLOP_PER_S


def idle(ctx: dict) -> float:
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])


def gemm_share(ctx: dict) -> float | None:
    total = sum(v["s"] for v in ctx["ops"].values())
    return 100.0 * kernel_s(ctx, GEMM) / total if total > 0 else None


def launches(ctx: dict) -> float:
    return ctx["launches"] / units(ctx)


def peak_gib(ctx: dict) -> float | None:
    return ctx["window_peak"] / 2 ** 30 if ctx["window_peak"] else None
