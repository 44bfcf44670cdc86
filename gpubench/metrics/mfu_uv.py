"""``mfu.uv``: the four networks' product operations in the window (the program's slots and template counters, gpubench/counts/neutex.py; the backward twice the forward) over the window's time and 67 TFLOP/s."""

from gpubench.counts import kernels, neutex
from gpubench.metrics import program as p

UNIT = "%"
MOVES = "train_rays_per_s"


def read(ctx: dict):
    rep = p.report(ctx)
    if rep is None:
        return None
    k = rep["counters"]
    if not k.get("slots") or "template" not in k:
        return None
    ops = neutex.flops(ctx["config"], k["slots"], k["template"], train=True)
    return 100.0 * ops / ctx["window_s"] / kernels.FP32_FLOP_PER_S
