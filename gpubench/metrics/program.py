"""Readings of the program's own report over the traced window: the spans
and counters of ``ngf_tpu_torch.utils.profiling``, which are on while the
window's profiler records and start afresh with it. ``report`` reads it
once a run, keeps it in the context and prints the counters beside the
reference's window counts on standard error. A program without that
report gives None: one older than its spans, which a comparison of two
commits runs under this same benchmark. So does a span without device time
(no CUDA events: a run on the CPU)."""

from __future__ import annotations

import sys

from gpubench.metrics import common as c


def report(ctx: dict) -> dict | None:
    if "program" not in ctx:
        from ngf_tpu_torch.utils import profiling

        read = getattr(profiling, "report", None)
        rep = read() if read is not None else None
        ctx["program"] = rep if rep and rep.get("spans") else None
        if ctx["program"] is not None:
            _print(ctx)
    return ctx["program"]


def _print(ctx: dict) -> None:
    rep, n = ctx["program"], c.units(ctx)
    unit = "step" if c.is_train(ctx) else "chunk"
    ms = {k: v["device_ms"] / n for k, v in rep["spans"].items() if v["device_ms"] is not None}
    print(f"gpubench: program counters {rep['counters']}; reference window counts "
          f"{ctx.get('counts')}", file=sys.stderr)
    print(f"gpubench: program spans, device ms a {unit} over {n}: "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()), file=sys.stderr)


def span_ms(ctx: dict, *names: str) -> float | None:
    """The device ms of the spans ``names`` together, a step or chunk."""
    rep = report(ctx)
    if rep is None:
        return None
    total = 0.0
    for name in names:
        s = rep["spans"].get(name)
        if s is None or s["device_ms"] is None:
            return None
        total += s["device_ms"]
    return total / c.units(ctx)


def share(ctx: dict, part: str, whole: str) -> float | None:
    """100 times the counter ``part`` over the counter ``whole``."""
    rep = report(ctx)
    if rep is None:
        return None
    k = rep["counters"]
    if part not in k or not k.get(whole):
        return None
    return 100.0 * k[part] / k[whole]
