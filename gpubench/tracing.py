"""The traced window's readings from ``torch.profiler``: frozen from the
method of `chip_smoke.py`'s ``loop_profile`` and ``profile_chunk`` (the raw
kineto events inside a named span; kernels, copies and sets as the device's
work), extended with the union of the device's busy intervals, each
kernel's time by name and the idle gaps labelled by what the host was
doing. A profiler is used once, in a fresh process: a long-lived one has
been seen to drop kernel events."""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity

SPAN = "gpubench.window"


def start():
    prof = torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    span = torch.profiler.record_function(SPAN)
    span.__enter__()
    return prof, span


def stop(handle):
    prof, span = handle
    span.__exit__(None, None, None)
    prof.stop()
    return prof.profiler.kineto_results.events()


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def read(events) -> dict:
    """Readings of the window span: ``window_s``; ``busy_s``, the union of
    the device's kernels, copies and sets inside it; ``launches``, their
    count; ``ops``, seconds and count by device op name; the ten longest
    device ops and the ten largest idle-gap totals by the innermost host op
    running at each gap's middle."""
    from torch.autograd import DeviceType

    span = next(e for e in events if e.name() == SPAN and e.device_type() == DeviceType.CPU)
    t0, t1 = span.start_ns(), span.end_ns()
    dev, host = [], []
    for e in events:
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            if t0 <= e.start_ns() <= t1:
                dev.append(e)
        elif e.device_type() == DeviceType.CPU and e.name() != SPAN and e.end_ns() > t0 \
                and e.start_ns() < t1:
            host.append((e.start_ns(), e.end_ns(), e.name()))
    ops: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for e in dev:
        ops[e.name()][0] += e.duration_ns() * 1e-9
        ops[e.name()][1] += 1
    busy = _union([(e.start_ns(), e.start_ns() + e.duration_ns()) for e in dev])
    busy_ns = sum(min(b, t1) - a for a, b in busy)
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    host.sort()
    starts = [h[0] for h in host]
    labels: dict[str, float] = defaultdict(float)
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid)
        name = "host between ops"
        for j in range(i - 1, max(-1, i - 4000), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        labels[name] += (b - a) * 1e-9
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])
    return {
        "window_s": (t1 - t0) * 1e-9, "busy_s": busy_ns * 1e-9, "launches": len(dev),
        "ops": {k: {"s": v[0], "count": v[1]} for k, v in ops.items()},
        "device_ops_top": [[k, v[0]] for k, v in top[:10]],
        "idle_gaps_top": [[k, v] for k, v in sorted(labels.items(), key=lambda kv: -kv[1])[:10]],
        "events": len(events),
    }
