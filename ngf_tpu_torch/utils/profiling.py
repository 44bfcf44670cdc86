"""The port's tracing: spans and counters inside the program, and the
operator's trace (`ngf_tpu/utils/profiling.py`'s ``trace`` and
``annotate``, grown into one system).

Tracing is on while a ``torch.profiler`` records
(``torch.autograd._profiler_enabled()``), as it does inside
``trace(logdir)``; there is no other switch. Off, ``annotate`` returns one shared no-op context
manager after that one check, and ``count`` returns: no
``record_function``, no CUDA event, no kernel. A change from off to on
starts a fresh report (``trace`` starts one at its entry, and a
``report()`` taken while off ends the period it reads).

- ``annotate(name, id=None)``: a span. Entered while on, it opens a
  profiler range named ``name`` (``record_function``'s fast form: in the
  profiler's trace, on the device kernels' clock), records a timing CUDA
  event on the current stream at entry and at exit (where CUDA is in use;
  the host's ``perf_counter_ns`` always), and keeps a record: its name, its parent
  span, its id (the step or chunk it belongs to: ``id``, else its
  parent's, else a number of its own) and the times. A span decides at
  entry and keeps to that until its exit: entered off it records nothing,
  entered on it records even if tracing stops before it exits. Spans nest
  on the thread that opens them (the program opens them on one).
- ``enabled()``: whether tracing is on, for a caller that must compute a
  value only to count it.
- ``count(name, value)``: while on, adds a host int (on the host, no
  kernel) or a device tensor of counts (one kernel, into a float64 device
  accumulator of its shape, exact for any count under 2**53; no
  synchronise): a caller passes per-row sums, which cost one kernel where a
  whole tensor's sum costs a kernel and a memset.
- ``report()``: synchronises once and returns the period's spans by name
  (``count`` records, ``ids`` distinct steps or chunks, ``host_ms``,
  ``device_ms`` summed over their event pairs, None without CUDA events,
  and the names of their ``parents``), its ``counters``, and the
  ``launches`` of each hand-written kernel (``ops/cuda_kernels.KERNELS``)
  over the period.
- ``trace(logdir)``: ``torch.profiler`` of the host and, where there is
  one, the card, around the block; on exit the Chrome trace
  (``<host>_<pid>.<time>.pt.trace.json``, which TensorBoard's profile
  plugin reads) and the block's ``report()`` as ``ngf_spans.json`` are
  written into ``logdir``.
- ``capture()`` / ``replay(program)``: a block captured into CUDA graphs,
  one graph for each stretch between two span boundaries or counts (a
  graph with nothing in it is not replayed), and replayed in order inside
  the same spans, with the same counts at the same places. Inside the
  capture a span or a count only marks its place (tracing on or off); a
  replay with tracing on opens each span around its graphs, so that a
  replayed step has each span's device time, as an eager one has, and a
  replay with tracing off launches the graphs alone.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import json
import os
import time
import warnings

import torch
from torch.profiler import ProfilerActivity

_profiler_enabled = torch.autograd._profiler_enabled
# ``torch.profiler.record_function`` without its op dispatch: a span's range
# costs ~2 us with the profiler on where ``record_function``'s costs ~16 us
# (H100 host, PERF.md section 6).
_RANGE = torch._C._profiler._RecordFunctionFast


class _Noop:
    """The span of tracing that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


def _launch_counts() -> dict[str, int]:
    from ..ops import cuda_kernels

    return {name: fn.launches for name, fn in cuda_kernels.KERNELS.items()}


class _Period:
    """What one traced period holds: span records ``[name, parent record,
    id, host start ns, host end ns, start event, end event]``, the host
    and device counters, and the kernels' launch counts at its start."""

    def __init__(self):
        self.records: list[list] = []
        self.host: dict[str, int] = {}
        self.device: dict[tuple, torch.Tensor] = {}  # (name, shape) -> accumulator
        self.cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        self.streams: dict[int, torch.cuda.Stream] = {}
        self.launches = _launch_counts()
        self.ids = itertools.count()

    def stream(self) -> torch.cuda.Stream:
        """The current stream, by its handle (``torch.cuda.current_stream()``
        costs ~9 us a call)."""
        raw = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
        s = self.streams.get(raw)
        if s is None:
            s = self.streams[raw] = torch.cuda.current_stream()
        return s


class _Tracer:
    def __init__(self):
        self.on = False  # the last check's answer
        self.period: _Period | None = None
        self.open: list[list] = []  # records of the spans open now
        self.capture: _Capture | None = None  # the capture running now


_T = _Tracer()


def enabled() -> bool:
    """Whether tracing is on; a change from off to on starts a fresh period."""
    on = _profiler_enabled()
    if on != _T.on:
        _T.on = on
        if on:
            _T.period = _Period()
    return on


class _Span:
    __slots__ = ("name", "id", "rec", "rf", "stream")

    def __init__(self, name: str, id):
        self.name, self.id = name, id

    def __enter__(self):
        p = _T.period
        parent = _T.open[-1] if _T.open else None
        ident = self.id if self.id is not None else parent[2] if parent is not None else next(p.ids)
        self.rf = _RANGE(self.name)
        self.rf.__enter__()
        start = None
        if p.cuda:
            self.stream = p.stream()
            start = torch.cuda.Event(enable_timing=True)
            start.record(self.stream)
        self.rec = rec = [self.name, parent, ident, time.perf_counter_ns(), None, start, None]
        p.records.append(rec)
        _T.open.append(rec)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec[5] is not None:
            rec[6] = torch.cuda.Event(enable_timing=True)
            rec[6].record(self.stream)
        rec[4] = time.perf_counter_ns()
        _T.open.remove(rec)
        self.rf.__exit__(*exc)
        return False


def annotate(name: str, id=None):
    """A span named ``name`` as a context manager (the module's docstring);
    ``id`` names the step or chunk it belongs to."""
    if _T.capture is not None:
        return _Mark(_T.capture, name, id)
    if not enabled():
        return NOOP
    return _Span(name, id)


def count(name: str, value) -> None:
    """Add ``value`` (a host int, or a device tensor whose elements are
    counts) to the counter ``name`` while tracing is on."""
    if _T.capture is not None:
        _T.capture.mark(("count", name, value))
        return
    if not enabled():
        return
    p = _T.period
    if isinstance(value, torch.Tensor):
        key = (name, tuple(value.shape))
        acc = p.device.get(key)
        # Out of place, so that the caller's tensor is never written and an
        # inference-mode sum may be added outside inference mode.
        p.device[key] = value.to(torch.float64) if acc is None else acc + value
    else:
        p.host[name] = p.host.get(name, 0) + int(value)


def report() -> dict:
    """The period's spans, counters and kernel launches (the module's
    docstring); empty before any period. Taken while off, it ends the
    period: the next change to on starts a fresh one."""
    enabled()
    p = _T.period
    if p is None:
        return {"spans": {}, "counters": {}, "launches": {}}
    if p.cuda:
        torch.cuda.synchronize()
    spans: dict[str, dict] = {}
    for name, parent, ident, t0, t1, start, end in p.records:
        if t1 is None:  # still open
            continue
        s = spans.get(name)
        if s is None:
            s = spans[name] = {"count": 0, "ids": set(), "host_ms": 0.0,
                               "device_ms": 0.0 if p.cuda else None, "parents": set()}
        s["count"] += 1
        s["ids"].add(ident)
        s["host_ms"] += (t1 - t0) * 1e-6
        if end is not None:
            s["device_ms"] += start.elapsed_time(end)
        if parent is not None:
            s["parents"].add(parent[0])
    for s in spans.values():
        s["ids"] = len(s["ids"])
        s["parents"] = sorted(s["parents"])
    counters = dict(p.host)
    if p.device:
        values = torch.stack([acc.sum() for acc in p.device.values()]).tolist()
        for (name, _), v in zip(p.device, values):
            counters[name] = counters.get(name, 0) + round(v)
    launches = {k: v - p.launches.get(k, 0) for k, v in _launch_counts().items()}
    return {"spans": spans, "counters": counters, "launches": launches}


class _Capture:
    """The program of a capture: ``("graph", CUDAGraph)``, ``("enter", name,
    id)``, ``("exit",)`` and ``("count", name, value)`` in the order the
    block ran them, and ``("empty", CUDAGraph)`` for a stretch that
    captured nothing (kept, not replayed: a graph that goes releases its
    hold on the pool). Its graphs share one memory pool and are replayed in
    the order they were captured."""

    def __init__(self):
        self.program: list[tuple] = []
        self.pool = torch.cuda.graph_pool_handle()
        self.graph = None

    def begin(self) -> None:
        self.graph = torch.cuda.CUDAGraph()
        self.graph.capture_begin(pool=self.pool)

    def end(self) -> None:
        graph, self.graph = self.graph, None
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            graph.capture_end()
        empty = False
        for w in seen:
            if "Graph is empty" in str(w.message):
                empty = True
            else:
                warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
        self.program.append(("empty" if empty else "graph", graph))

    def mark(self, op: tuple) -> None:
        self.end()
        self.program.append(op)
        self.begin()


class _Mark:
    """A span inside a capture: its entry and exit end one graph and begin
    the next."""

    __slots__ = ("capture", "name", "id")

    def __init__(self, capture: _Capture, name: str, id):
        self.capture, self.name, self.id = capture, name, id

    def __enter__(self):
        self.capture.mark(("enter", self.name, self.id))
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.capture.mark(("exit",))
        return False


@contextlib.contextmanager
def capture():
    """Capture the block on a side stream into CUDA graphs split at its span
    boundaries (the module's docstring); yields the program that
    ``replay`` runs. The block's kernels do not run."""
    if _T.capture is not None:
        raise RuntimeError("a capture is running already")
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    cap = _Capture()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        cap.begin()
        _T.capture = cap
        try:
            yield cap.program
        finally:
            _T.capture = None
            cap.end()
    torch.cuda.current_stream().wait_stream(stream)


def replay(program: list[tuple]) -> None:
    """Run a captured program (``capture``) on the current stream: its
    graphs in order, inside its spans and with its counts while tracing is
    on."""
    if not enabled():
        for op in program:
            if op[0] == "graph":
                op[1].replay()
        return
    spans = []
    for op in program:
        kind = op[0]
        if kind == "graph":
            op[1].replay()
        elif kind == "enter":
            span = annotate(op[1], op[2])
            span.__enter__()
            spans.append(span)
        elif kind == "exit":
            spans.pop().__exit__(None, None, None)
        elif kind == "count":
            count(op[1], op[2])


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the block (the module's docstring); the Chrome trace and
    ``ngf_spans.json`` are written into ``logdir`` on exit. Yields the
    profiler."""
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)
    ) as prof:
        _T.on, _T.period = True, _Period()
        yield prof
    with open(os.path.join(logdir, "ngf_spans.json"), "w") as f:
        json.dump(report(), f, indent=1)
