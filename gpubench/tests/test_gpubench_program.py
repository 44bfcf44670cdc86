"""The readers of the program's own report (``metrics/program.py``): on a
hand-built report, without one (a program older than its spans), and on a
tiny traced run on the CPU, where the program's ``kept`` over the window
is the reference's own count of it and no span has device time."""

import time

import pytest
import torch

from gpubench import harness
from gpubench.metrics import program
from gpubench.tests.tiny import tiny_spec
from ngf_tpu_torch.utils import profiling


def _span(device_ms, count=10):
    return {"count": count, "ids": count, "host_ms": 1.0, "device_ms": device_ms, "parents": []}


def test_readers_on_a_hand_built_report(monkeypatch):
    rep = {"spans": {"ngf.field": _span(40.0), "ngf.batch": _span(2.0), "ngf.optimizer": _span(8.0),
                     "ngf.backward": _span(120.0)},
           "counters": {"rays": 100, "slots": 4000, "kept": 1000, "shaded": 250}, "launches": {}}
    monkeypatch.setattr(profiling, "report", lambda: rep)
    ctx = {"steps": 10, "counts": None}
    assert program.span_ms(ctx, "ngf.field") == pytest.approx(4.0)
    assert program.span_ms(ctx, "ngf.batch", "ngf.optimizer") == pytest.approx(1.0)
    assert program.span_ms(ctx, "ngf.missing") is None
    assert program.share(ctx, "kept", "slots") == pytest.approx(25.0)
    assert program.share(ctx, "shaded", "kept") == pytest.approx(25.0)
    assert program.share(ctx, "kept", "nothing") is None
    # Read once a run: the context keeps it.
    monkeypatch.setattr(profiling, "report", lambda: {"spans": {}, "counters": {}})
    assert program.share(ctx, "kept", "slots") == pytest.approx(25.0)
    # Chunks in a render; no device time on the CPU.
    rep["spans"]["ngf.field"] = _span(None)
    assert program.span_ms({"chunks": 4, "rays": 1}, "ngf.field") is None


def test_a_program_without_its_report_reads_nothing(monkeypatch):
    monkeypatch.delattr(profiling, "report")
    ctx = {"steps": 3}
    assert program.report(ctx) is None and program.share(ctx, "kept", "slots") is None
    monkeypatch.setattr(profiling, "report", lambda: {"spans": {}, "counters": {}}, raising=False)
    assert program.span_ms({"steps": 3}, "ngf.field") is None


@pytest.mark.parametrize("cell", ["gauge-lego.train", "infoinv-lego.render"])
def test_a_traced_runs_program_counts_are_the_references(cell):
    sp = tiny_spec(cell)
    run = sp.driver.run(sp, 3000000023, 0.5, True, torch.device("cpu"), time.perf_counter())
    assert harness.judge(sp.driver.check(sp, run))
    ctx = run["trace"]
    got = harness.per_layer(sp, ctx)
    rep = ctx["program"]
    k, ref = rep["counters"], ctx["counts"]
    assert k["kept"] == ref["valid"] and k["rays"] == ref["rays"]
    fill = got["fill_share." + cell.split(".")[1]]["value"]
    assert fill == pytest.approx(100 * k["kept"] / k["slots"])
    assert not any(m.startswith(("field_ms", "backward_ms", "trainer_ms")) for m in got)
    unit = "ngf.step" if cell.endswith(".train") else "ngf.render"
    assert rep["spans"][unit]["ids"] == (ctx["steps"] if cell.endswith(".train") else ctx["chunks"])
    if cell.endswith(".train"):
        assert 0 < k["shaded"] <= k["kept"] and "shade_share.train" in got
