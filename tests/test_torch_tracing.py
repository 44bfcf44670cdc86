"""The port's tracing (`ngf_tpu_torch/utils/profiling.py`) on the CPU, at the
benchmark's tiny shapes (`gpubench/tests/tiny.py`):

- off, ``annotate`` is the shared no-op and three trainer steps make no
  ``record_function`` call, no CUDA event and no count, and leave the
  report empty;
- under ``trace``, each step's spans once a step (the optimizer's two
  regions under one name), ``ngf.field`` under ``ngf.render`` under
  ``ngf.forward`` under ``ngf.step``, in ``ngf_spans.json`` and the Chrome
  trace;
- tracing changes nothing: parameters, Adam state and the kernels' launch
  counts after three steps are bit for bit those of an untraced run, on
  the grouped and the dense path;
- one training ``render_rays`` call's counters against the benchmark
  reference's independent count (``gpubench/reference/model.count_samples``)
  on the same rays and jitter, its ``slots`` the packed rows of its kept
  groups;
- the on/off rule at a span's entry and exit, and a fresh report each
  traced period;
- inside a capture, spans and counts mark the captured program (with
  stand-in graphs: a capture needs a card), and a replay runs its graphs
  in order, alone while off and inside the spans, with the counts, while
  on.
"""

import json
import os

import pytest
import torch

from gpubench.drivers import common
from gpubench.reference import check, model as M
from gpubench.scene import synthetic
from gpubench.scene.weights import make_weights
from gpubench.tests.tiny import tiny_spec
from ngf_tpu_torch.config import TrainArgs
from ngf_tpu_torch.convert import named_leaves
from ngf_tpu_torch.data import load_dataset
from ngf_tpu_torch.ops import cuda_kernels
from ngf_tpu_torch.ops.compaction import group_sample_compact
from ngf_tpu_torch.render import volume
from ngf_tpu_torch.render.volume import RenderConfig, render_rays
from ngf_tpu_torch.train.loop import TriPlaneTrainer, model_config_from_args
from ngf_tpu_torch.utils import profiling

DATADIR = "synthetic:views=2,wh=16,test_views=1"
STEP_SPANS = ("ngf.step", "ngf.batch", "ngf.forward", "ngf.backward", "ngf.optimizer", "ngf.log")


def _trainer(logfolder, group_size=8, n_iters=3):
    args = TrainArgs(dataset_name="synthetic", datadir=DATADIR, subsystem="infoinv", infoinv=True,
                     plane_res=32, gauge_res=32, nSamples=48, step_ratio=1.0, batch_size=96,
                     n_iters=n_iters, group_size=group_size, open_sample_cap=32, device="cpu",
                     progress_refresh_rate=1, N_vis=0, seed=5)
    ds = load_dataset("synthetic", DATADIR, split="train", is_stack=False)
    return TriPlaneTrainer(args, ds, logfolder=str(logfolder), device="cpu")


def _fresh_empty_report(tmp_path):
    """Start and end a traced period with nothing in it, so that the report
    this process holds is empty whatever ran before."""
    with profiling.trace(str(tmp_path / "empty")):
        pass
    rep = profiling.report()
    assert rep["spans"] == {} and rep["counters"] == {}


def test_off_makes_no_span_event_or_count(tmp_path, monkeypatch):
    _fresh_empty_report(tmp_path)
    assert profiling.annotate("ngf.step", 1) is profiling.NOOP
    assert profiling.annotate("x") is profiling.NOOP and not profiling.enabled()
    calls = []

    def refuse(*a, **kw):
        calls.append(a)
        raise AssertionError("called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_RANGE", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(volume, "count", refuse)
    trainer = _trainer(tmp_path / "log")
    trainer.run()
    assert trainer.iteration == 3 and not calls
    rep = profiling.report()
    assert rep["spans"] == {} and rep["counters"] == {}


def test_trace_holds_the_steps_spans(tmp_path, monkeypatch):
    trainer = _trainer(tmp_path / "log")
    packed = []
    pack_map = volume._pack_map

    def spy(got):
        ids = pack_map(got)
        packed.append((ids.shape[0], int(got.sum()), got.numel()))
        return ids

    monkeypatch.setattr(volume, "_pack_map", spy)
    with profiling.trace(str(tmp_path / "tb")):
        trainer.run()
    rep = profiling.report()
    spans = rep["spans"]
    for name in STEP_SPANS:
        assert spans[name]["ids"] == 3, name
        # zero_grad and the update are the optimizer's two regions of a step.
        assert spans[name]["count"] == (6 if name == "ngf.optimizer" else 3), name
        assert spans[name]["device_ms"] is None and spans[name]["host_ms"] > 0
    for name in ("ngf.render", "ngf.render.frontend", "ngf.field", "ngf.render.composite"):
        assert spans[name]["count"] == 3, name
    assert spans["ngf.field"]["parents"] == ["ngf.render"]
    assert spans["ngf.render"]["parents"] == ["ngf.forward"]
    assert spans["ngf.forward"]["parents"] == ["ngf.step"]
    assert spans["ngf.step"]["parents"] == ["train_loop"]
    c = rep["counters"]
    rc = trainer._render_cfg()
    capg = -(-(rc.sample_cap or rc.n_samples) // 8)
    # Training decodes the packed rows: each step's kept groups.
    assert len(packed) == 3 and all(g == 96 * capg for _, _, g in packed)
    assert all(r == k > 0 for r, k, _ in packed)
    assert c["rays"] == 3 * 96 and c["slots"] == 8 * sum(r for r, _, _ in packed)
    assert 0 < c["shaded"] <= c["kept"] <= c["slots"] <= 3 * 96 * capg * 8
    files = os.listdir(tmp_path / "tb")
    chrome = [f for f in files if f.endswith(".pt.trace.json")]
    assert len(files) == 2 and "ngf_spans.json" in files and len(chrome) == 1
    with open(tmp_path / "tb" / "ngf_spans.json") as f:
        assert json.load(f) == json.loads(json.dumps(rep))
    with open(tmp_path / "tb" / chrome[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert set(STEP_SPANS) | {"ngf.field", "ngf.render.composite"} <= names


@pytest.mark.parametrize("group_size", [8, 0])
def test_tracing_changes_no_state(tmp_path, group_size):
    states = []
    for traced in (False, True):
        trainer = _trainer(tmp_path / f"log{traced}", group_size)
        cuda_kernels.reset_launch_counts()
        if traced:
            with profiling.trace(str(tmp_path / "tb")):
                trainer.run()
        else:
            trainer.run()
        adam = trainer.optimizer.adam.state
        states.append({
            "params": {n: p.detach().clone() for n, p in named_leaves(trainer.params)},
            "adam": {n: {k: v.clone() if torch.is_tensor(v) else v for k, v in adam[p].items()}
                     for n, p in named_leaves(trainer.params)},
            "launches": {k: fn.launches for k, fn in cuda_kernels.KERNELS.items()},
            "rgb_stat": trainer.rgb_stat.clone(),
        })
    off, on = states
    assert off["params"].keys() == on["params"].keys()
    for n in off["params"]:
        assert torch.equal(off["params"][n], on["params"][n]), n
        for k, v in off["adam"][n].items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(on["adam"][n][k])), (n, k)
    assert off["launches"] == on["launches"] and torch.equal(off["rgb_stat"], on["rgb_stat"])


@pytest.mark.parametrize("cell", ["infoinv-lego.train", "gauge-lego.train"])
def test_counters_match_the_reference_count(tmp_path, cell):
    cfg = tiny_spec(cell).config
    model_cfg = model_config_from_args(common.train_args(cfg, 3, torch.device("cpu")))
    flat = M.flatten(make_weights(cfg, 11, torch.device("cpu")))
    flat.update({k: v * 3.0 for k, v in flat.items() if k.startswith("plane_")})
    tree = check.unflatten(flat)
    rays = synthetic.split_rays("train", 1, (16, 16), "cpu")
    n = rays.shape[0]
    rc = M.RenderCfg(aabb=((-1.5,) * 3, (1.5,) * 3), near=2.0, far=6.0, n_samples=48,
                     step_size=0.05, group=8, capg=4, distance_scale=25.0, thres=1e-4)
    rcfg = RenderConfig(aabb=rc.aabb, near=2.0, far=6.0, n_samples=48, step_size=0.05,
                        distance_scale=25.0, ray_march_weight_thres=1e-4, white_bg=True,
                        sample_cap=32, group_size=8)
    torch.manual_seed(0)
    vol = (torch.rand(16, 16, 16) > 0.5).float()
    vol_aabb = torch.tensor([[-1.5] * 3, [1.5] * 3])
    gen = torch.Generator().manual_seed(2 ** 31 + 9)
    jitter = torch.rand((n, 1), generator=torch.Generator().manual_seed(2 ** 31 + 9))
    with profiling.trace(str(tmp_path / "tb")):
        render_rays(tree, model_cfg, rcfg, rays, iteration=5, alpha_volume=vol,
                    alpha_aabb=vol_aabb, generator=gen)
    c = profiling.report()["counters"]
    kept, shaded = (int(x) for x in M.count_samples(tree, M.FieldCfg.from_config(cfg), rc, rays, 5,
                                                     vol, vol_aabb, jitter))
    # The packed rows: the kept groups of the port's front end on the same
    # jitter.
    _, got, *_ = group_sample_compact(rays, jitter, rcfg.aabb_tensor("cpu"), 2.0, 6.0, 48, 0.05,
                                      8, rc.capg, vol.to(torch.uint8), vol_aabb, indices=True)
    groups = int(got.sum())
    assert 0 < groups <= n * rc.capg
    assert c["rays"] == n and c["slots"] == groups * rc.group
    assert c["kept"] == kept > 0
    assert shaded > 0 and abs(c["shaded"] - shaded) <= 0.005 * shaded


def test_on_off_at_entry_and_a_fresh_report_each_period(tmp_path):
    _fresh_empty_report(tmp_path)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    # Entered off, left on: nothing.
    span = profiling.annotate("entered_off")
    span.__enter__()
    prof.start()
    with profiling.annotate("inner"):
        profiling.count("n", 2)
        profiling.count("n", torch.tensor(3.0))
    span.__exit__(None, None, None)
    # Entered on, left off: recorded.
    late = profiling.annotate("entered_on")
    late.__enter__()
    prof.stop()
    late.__exit__(None, None, None)
    profiling.count("n", 100)  # off: not counted
    rep = profiling.report()
    assert set(rep["spans"]) == {"inner", "entered_on"} and rep["counters"] == {"n": 5}
    assert profiling.annotate("x") is profiling.NOOP
    # The next traced period starts a fresh report.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.annotate("second"):
            pass
    rep = profiling.report()
    assert set(rep["spans"]) == {"second"} and rep["counters"] == {}


def test_a_capture_splits_at_spans_and_a_replay_reopens_them(tmp_path, monkeypatch):
    _fresh_empty_report(tmp_path)
    ran = []

    class Graph:
        def __init__(self):
            self.work = []

        def replay(self):
            ran.extend(self.work)

    class Capture(profiling._Capture):
        """`_Capture`'s program on stand-in graphs."""

        def __init__(self):
            self.program, self.graph = [], None

        def begin(self):
            self.graph = Graph()

        def end(self):
            graph, self.graph = self.graph, None
            self.program.append(("graph" if graph.work else "empty", graph))

    cap = Capture()
    cap.begin()
    monkeypatch.setattr(profiling._T, "capture", cap)
    cap.graph.work.append("a")
    with profiling.annotate("outer", 7):
        profiling.count("n", 3)
        cap.graph.work.append("b")
        with profiling.annotate("inner"):
            cap.graph.work.append("c")
    cap.graph.work.append("d")
    monkeypatch.setattr(profiling._T, "capture", None)
    cap.end()
    assert [op[0] for op in cap.program] == [
        "graph", "enter", "empty", "count", "graph", "enter", "graph", "exit", "empty", "exit",
        "graph"]
    rep = profiling.report()
    assert rep["spans"] == {} and rep["counters"] == {}
    profiling.replay(cap.program)  # off: the graphs alone
    assert ran == list("abcd")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.replay(cap.program)
        profiling.replay(cap.program)
    rep = profiling.report()
    assert ran == list("abcd") * 3
    assert rep["counters"] == {"n": 6}
    assert {k: (v["count"], v["ids"], v["parents"]) for k, v in rep["spans"].items()} == {
        "outer": (2, 1, []), "inner": (2, 1, ["outer"])}
