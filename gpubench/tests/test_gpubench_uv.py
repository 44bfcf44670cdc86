"""The UV cell's files and code on the CPU: ``uv-dtu.train`` loads by name
with its configuration, traffic, driver and metrics; its configuration keeps
the published widths and lists what it changed from `dtu_train.sh`; the
operation count equals ``FlopCounterMode``'s count of the reference's
products; the readers return None without a program report and a value with
one, and the training cells' trace readers read its window; the cell's ``run``
and ``check`` at a tiny size come out correct, and the
control and each planted fault do not."""

import importlib
import json
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench import harness, spec as spec_mod
from gpubench.counts import neutex as counts
from gpubench.reference import check, uv_check
from gpubench.reference import neutex as N
from gpubench.reference.model import flatten
from ngf_tpu_torch.fields.neutex import NeuTexConfig, init_neutex

CELL = "uv-dtu.train"
ROOT = spec_mod.HERE.parent
# The cell's per-layer metrics in BENCHMARK.json's order: the training
# cells' readers of the device trace and of the spans, then its own.
TRACE_METRICS = ["launches_per_step.train", "gemm_share.train", "idle_share.train",
                 "peak_mem_gib.train"]
SPAN_METRICS = ["field_ms.train", "backward_ms.train", "mfu.uv", "gauge_ms.uv", "trainer_ms.uv"]
METRICS = TRACE_METRICS + SPAN_METRICS
# `UV-Mapping/dtu_train.sh`'s flags for scan 83 as `uv_train_torch.py` takes
# them (MIGRATION.md); the other flags keep the CLI's defaults, the
# reference's.
RECIPE = {"name": "scan83", "data_root": "./data/DTU/scan83", "dataset_name": "dtu",
          "random_sample": "balanced", "random_sample_size": 24, "sample_num": 64,
          "primitive_type": "square", "points_per_primitive": 2500, "lr": 1e-4, "niter": 500000}


def tiny_uv_spec():
    sp = spec_mod.load(CELL)
    c = sp.config
    c["scene"] = {"views": 3, "wh": [20, 16]}
    c["args"].update(random_sample_size=4, sample_num=8, points_per_primitive=16, steps_per_call=3,
                     print_freq=5)
    c["widths"].update(geo_hidden=16, geo_layers=2, tex_width=16, tex_layers1=2, tex_layers2=1,
                       gauge_mid=8, gauge_hidden=12, gauge_layers=1, inverse_mid=8,
                       inverse_hidden=24, inverse_layers=1)
    sp.traffic = dict(sp.traffic, warm_steps=4)
    return sp


def test_the_cell_loads_by_name():
    sp = spec_mod.load(CELL)
    assert sp.chips == 1 and sp.config["name"] == "uv-dtu" and sp.traffic["driver"] == "uv_train"
    assert sp.driver.run and sp.driver.check
    assert {m["name"] for m in sp.end_to_end} == {"train_rays_per_s", "train_step_p95_ms", "setup_s"}
    assert [m["name"] for m in sp.per_layer] == METRICS
    for m in sp.per_layer:
        mod = sp.metric_module(m["name"])
        assert mod.UNIT == m["unit"] and mod.MOVES == m["moves"]
    assert set(sp.workload["limits"]) == {f"{p}_{k}_gap" for p in ("open", "window")
                                          for k in ("loss", "grad", "change")}
    assert set(sp.workload["reasons"]) == set(sp.workload["limits"])


def test_the_configuration_keeps_the_published_widths():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "uv-dtu")
    data = json.loads((ROOT / entry["file"]).read_text())
    assert sorted(data["reduced"]) == sorted(entry["reduced"])
    published = NeuTexConfig()
    for key, value in data["widths"].items():
        assert getattr(published, key) == value, key
    assert data["args"]["jitter"] == published.jitter
    import uv_train_torch

    defaults = vars(uv_train_torch.parse_args(["--sample_num", "1", "--primitive_type", "square",
                                               "--points_per_primitive", "1"]))
    recipe = dict(defaults, **RECIPE)
    changed = {k for k, v in data["args"].items() if k in recipe and recipe[k] != v}
    assert changed <= set(entry["reduced"]) | set(data["assumed"]), changed
    assert not set(data["args"]) - set(recipe) - {"jitter"}


def test_the_count_is_the_reference_products():
    sp = tiny_uv_spec()
    cfg = N.UVCfg.from_config(sp.config)
    g = torch.Generator().manual_seed(0)
    params = flatten(init_neutex(NeuTexConfig(primitive_type="square", **sp.config["widths"]), g))
    R, S, P = 5, cfg.sample_num, 7
    raydir = torch.randn(R, 3, generator=g) + torch.tensor([0, 0, 1.0])
    raydir = raydir / raydir.norm(dim=-1, keepdim=True)
    with FlopCounterMode(display=False) as fc:
        N.forward(params, cfg, torch.tensor([0.1, 0.2, -2.5]), raydir, torch.zeros(3),
                  torch.rand(R, S, generator=g), torch.rand(P, 2, generator=g) * 2 - 1)
    assert fc.get_total_flops() == counts.flops(sp.config, R * S, P, train=False)
    assert counts.flops(sp.config, R * S, P, train=True) == 3 * fc.get_total_flops()
    m = counts.macs(spec_mod.load(CELL).config)
    assert m == {"geometry": 671744, "gauge": 45248, "texture": 612096, "inverse": 558720}


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_the_readers_need_a_report(metric, monkeypatch):
    from ngf_tpu_torch.utils import profiling

    mod = importlib.import_module(f"gpubench.metrics.{metric.replace('.', '_')}")
    ctx = {"steps": 10, "window_s": 2.0, "config": spec_mod.load(CELL).config}
    monkeypatch.setattr(profiling, "report", lambda: {"spans": {}, "counters": {}, "launches": {}})
    assert mod.read(dict(ctx)) is None
    names = ("ngf.field", "ngf.uv.gauge", "ngf.uv.inverse", "ngf.backward", "ngf.batch",
             "ngf.optimizer", "ngf.log")
    rep = {"spans": {n: {"device_ms": 30.0} for n in names},
           "counters": {"rays": 5760, "slots": 368640, "template": 25000}, "launches": {}}
    monkeypatch.setattr(profiling, "report", lambda: rep)
    value = mod.read(dict(ctx))
    assert value is not None and value > 0
    if metric == "mfu.uv":
        ops = 3 * 2 * (368640 * (671744 + 45248 + 612096 + 558720) + 25000 * 558720)
        assert value == pytest.approx(100 * ops / 2.0 / 67e12)
    elif metric == "gauge_ms.uv":
        assert value == pytest.approx(6.0)
    elif metric == "trainer_ms.uv":
        assert value == pytest.approx(9.0)
    else:
        assert value == pytest.approx(3.0)


@pytest.mark.parametrize("metric", TRACE_METRICS)
def test_the_training_readers_read_a_uv_window(metric):
    """The UV driver's traced window holds what the training cells' device
    trace readers read."""
    mod = importlib.import_module(f"gpubench.metrics.{metric.replace('.', '_')}")
    ctx = {"steps": 10, "window_s": 2.0, "busy_s": 1.5, "launches": 4000, "window_peak": 2 ** 31,
           "ops": {"ampere_sgemm_128x64_nn": {"s": 0.9, "count": 2000},
                   "ray_march_neutex_forward_kernel": {"s": 0.1, "count": 10}},
           "config": spec_mod.load(CELL).config}
    want = {"launches_per_step.train": 400.0, "gemm_share.train": 90.0, "idle_share.train": 25.0,
            "peak_mem_gib.train": 2.0}
    assert mod.read(ctx) == pytest.approx(want[metric])


def test_a_tiny_run_is_correct_and_the_control_and_faults_are_not():
    sp = tiny_uv_spec()
    sp.workload["limits"] = {k: 1e-4 for k in sp.workload["limits"]}
    run = sp.driver.run(sp, 3000000019, 0.3, False, torch.device("cpu"), time.perf_counter())
    assert run["attempted"] >= 3 and run["failed"] == 0
    assert set(run["items"]) == {0, 1, 2, 4, 5, 6}
    numbers = sp.driver.check(sp, run)
    assert harness.judge(numbers), numbers
    sides = uv_check.sides(sp, run, control=True, faults=uv_check.FAULTS)
    for name in ("control",) + uv_check.FAULTS:
        got = check.numbers(uv_check.compare(sides[name], sides["reference"]),
                            sp.workload["limits"])
        assert not harness.judge(got), (name, got)


def test_a_tree_without_run_fails_at_once(monkeypatch):
    from ngf_tpu_torch.train import uv_loop

    monkeypatch.delattr(uv_loop.UVTrainer, "run")
    sp = tiny_uv_spec()
    with pytest.raises(SystemExit, match="no run"):
        sp.driver.run(sp, 1, 0.1, False, torch.device("cpu"), time.perf_counter())
