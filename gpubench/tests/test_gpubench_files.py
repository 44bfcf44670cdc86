"""Every file of the benchmark loads and agrees with ``BENCHMARK.json``, every
name and unit keeps to the allowed characters, each configuration lists
every key it changed from its recipe, and a cell is added with new files
only."""

import dataclasses
import importlib
import json
import shutil

import pytest

from gpubench import spec as spec_mod
from ngf_tpu_torch.config import TrainArgs, parse_config_file
from ngf_tpu_torch.fields.triplane import TriPlaneConfig

ROOT = spec_mod.HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SOURCES = {"infoinv-lego": "configs/lego_infoinv.txt", "gauge-lego": "configs/lego_triplane.txt"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + CELLS
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(spec_mod.NAME.match(n) for n in names), names
    assert len(set(m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"])) == \
        len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec_mod.UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]] + \
            [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    sp = spec_mod.load(cell)
    assert sp.driver.run and sp.driver.check
    assert {m["name"] for m in sp.end_to_end} >= {"setup_s"}
    assert len(sp.end_to_end) >= 2 and sp.per_layer
    assert set(sp.workload["limits"]) and all(v >= 0 for v in sp.workload["limits"].values())


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_modules(metric):
    mod = importlib.import_module(f"gpubench.metrics.{metric['name'].replace('.', '_')}")
    assert mod.UNIT == metric["unit"] and mod.MOVES == metric["moves"]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for cell in metric["workloads"]:
        assert cell in e2e[metric["moves"]]["workloads"]


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_lists_what_it_changed(cfg):
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and sorted(data["reduced"]) == sorted(cfg["reduced"])
    source = parse_config_file(str(ROOT / SOURCES[cfg["name"]]))
    defaults = dataclasses.asdict(TrainArgs())
    changed = {k for k, v in data["args"].items() if source.get(k, defaults[k]) != v}
    assert changed <= set(cfg["reduced"]), changed - set(cfg["reduced"])
    preset = (TriPlaneConfig.gauge_preset() if data["args"]["subsystem"] == "triplane"
              else TriPlaneConfig.infoinv_preset())
    for key, value in data["widths"].items():
        if hasattr(preset, key):
            assert getattr(preset, key) == value, key


def test_a_cell_is_added_with_new_files_only(tmp_path):
    """A new cell of an existing configuration and traffic needs its entry in
    BENCHMARK.json and its own file under workloads/, nothing else."""
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench")
    bench = json.loads(json.dumps(BENCH))
    new = {"name": "infoinv-lego.train-copy", "config": "infoinv-lego", "traffic": "train",
           "chips": 1, "why": "a copy"}
    bench["workloads"].append(new)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "infoinv-lego.train" in m.get("workloads", []):
            m["workloads"].append(new["name"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    src = json.loads((ROOT / "gpubench/workloads/infoinv-lego.train.json").read_text())
    (tmp_path / "gpubench/workloads" / f"{new['name']}.json").write_text(json.dumps(dict(src, **new)))
    sp = spec_mod.load(new["name"], root=tmp_path)
    assert sp.traffic["driver"] == "train" and sp.config["name"] == "infoinv-lego"
    assert {m["name"] for m in sp.per_layer} == {m["name"] for m in spec_mod.load("infoinv-lego.train").per_layer}
    with pytest.raises(KeyError):
        spec_mod.load("no-such-cell", root=tmp_path)
