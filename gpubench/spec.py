"""What a run of a cell needs, found by name: the cell's entry of
``BENCHMARK.json`` and its file ``workloads/<cell>.json``, the configuration
``configs/<config>.json``, the traffic mix ``traffic/<traffic>.json`` and
the driver it names (``drivers/<driver>.py``), and the metrics the cell
reports (``metrics/<metric>.py`` for each per-layer metric). Adding a cell,
a configuration, a traffic mix of an existing driver or a per-layer metric
adds files and entries; no file here changes."""

from __future__ import annotations

import dataclasses
import importlib
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass
class Spec:
    cell: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def driver(self):
        return importlib.import_module(f"gpubench.drivers.{self.traffic['driver']}")

    def metric_module(self, name: str):
        return importlib.import_module(f"gpubench.metrics.{name.replace('.', '_')}")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_names: set[str] | None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads`` key
    lists; without one, every cell (an end-to-end metric) or every cell
    that reports the end-to-end metric it moves (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load(cell: str, root: Path = HERE.parent) -> Spec:
    """The spec of ``cell`` from the files under ``root``; raises KeyError for
    a cell that ``BENCHMARK.json`` does not list."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    base = root / "gpubench"
    workload = load_json(base / "workloads" / f"{cell}.json")
    for key in ("config", "traffic", "chips"):
        if workload[key] != entry[key]:
            raise ValueError(f"{cell}: {key} {workload[key]!r} in its file, {entry[key]!r} in BENCHMARK.json")
    config = load_json(base / "configs" / f"{entry['config']}.json")
    traffic = load_json(base / "traffic" / f"{entry['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, cell, None)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, cell, names)]
    return Spec(cell, entry["chips"], config, traffic, workload, e2e, per_layer)
