"""One run of a cell: set-up, the measured window, the comparison with the
plain reference, the per-layer readings of a traced run, and the result
line. The traffic's driver (``drivers/<driver>.py``) owns the set-up, the
window and the comparison; this module owns what every cell shares."""

from __future__ import annotations

import argparse
import json
import sys

FORBIDDEN = {"jax", "jaxlib", "flax", "ngf_tpu"}


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``ngf_tpu_torch`` is not ``ngf_tpu``)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def device_info(torch, count: int, peak: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak)}


def judge(numbers: dict) -> bool:
    """Every compared number at or under its limit (NaN fails)."""
    return all(v["value"] <= v["limit"] for v in numbers.values())


def limits_lines(numbers: dict) -> list[str]:
    return [f"{k} {v['value']!r} limit {v['limit']!r}" for k, v in numbers.items()]


def per_layer(spec, ctx: dict) -> dict:
    """The cell's per-layer metrics from a traced run's readings; a reader
    that finds nothing returns None and its metric is left out."""
    out = {}
    for m in spec.per_layer:
        value = spec.metric_module(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv, t0: float) -> int:
    args = parse(argv)
    from gpubench import spec as spec_mod

    spec = spec_mod.load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"gpubench: needs {spec.chips} CUDA card(s); torch.cuda.is_available() "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    run = spec.driver.run(spec, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t0)
    numbers = spec.driver.check(spec, run)
    correct = judge(numbers)
    if args.trace:
        metrics = per_layer(spec, run["trace"])
    else:
        metrics = {m["name"]: {"value": run["e2e"][m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end}
    bad = forbidden_modules()
    if bad:
        print(f"gpubench: loaded {bad}: the port must run without JAX or the JAX package",
              file=sys.stderr)
        return 3
    device = device_info(torch, spec.chips, run["peak_bytes"])
    result = {"correct": correct, "attempted": run["attempted"], "failed": run["failed"],
              "metrics": metrics, "device": device}
    if args.trace:
        tr = run["trace"]
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops_top"], "idle_gaps": tr["idle_gaps_top"]}
    # The kernels' load or nvcc build, inside setup_s (the contract's set-up
    # includes a run's compilation), given apart.
    result["build_s"] = run["build_s"]
    result["compared"] = {k: [v["value"], v["limit"]] for k, v in numbers.items()}
    for line in run.get("notes", []):
        print(f"gpubench: {line}", file=sys.stderr)
    for k, v in run.get("readings", {}).items():
        if k not in numbers:
            print(f"gpubench: not compared (no control or fault moves it): {k} {v!r}", file=sys.stderr)
    sys.stderr.write("\n".join(limits_lines(numbers)) + "\n")
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0

