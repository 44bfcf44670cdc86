"""The readings that a UV cell's limits are set from: on each seed, one run
of the cell at its own size (a short window: the readings need none) and
the numbers of the program against the reference; on the first
``--control_seeds`` seeds also those of the control (the reference in TF32
in the program's place) and of each planted fault
(``reference/uv_check.py``). One JSON line a side and seed on standard
output. The dataset is built once for all seeds (its sampler runs on).

    python3 gpubench/calibrate_uv.py --workload uv-dtu.train --seeds 1,2,3 --control_seeds 3

Not part of a benchmark run; `PERF.md` keeps the readings and the limits
set from them.
"""

import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    import argparse
    import json

    import torch

    from gpubench import spec as spec_mod
    from gpubench.reference import uv_check

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control_seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    a = p.parse_args()
    spec = spec_mod.load(a.workload)
    device = torch.device("cuda", 0)
    dataset = None
    for i, seed in enumerate(int(s) for s in a.seeds.split(",")):
        t = time.perf_counter()
        run = spec.driver.run(spec, seed, a.seconds, False, device, t, dataset)
        dataset = run["dataset"]
        t_run = time.perf_counter() - t
        extra = i < a.control_seeds
        sides = uv_check.sides(spec, run, control=extra, faults=uv_check.FAULTS if extra else ())
        t_ref = time.perf_counter() - t - t_run
        for name, side in sides.items():
            if name == "program":
                continue
            got = uv_check.compare(sides["program"] if name == "reference" else side,
                                   sides["reference"])
            print(json.dumps({"seed": seed, "side": "program" if name == "reference" else name,
                              **got}), flush=True)
        print(json.dumps({"seed": seed, "run_s": t_run, "sides_s": t_ref, "e2e": run["e2e"],
                          "notes": run["notes"]}), flush=True)
        del run, sides
        torch.cuda.empty_cache()
