"""Benchmark of the PyTorch/CUDA port (``ngf_tpu_torch``) on one NVIDIA
card: one run of one cell.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell is an entry of ``BENCHMARK.json``;
everything else is found by name under ``gpubench/`` (``spec.py``). The last
line of standard output is the run's JSON result; the numbers compared with
the plain reference, each beside its limit, are the last lines of standard
error. Exits non-zero, printing no result, without a CUDA card or with
fewer cards than the cell asks for, and when JAX or the JAX package was
loaded.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    # Every cache the program or PyTorch keeps, at fixed paths inside the
    # checkout (the port's nvcc builds already go to ngf_tpu_torch/_build/).
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(ROOT / ".gpubench_cache" / sub)
    # The script's own folder first on the path would shadow the standard library.
    sys.path[0] = str(ROOT)
    from gpubench.harness import main

    sys.exit(main(sys.argv[1:], T0))
