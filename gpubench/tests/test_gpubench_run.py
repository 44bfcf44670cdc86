"""A run without a card fails and prints no result; nothing a run imports is
JAX or the JAX package (compared by whole top-level name); the reference
imports nothing of the port; a cell runs on the card (``gpu``)."""

import json
import os
import subprocess
import sys

import pytest
import torch

from gpubench import harness, spec as spec_mod

ROOT = spec_mod.HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ngf_tpu")


def _python(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "infoinv-lego.train",
                        "--seed", "2147483648", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


@pytest.mark.parametrize("module", ["gpubench.harness", "gpubench.drivers.train",
                                    "gpubench.drivers.render", "gpubench.calibrate"])
def test_a_run_imports_no_jax(module):
    code = (f"import sys, json; sys.path.insert(0, '.'); import {module}; "
            "import gpubench.spec as s; [s.load(w).driver for w in ('infoinv-lego.train', "
            "'infoinv-lego.render')]; print(json.dumps(sorted(sys.modules)))")
    p = _python(code)
    assert p.returncode == 0, p.stderr
    tops = {m.split(".")[0] for m in json.loads(p.stdout.strip().splitlines()[-1])}
    assert "ngf_tpu_torch" in tops or module == "gpubench.harness"
    assert not tops & set(FORBIDDEN)


def test_the_reference_imports_nothing_of_the_port():
    p = _python("import sys, json; sys.path.insert(0, '.'); import gpubench.reference.check, "
                "gpubench.scene.synthetic, gpubench.scene.weights, gpubench.counts.field; "
                "print(json.dumps(sorted(sys.modules)))")
    assert p.returncode == 0, p.stderr
    tops = {m.split(".")[0] for m in json.loads(p.stdout.strip().splitlines()[-1])}
    assert not tops & {"ngf_tpu_torch", *FORBIDDEN}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "ngf_tpu_torch_extra", sys)
    assert "ngf_tpu_torch_extra" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ngf_tpu.render", sys)
    assert "ngf_tpu.render" in harness.forbidden_modules()


@pytest.mark.gpu
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark measures the port on the card")
    p = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "infoinv-lego.train",
                        "--seed", "2147483649", "--seconds", "2", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
