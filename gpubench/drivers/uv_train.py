"""The ``uv_train`` driver: one call of ``UVTrainer.run``, the loop that
``uv_train_torch.py`` runs, carries the whole run of the NeuTex model on the
synthetic DTU scan. Its first ``warm_steps`` steps are set-up; then the
window opens at a synchronise and closes at one once ``--seconds`` have
passed (and at least the checked steps have run), and the trainer is
stopped through its own SIGTERM drain. Every step boundary in the window is
a CUDA event recorded from the trainer's ``progress_cb``. The items of the
checked steps, the generator's state before the first draw, the initial
parameters, and the parameters and Adam state after each checked step and
at the window's start (device copies, no synchronise) are kept for the
reference's check (``reference/uv_check.py``).

A tree whose ``UVTrainer`` has no ``run`` cannot run this cell: ``run``
below says so and stops before it builds anything."""

from __future__ import annotations

import contextlib
import os
import shutil
import signal
import sys
import time

import numpy as np
import torch

from gpubench import tracing
from gpubench.drivers.common import log_folder
from gpubench.drivers.train import Window
from gpubench.reference import uv_check
from gpubench.reference.model import flatten


def _trainer_class():
    from ngf_tpu_torch.train.uv_loop import UVTrainer

    if not callable(getattr(UVTrainer, "run", None)):
        raise SystemExit("gpubench: this tree's UVTrainer has no run(): the UV cells train "
                         "through UVTrainer.run, the loop of uv_train_torch.py")
    return UVTrainer


class _Recorder:
    """The dataset as the trainer samples it, keeping the items of the
    steps in ``keep`` (0-based)."""

    def __init__(self, dataset, keep: set[int]):
        self.dataset, self.keep = dataset, keep
        self.items: dict[int, dict] = {}
        self.n = 0

    def sample(self) -> dict:
        item = self.dataset.sample()
        if self.n in self.keep:
            self.items[self.n] = {k: v.copy() for k, v in item.items()}
        self.n += 1
        return item


def make_dataset(spec, seed: int):
    from ngf_tpu_torch.data.dtu import SyntheticDtuDataset

    a, sc = spec.config["args"], spec.config["scene"]
    return SyntheticDtuDataset(n_views=sc["views"], wh=tuple(sc["wh"]),
                               random_sample=a["random_sample"],
                               random_sample_size=a["random_sample_size"], seed=seed)


def build(spec, seed: int, device: torch.device, save_dir: str | None):
    """(trainer, notes, build_s): the kernels loaded (built on a
    checkout's first run), the trainer from the seed."""
    UVTrainer = _trainer_class()
    from ngf_tpu_torch.fields.neutex import NeuTexConfig

    notes, build_s = [], 0.0
    if device.type == "cuda":
        from ngf_tpu_torch.ops import cuda_kernels

        build_s = cuda_kernels.build_all()
        notes.append(f"kernels loaded or built in {build_s:.3f} s")
    a, w = spec.config["args"], spec.config["widths"]
    cfg = NeuTexConfig(primitive_type=a["primitive_type"], sample_num=a["sample_num"],
                       points_per_primitive=a["points_per_primitive"], jitter=a["jitter"],
                       compute_dtype=a["compute_dtype"], **w)
    t = time.perf_counter()
    trainer = UVTrainer(cfg, None, lr=a["lr"], niter=a["niter"], niter_decay=a["niter_decay"],
                        lr_policy=a["lr_policy"],
                        loss_weights={"color": a["loss_color_weight"], "bg": a["loss_bg_weight"],
                                      "origin": a["loss_origin_weight"],
                                      "inverse_mapping": a["loss_inverse_mapping_weight"]},
                        seed=seed, save_dir=save_dir, device=device)
    notes.append(f"trainer {time.perf_counter() - t:.3f} s")
    return trainer, notes, build_s


def snapshot_params(trainer) -> dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in flatten(trainer.params).items()}


def snapshot_adam(trainer) -> dict:
    """Adam's moments and step counts by leaf name (device copies: a count
    on the card is read after the window) and the update count."""
    out = {"m": {}, "v": {}, "t": {}, "count": trainer.schedule_count}
    for k, p in flatten(trainer.params).items():
        s = trainer.adam.state.get(p, {})
        out["m"][k] = s["exp_avg"].detach().clone() if s else torch.zeros_like(p)
        out["v"][k] = s["exp_avg_sq"].detach().clone() if s else torch.zeros_like(p)
        out["t"][k] = s["step"].detach().clone() if s else 0
    return out


def run(spec, seed: int, seconds: float, trace: bool, device: torch.device, t0: float,
        dataset=None) -> dict:
    tr, a = spec.traffic, spec.config["args"]
    W, n_check = tr["warm_steps"], tr["checked_steps"]
    save_dir = log_folder()
    trainer, notes, build_s = build(spec, seed, device, save_dir)
    t = time.perf_counter()
    if dataset is None:
        dataset = make_dataset(spec, seed)
        notes.append(f"dataset {time.perf_counter() - t:.3f} s")
    rec = _Recorder(dataset, set(range(n_check)) | set(range(W, W + n_check)))
    init = snapshot_params(trainer)
    gen_state = trainer.gen.get_state()
    win = Window(seconds, trace, device, t0, n_check)
    snaps: dict = {}
    t_steps = time.perf_counter()

    keep = set(range(1, n_check + 1)) | set(range(W, W + n_check + 1))

    def progress(step):
        if step in keep:
            snaps[step] = {"p": snapshot_params(trainer), "adam": snapshot_adam(trainer)}
        if step == W:
            win.open()
        elif win.running and win.tick():
            os.kill(os.getpid(), signal.SIGTERM)

    try:
        # The trainer's log lines go to standard error: the last line of
        # standard output is the run's result.
        with contextlib.redirect_stdout(sys.stderr):
            out = trainer.run(rec, steps_per_call=a["steps_per_call"], print_freq=a["print_freq"],
                              test_freq=a["test_freq"], save_iter_freq=a["save_iter_freq"],
                              progress_cb=progress)
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
    if not win.done:
        raise RuntimeError(f"the run ended at step {out['total_steps']} before its window closed")
    steps = len(win.events) - 1
    window_s = win.end - win.start
    iv = win.intervals_ms()
    rays = rec.items[0]["raydir"].shape[1]
    total = out["losses"]["total"]
    run = {
        "e2e": {"train_rays_per_s": steps * rays / window_s,
                "train_step_p95_ms": float(np.percentile(iv, 95)),
                "setup_s": win.setup_s},
        "attempted": steps,
        "failed": int(sum(not np.isfinite(v) for v in total[W:W + steps])),
        "peak_bytes": max(win.setup_peak, win.window_peak),
        "notes": notes + [f"{W} steps before the window {win.start - t_steps:.3f} s",
                          f"window {steps} steps in {window_s:.3f} s from step {W}",
                          "step ms p50 / p90 / p95 / p99 / max "
                          + " / ".join(f"{v:.3f}" for v in np.percentile(iv, [50, 90, 95, 99, 100])),
                          f"{rays} rays a step, {a['sample_num']} samples a ray, "
                          f"{a['points_per_primitive']} template points; the run stopped at step "
                          f"{out['total_steps']}"],
        "seed": seed, "config": spec.config, "init": init, "gen_state": gen_state,
        "items": rec.items, "losses": total, "snaps": snaps, "warm_end": W, "steps": steps,
        "batch": rays, "build_s": build_s, "dataset": dataset,
    }
    if trace:
        run["trace"] = tracing.read(win.trace_events)
        run["trace"].update(steps=steps, window_peak=win.window_peak, batch=rays,
                            config=spec.config)
    trainer.params = trainer.adam = trainer.trainable = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return run


def check(spec, run: dict) -> dict:
    return uv_check.numbers(spec, run)
