"""The ``train`` driver: one call of ``TriPlaneTrainer.run``, the loop that
``main_torch.py`` runs, carries the whole run. Its first steps from the seed
and the events are set-up; the first masked steps after the last event are
checked against the reference; after ``warm_steps`` masked steps the window
opens at a synchronise and closes at one once ``--seconds`` have passed
(and at least the checked steps have run), and the trainer is stopped
through its own SIGTERM drain. Every step boundary in the window is a CUDA
event recorded on the stream from the trainer's ``progress_cb``. The
state at the window's start and after its first and third steps is copied
on the device (no synchronise) for the reference's check of the window's
first steps."""

from __future__ import annotations

import os
import shutil
import signal
import time

import numpy as np
import torch

from gpubench import tracing
from gpubench.drivers import common
from gpubench.reference import check as ref_check
from gpubench.reference.model import flatten


class Window:
    """The measured window: opened and closed at a synchronise; a CUDA event
    at each step boundary; the profiler around it in a traced run."""

    def __init__(self, seconds: float, trace: bool, device: torch.device, t0: float,
                 min_steps: int = 1):
        self.seconds, self.trace, self.device, self.t0 = seconds, trace, device, t0
        self.min_steps = min_steps
        self.cuda = device.type == "cuda"
        self.running = self.done = False
        self.events: list = []
        self.setup_peak = 0

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def _event(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events.append(e)
        else:
            self.events.append(time.perf_counter())

    def open(self):
        self._sync()
        if self.cuda:
            self.setup_peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self.prof = tracing.start() if self.trace else None
        self.start = time.perf_counter()
        self.setup_s = self.start - self.t0
        self._event()
        self.running = True

    def tick(self) -> bool:
        """A step ended; True once the window has closed."""
        self._event()
        if time.perf_counter() - self.start < self.seconds or len(self.events) <= self.min_steps:
            return False
        self._sync()
        self.end = time.perf_counter()
        self.window_peak = torch.cuda.max_memory_allocated(self.device) if self.cuda else 0
        if self.prof is not None:
            self.trace_events = tracing.stop(self.prof)
        self.running, self.done = False, True
        return True

    def intervals_ms(self) -> np.ndarray:
        if self.cuda:
            return np.array([a.elapsed_time(b) for a, b in zip(self.events[:-1], self.events[1:])])
        return 1e3 * np.diff(np.array(self.events))


def run(spec, seed: int, seconds: float, trace: bool, device: torch.device, t0: float,
        scene=None) -> dict:
    cfg, tr = spec.config, spec.traffic
    E = common.last_event(cfg)
    warm_end = E + tr["warm_steps"]
    logdir = common.log_folder()
    trainer, scene, weights, notes, build_s = common.build(spec, seed, device, logdir, scene)
    batch = trainer.args.batch_size
    n_check = tr["checked_steps"]
    win = Window(seconds, trace, device, t0, n_check)
    snaps: dict = {}
    t_steps = time.perf_counter()

    def progress(it, mse):
        if it == 1:
            snaps["open_m1"] = common.snapshot_adam(trainer)["m"]
        if it == n_check:
            snaps["open_p3"] = common.snapshot_params(trainer)
        if it == E:
            snaps["p0"] = common.snapshot_params(trainer)
            snaps["adam0"] = common.snapshot_adam(trainer)
        if it == E + 1:
            snaps["m1"] = common.snapshot_adam(trainer)["m"]
        if it == E + n_check:
            snaps["p3"] = common.snapshot_params(trainer)
        if it == warm_end:
            snaps["pw"] = common.snapshot_params(trainer)
            snaps["adamw"] = common.snapshot_adam(trainer)
            win.open()
        elif win.running:
            if it == warm_end + 1:
                snaps["mw1"] = common.snapshot_m(trainer)
            if it == warm_end + n_check:
                snaps["pw3"] = common.snapshot_params(trainer)
            if win.tick():
                if trace:
                    snaps["pc"] = common.snapshot_params(trainer)
                os.kill(os.getpid(), signal.SIGTERM)

    try:
        out = trainer.run(progress_cb=progress)
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    if not win.done:
        raise RuntimeError(f"the run ended at iteration {trainer.iteration} before its window closed")
    late = [e["iteration"] for e in trainer.events if e["iteration"] > warm_end]
    if late:
        raise RuntimeError(f"events at {late} fell inside the window")
    steps = len(win.events) - 1
    window_s = win.end - win.start
    iv = win.intervals_ms()
    peak = max(win.setup_peak, win.window_peak)
    mses = out["train_mses"]
    geom = common.program_geometry(trainer)
    run = {
        "e2e": {"train_rays_per_s": steps * batch / window_s,
                "train_step_p95_ms": float(np.percentile(iv, 95)),
                "setup_s": win.setup_s},
        "attempted": steps,
        "failed": int(sum(not np.isfinite(m) for m in mses[warm_end:warm_end + steps])),
        "peak_bytes": peak,
        "notes": notes + [f"{warm_end} steps and the events before the window "
                          f"{win.start - t_steps:.3f} s",
                          f"window {steps} steps in {window_s:.3f} s from iteration {warm_end}",
                          "step ms p50 / p90 / p95 / p99 / max "
                          + " / ".join(f"{v:.3f}" for v in np.percentile(iv, [50, 90, 95, 99, 100])),
                          f"capacity {geom['cap']}, {geom['n_samples']} samples a ray, "
                          f"{len(geom['kept_ids'])} rays kept"],
        "seed": seed, "scene": scene, "weights_flat": flatten(weights), "mses": mses, "snaps": snaps,
        "geometry": geom, "E": E, "warm_end": warm_end, "steps": steps, "batch": batch,
        "build_s": build_s,
    }
    if trace:
        run["trace"] = tracing.read(win.trace_events)
        run["trace"].update(steps=steps, window_peak=win.window_peak, batch=batch)
    common.free(trainer)
    return run


def check(spec, run: dict) -> dict:
    return ref_check.train_numbers(spec, run)
