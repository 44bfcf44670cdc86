"""The ``render`` driver: the final evaluation of a trained scene. Set-up
trains the configuration's schedule through its events with
``TriPlaneTrainer.run`` (stopped from its ``progress_cb`` once the last
event has run) and takes ``make_eval_render_fn(full=True)``, the renderer
``evaluation`` calls: every group, no compaction. The window renders whole
test views, chosen from the test poses by the seed, chunk by chunk, and
closes at a synchronise after the chunk during which ``--seconds``
passed."""

from __future__ import annotations

import time

import numpy as np
import torch

from gpubench import tracing
from gpubench.drivers import common
from gpubench.reference import check as ref_check
from gpubench.reference.model import flatten
from gpubench.scene import synthetic


class _SetUpDone(Exception):
    pass


def view_chunks(spec, seed: int, device) -> tuple[list, list]:
    """The rays of the views a run renders, in the seed's order, and the
    (view, first ray) of each chunk: whole views, the last chunk of a view
    holding what is left."""
    sc, tr = spec.config["scene"], spec.traffic
    wh = tuple(sc["wh"])
    order = np.random.default_rng(seed).permutation(sc["test_views"])[:tr["views"]]
    poses = synthetic.poses("test", sc["test_views"])
    dirs = synthetic.directions(wh, device)
    views = [synthetic.view_rays(dirs, poses[v]) for v in order]
    n = wh[0] * wh[1]
    return views, [(v, i) for v in range(len(views)) for i in range(0, n, tr["chunk"])]


def run(spec, seed: int, seconds: float, trace: bool, device: torch.device, t0: float,
        scene=None) -> dict:
    E = common.last_event(spec.config)
    trainer, scene, weights, notes, build_s = common.build(spec, seed, device, None, scene)

    def progress(it, mse):
        if it == E:
            raise _SetUpDone

    try:
        trainer.run(progress_cb=progress)
    except _SetUpDone:
        pass
    render = trainer.make_eval_render_fn(full=True)
    views, chunks = view_chunks(spec, seed, device)
    size = spec.traffic["chunk"]
    cuda = device.type == "cuda"
    # Warm the two chunk shapes a view has: a whole chunk and its last one.
    for v, i in (chunks[0], chunks[-1]) * 2:
        render(views[v][i:i + size])
    if cuda:
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    prof = tracing.start() if trace else None
    start = time.perf_counter()
    outs, rays = [], 0
    while not outs or time.perf_counter() - start < seconds:
        v, i = chunks[len(outs) % len(chunks)]
        chunk = views[v][i:i + size]
        outs.append(render(chunk))
        rays += chunk.shape[0]
    if cuda:
        torch.cuda.synchronize(device)
    end = time.perf_counter()
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    trace_events = tracing.stop(prof) if trace else None
    window_s = end - start
    geom = common.program_geometry(trainer)
    params = {k: v.detach().clone() for k, v in flatten(trainer.params).items()}
    run = {
        "e2e": {"render_rays_per_s": rays / window_s, "setup_s": start - t0},
        "attempted": len(outs),
        "failed": int(sum(not bool(torch.isfinite(o[0]).all()) for o in outs)),
        "peak_bytes": max(setup_peak, window_peak) if cuda else 0,
        "notes": notes + [f"window {len(outs)} chunks, {rays} rays in {window_s:.3f} s; "
                          f"{geom['n_samples']} samples a ray in training"],
        "seed": seed, "scene": scene, "geometry": geom, "params": params, "outs": outs,
        "views": views, "chunks": chunks, "n_iters": trainer.args.n_iters, "build_s": build_s,
    }
    if trace:
        run["trace"] = tracing.read(trace_events)
        run["trace"].update(chunks=len(outs), rays=rays, window_peak=window_peak)
    common.free(trainer)
    return run


def check(spec, run: dict) -> dict:
    return ref_check.render_numbers(spec, run)
