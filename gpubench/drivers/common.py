"""What the train and render drivers share: the port's trainer built from a
configuration file on the benchmark's scene and weights, watched at its
occupancy events, and the snapshots of its state that the reference reads."""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from gpubench.reference.model import flatten
from gpubench.scene.synthetic import TrainSplit
from gpubench.scene.weights import make_weights
from ngf_tpu_torch.config import TrainArgs
from ngf_tpu_torch.train.loop import TriPlaneTrainer


def weights_seed(seed: int) -> int:
    """The weights' stream, apart from the trainer's jitter stream, which
    starts from ``seed`` itself."""
    return (seed * 0x9E3779B1 + 0x7F4A7C15) % (1 << 62)


def event_iterations(cfg: dict) -> tuple[list[int], list[int]]:
    """(mask events, upsample events) of the configuration, as the trainer
    runs them: InfoInv does not upsample."""
    a = cfg["args"]
    ups = list(a.get("upsamp_list", [])) if a["subsystem"] == "triplane" else []
    return list(a.get("update_AlphaMask_list", [])), ups


def last_event(cfg: dict) -> int:
    masks, ups = event_iterations(cfg)
    return max(masks + ups)


def train_args(cfg: dict, seed: int, device: torch.device) -> TrainArgs:
    return TrainArgs(**cfg["args"], seed=seed, device=device.type)


def snapshot_params(trainer) -> dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in flatten(trainer.params).items()}


def snapshot_adam(trainer) -> dict:
    """The optimizer's moments and step counts by leaf name, and the decay
    schedule's count."""
    state = trainer.optimizer.adam.state
    out = {"m": {}, "v": {}, "t": {}, "count": trainer.optimizer.count}
    for k, p in flatten(trainer.params).items():
        s = state.get(p, {})
        out["m"][k] = s["exp_avg"].detach().clone() if s else torch.zeros_like(p)
        out["v"][k] = s["exp_avg_sq"].detach().clone() if s else torch.zeros_like(p)
        out["t"][k] = int(s["step"]) if s else 0
    return out


def snapshot_m(trainer) -> dict[str, torch.Tensor]:
    """The optimizer's first moments by leaf name (device copies only)."""
    state = trainer.optimizer.adam.state
    return {k: state[p]["exp_avg"].detach().clone() if p in state else torch.zeros_like(p)
            for k, p in flatten(trainer.params).items()}


class WatchedTrainer(TriPlaneTrainer):
    """The port's trainer, unchanged, with a record of each mask event (the
    parameters it read, and the grid, box and kept rays it left) and of each
    change of the planes' shapes: the parameters before and after the
    gauge's crop (inside its first mask event) and each upsample."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.watched: list[dict] = []
        self.resampled: list[dict] = []
        self.bbox_ids = self._ray_ids

    def _event_update_alpha_mask(self, first: bool) -> dict:
        ev = {"iteration": self.iteration, "first": first, "params": snapshot_params(self)}
        rec = super()._event_update_alpha_mask(first)
        ev.update(occ=self.alpha.occ.clone(), rec=rec, ray_ids=self._ray_ids)
        self.watched.append(ev)
        return rec

    def _event_shrink(self, new_aabb):
        before = snapshot_params(self)
        out = super()._event_shrink(new_aabb)
        self.resampled.append({"kind": "crop", "iteration": self.iteration, "before": before,
                               "after": snapshot_params(self)})
        return out

    def _event_upsample(self):
        before = snapshot_params(self)
        rec = super()._event_upsample()
        if rec is not None:
            self.resampled.append({"kind": "resize", "iteration": self.iteration,
                                   "before": before, "after": snapshot_params(self)})
        return rec


def build(spec, seed: int, device: torch.device, logfolder: str | None, scene=None):
    """(trainer, scene, weights, notes, build_s): the kernels loaded (built on
    a checkout's first run, in ``build_s`` seconds), the scene, the weights
    from the seed, the trainer over them."""
    notes, build_s = [], 0.0
    if device.type == "cuda":
        from ngf_tpu_torch.ops import cuda_kernels

        build_s = cuda_kernels.build_all()
        notes.append(f"kernels loaded or built in {build_s:.3f} s")
    sc = spec.config["scene"]
    t = time.perf_counter()
    if scene is None:
        scene = TrainSplit(sc["train_views"], tuple(sc["wh"]), device)
        notes.append(f"scene {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    weights = make_weights(spec.config, weights_seed(seed), device)
    trainer = WatchedTrainer(train_args(spec.config, seed, device), scene, None, logfolder,
                             init_params=weights, device=device)
    notes.append(f"weights and trainer {time.perf_counter() - t:.3f} s")
    return trainer, scene, weights, notes, build_s


def program_geometry(trainer) -> dict:
    """What the trainer runs the window with after its events."""
    return {"aabb": np.asarray(trainer.aabb, np.float32).copy(), "grid": list(trainer.grid_size),
            "step": float(trainer.step_size), "n_samples": int(trainer.n_samples),
            "cap": int(trainer._effective_sample_cap()), "kept_ids": trainer._ray_ids,
            "bbox_ids": trainer.bbox_ids, "events": trainer.watched,
            "resampled": trainer.resampled}


def log_folder() -> str:
    """A fresh log folder under ``TMPDIR`` (the trainer writes ``log.txt``,
    ``scalars.jsonl`` and its SIGTERM checkpoint there)."""
    return tempfile.mkdtemp(prefix="gpubench-", dir=os.environ.get("TMPDIR"))


def free(trainer) -> None:
    trainer.params = trainer.optimizer = trainer.batch_table = None
    trainer.all_rays = trainer.all_rgbs = trainer.alpha = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
