"""Dense InfoInv training: the open stage of `ngf_tpu/train/loop.py`.

Port of the part of `TriPlaneTrainer` (reference `InfoInv/main.py:191-360`)
that trains without occupancy events: the geometry and samples, the bbox ray
filter and the epoch sampler, the optimizer, the loss (MSE + L1 + optional
TV) with microbatch accumulation, the run loop with its logs and
checkpoint, and the final evaluation renderer.

Differences from the JAX trainer:
- The training rays and colours live on the device as one (N, 9) table,
  and so do the sampler's ids (one copy of each epoch's permutation): each
  batch is one ``gather_rows`` of the table (the ``gather_rows`` CUDA
  kernel on the card) at a slice of those ids, with no copy from the host.
- PyTorch runs eagerly, one step at a time: the TPU machinery (event
  prewarm, AOT compiles, ``steps_per_call`` scans, block prefetch) is not
  ported, and ``steps_per_call`` has no effect.
- Not ported yet, and refused with a pointer to ROADMAP.md: occupancy and
  upsample events inside ``n_iters``, ``group_size > 0``, the gauge
  subsystem, ``compute_dtype bfloat16``, resume, data-parallel meshes.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from ..config import TrainArgs
from ..convert import named_leaves
from ..data.dataset import RayDataset
from ..data.sampler import DeviceSampler
from ..fields.triplane import TriPlaneConfig, density_l1, init_triplane
from ..ops.gather import gather_rows
from ..render.evaluation import evaluation
from ..render.volume import RenderConfig, render_rays
from ..utils.checkpoint import save_checkpoint
from ..utils.grid import cal_n_samples, grid_n_samples, grid_step_size, n_to_reso
from ..utils.metrics import mse2psnr, tv_loss_2d
from .occupancy import filter_rays_bbox
from .state import TriPlaneOptimizer


def model_config_from_args(args: TrainArgs) -> TriPlaneConfig:
    """(`ngf_tpu/train/loop.py:64-78`)."""
    if args.subsystem == "triplane":
        base = TriPlaneConfig.gauge_preset(gauge_start=args.gauge_start)
    else:
        base = TriPlaneConfig.infoinv_preset(infoinv=args.infoinv)
    return dataclasses.replace(
        base,
        density_shift=args.density_shift,
        distance_scale=args.distance_scale,
        plane_res=args.plane_res,
        gauge_res=args.gauge_res,
        compute_dtype=args.compute_dtype,
    )


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to ngf_tpu_torch yet: see ROADMAP.md {item}")


def check_ported(args: TrainArgs) -> None:
    """Raise for every training option this slice does not carry."""
    if args.Ortho_weight > 0:
        # As `ngf_tpu/train/loop.py:102-110`: dead code in the reference.
        raise NotImplementedError(
            "Ortho_weight > 0: the reference's vector_comp_diffs is dead code for "
            "tri-plane models; no equivalent is defined."
        )
    events = [e for e in args.update_AlphaMask_list or [] if 0 < e <= args.n_iters]
    if args.subsystem == "triplane":
        events += [e for e in args.upsamp_list or [] if 0 < e <= args.n_iters]
    if events:
        raise _not_ported(
            f"training with occupancy/upsample events inside n_iters={args.n_iters} "
            f"(at {sorted(events)})",
            "queue 1, item 2, 'Occupancy events and the grouped path'",
        )
    if args.group_size > 0:
        raise _not_ported(
            f"group_size={args.group_size} (grouped compaction); use --group_size 0",
            "queue 1, item 2, 'Occupancy events and the grouped path'",
        )
    if args.subsystem != "infoinv":
        raise _not_ported(
            f"training the {args.subsystem!r} (learned gauge) subsystem",
            "queue 1, item 3, 'Gauge training'",
        )
    if args.compute_dtype != "float32":
        raise _not_ported(f"compute_dtype {args.compute_dtype} in training", "queue 1, 'bfloat16 training'")
    if args.mesh_shape:
        raise _not_ported(f"mesh_shape {args.mesh_shape!r}", "queue 1, item 5, 'Parallel modes'")
    if args.batch_size % max(1, args.microbatch):
        raise ValueError(f"batch_size {args.batch_size} is not a multiple of microbatch {args.microbatch}")


class TriPlaneTrainer:
    """Owns the parameters, the optimizer, the device-resident training set
    and the sampler; :meth:`run` trains for ``args.n_iters`` steps."""

    def __init__(
        self,
        args: TrainArgs,
        train_dataset: RayDataset,
        test_dataset: RayDataset | None = None,
        logfolder: str | None = None,
        init_params=None,
        device: torch.device | str = "cuda",
    ):
        check_ported(args)
        self.args = args
        self.train_dataset = train_dataset
        self.test_dataset = test_dataset
        self.logfolder = logfolder
        self.device = torch.device(device)

        # Geometry and samples (`ngf_tpu/train/loop.py:112-122`).
        self.model_cfg = model_config_from_args(args)
        self.aabb = np.asarray(train_dataset.scene_bbox, np.float32)
        self.reso_cur = n_to_reso(args.plane_res ** 3, self.aabb)
        self.n_samples = min(args.nSamples, cal_n_samples(self.reso_cur, args.step_ratio))
        self.step_size = grid_step_size(self.aabb, self.reso_cur, args.step_ratio)
        self.grid_size = list(self.reso_cur)
        self._check_marching_coverage()

        # One generator on the device: initial weights, then the per-ray
        # jitter and random backgrounds of every step.
        self.gen = torch.Generator(device=self.device).manual_seed(args.seed)
        params = init_triplane(self.model_cfg, self.gen, self.device) if init_params is None else init_params
        self.params = _leaf_params(params, self.device)
        self.l1_weight = args.L1_weight_initial
        self.iteration = 0

        # Bbox ray filter and sampler (`ngf_tpu/train/loop.py:183-199`).
        all_rays = np.asarray(train_dataset.all_rays, np.float32).reshape(-1, 6)
        all_rgbs = np.asarray(train_dataset.all_rgbs, np.float32).reshape(-1, 3)
        if args.filter_rays:
            keep = filter_rays_bbox(all_rays, self.aabb)
            all_rays, all_rgbs = all_rays[keep], all_rgbs[keep]
        # One (N, 9) table, rays in columns 0:6 and colours in 6:9, so that
        # a batch is one row gather; ``all_rays`` and ``all_rgbs`` are views.
        self.batch_table = torch.from_numpy(np.concatenate([all_rays, all_rgbs], 1)).to(self.device)
        self.all_rays, self.all_rgbs = self.batch_table[:, :6], self.batch_table[:, 6:]
        self.sampler = DeviceSampler(all_rays.shape[0], args.batch_size, args.seed, self.device)
        self._make_optimizer()

    # ------------------------------------------------------------------ setup

    def _check_marching_coverage(self) -> None:
        """Warn when ``--nSamples`` caps marching below the geometry's need
        (`ngf_tpu/train/loop.py:260-282`)."""
        need = cal_n_samples(self.reso_cur, self.args.step_ratio)
        if self.n_samples < need:
            diag = float(np.linalg.norm(self.aabb[1] - self.aabb[0]))
            cover = self.n_samples * self.step_size / max(diag, 1e-9)
            print(
                f"[trainer] WARNING: nSamples {self.n_samples} < required {need} at this "
                f"resolution: marching covers only {100.0 * cover:.1f}% of the aabb "
                f"diagonal. Raise --nSamples to >= {need}.",
                flush=True,
            )

    def _make_optimizer(self) -> None:
        """(`ngf_tpu/train/loop.py:284-311`)."""
        a = self.args
        decay_iters = a.lr_decay_iters if a.lr_decay_iters > 0 else a.n_iters
        self.optimizer = TriPlaneOptimizer(
            self.params, a.lr_init, a.lr_basis, a.lr_decay_target_ratio, decay_iters
        )

    def _effective_sample_cap(self) -> int:
        """``sample_cap = -1`` (auto) is ``open_sample_cap`` before the first
        occupancy grid, and this slice trains the open stage only
        (`ngf_tpu/train/loop.py:313-326`)."""
        if self.args.sample_cap != -1:
            return self.args.sample_cap
        return self.args.open_sample_cap

    def _resolve_rgb_cap(self) -> int:
        """(`ngf_tpu/train/loop.py:328-343`). ``-2`` (auto) stays dense until
        the first event measures it, and this slice has no events."""
        a = self.args.rgb_cap
        cap = self._effective_sample_cap()
        if a == -1 and cap:
            return max(32, cap // 4)
        if a == -2:
            return 0
        return max(0, a)

    def _render_cfg(self, sample_cap: int | None = None) -> RenderConfig:
        """(`ngf_tpu/train/loop.py:368-387`)."""
        return RenderConfig(
            aabb=tuple(map(tuple, self.aabb.tolist())),
            near=float(self.train_dataset.near_far[0]),
            far=float(self.train_dataset.near_far[1]),
            n_samples=self.n_samples,
            step_size=self.step_size,
            distance_scale=self.args.distance_scale,
            ray_march_weight_thres=self.args.rm_weight_mask_thre,
            white_bg=self.train_dataset.white_bg,
            sample_cap=self._effective_sample_cap() if sample_cap is None else sample_cap,
            rgb_cap=self._resolve_rgb_cap(),
            mask_stride=self.args.mask_stride,
            group_size=self.args.group_size,
        )

    # ------------------------------------------------------------------ step

    def loss_fn(self, rays, rgbs, generator=None, sample_fn=None):
        """MSE + L1 (+ TV) of one batch (`ngf_tpu/train/loop.py:444-482`).
        Returns (loss, mse)."""
        out = render_rays(
            self.params, self.model_cfg, self._render_cfg(), rays,
            iteration=self.iteration, sample_fn=sample_fn, generator=generator,
        )
        mse = ((out["rgb_map"] - rgbs) ** 2).mean()
        loss = mse + self.l1_weight * density_l1(self.params)
        tv_density, tv_app = self.args.TV_weight_density, self.args.TV_weight_app
        if tv_density > 0 or tv_app > 0:
            dd = self.model_cfg.density_dim
            for name in ("plane_xy", "plane_yz", "plane_xz"):
                if tv_density > 0:
                    loss = loss + tv_density * 1e-2 * tv_loss_2d(self.params[name][..., :dd])
                if tv_app > 0:
                    loss = loss + tv_app * 1e-2 * tv_loss_2d(self.params[name][..., dd:])
        return loss, mse

    def compute_grads(self, rays, rgbs, generator=None, sample_fn=None) -> torch.Tensor:
        """Gradients of one batch into the parameters' ``.grad``, averaged
        over ``microbatch`` equal chunks whose backward runs before the next
        chunk's forward (`ngf_tpu/train/loop.py:486-519`). Returns the MSE
        (a device scalar)."""
        micro = max(1, self.args.microbatch)
        self.optimizer.zero_grad()
        mse_sum = torch.zeros((), device=rays.device)
        for r, g in zip(rays.chunk(micro), rgbs.chunk(micro)):
            loss, mse = self.loss_fn(r, g, generator, sample_fn)
            loss.backward()
            mse_sum = mse_sum + mse.detach()
        if micro > 1:
            for _, p in named_leaves(self.params):
                if p.grad is not None:
                    p.grad.div_(micro)
        return mse_sum / micro

    def train_step(self, rays, rgbs, generator=None, sample_fn=None) -> torch.Tensor:
        """One optimizer step on a batch (`one_step`,
        `ngf_tpu/train/loop.py:486-523`); returns the MSE as a device scalar."""
        mse = self.compute_grads(rays, rgbs, generator, sample_fn)
        self.optimizer.step()
        self.iteration += 1
        return mse

    def next_batch(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(rays (B, 6), rgbs (B, 3)) at the sampler's next ids: one row
        gather of the device-resident table at ids already on the device
        (`ngf_tpu/train/loop.py:1438-1451`). Both are views of one (B, 9)
        tensor."""
        rows = gather_rows(self.batch_table, self.sampler.nextids())
        return rows[:, :6], rows[:, 6:]

    # ------------------------------------------------------------------ run

    def run(self) -> dict:
        """Train to ``n_iters`` with logs, periodic evaluation and
        checkpoints, then save ``model.npz`` (`ngf_tpu/train/loop.py:1495-1645`,
        without events)."""
        args = self.args
        log_path = None
        if self.logfolder:
            os.makedirs(os.path.join(self.logfolder, "imgs_vis"), exist_ok=True)
            log_path = os.path.join(self.logfolder, "log.txt")
        psnrs_test = [0.0]
        # MSEs stay device scalars until a log needs them, so the host does
        # not wait for the card after every step.
        pending: list[torch.Tensor] = []
        mses: list[float] = []
        t0 = time.time()
        # A profiler span around the steps (`chip_smoke.py` counts the
        # host-to-device copies inside it).
        with torch.profiler.record_function("train_loop"):
            while self.iteration < args.n_iters:
                pending.append(self.train_step(*self.next_batch(), self.gen))
                it = self.iteration
                log_now = log_path is not None and it % args.progress_refresh_rate == 0
                vis_now = (
                    args.N_vis != 0 and args.vis_every > 0 and it % args.vis_every == 0
                    and self.test_dataset is not None and self.logfolder
                )
                if log_now or vis_now or it == args.n_iters:
                    mses += torch.stack(pending).tolist()
                    pending = []
                if log_now:
                    train_psnr = np.mean([mse2psnr(m) for m in mses[-50:]])
                    with open(log_path, "a") as f:
                        f.write(
                            f"Iteration {it:05d}: train_psnr = {train_psnr:.2f}"
                            f" test_psnr = {float(np.mean(psnrs_test)):.2f} mse = {mses[-1]:.6f}\n"
                        )
                if vis_now:
                    psnrs_test = evaluation(
                        self.test_dataset, self.make_eval_render_fn(iteration=it),
                        os.path.join(self.logfolder, "imgs_vis"), n_vis=args.N_vis,
                        prtx=f"{it:06d}_", chunk=args.eval_chunk, compute_extra_metrics=False,
                    ) or [0.0]
                    if log_path:
                        with open(log_path, "a") as f:
                            f.write(f"Iteration {it:05d}: test/psnr = "
                                    f"{float(np.mean(psnrs_test)):.2f}\n")
                save_now = args.save_every > 0 and it % args.save_every == 0
                if save_now and it < args.n_iters and self.logfolder:
                    self.save(os.path.join(self.logfolder, "model.npz"))
        wall = time.time() - t0
        if self.logfolder:
            self.save(os.path.join(self.logfolder, "model.npz"))
        return {
            "iterations": self.iteration,
            "wall_time_s": wall,
            "final_train_mse": mses[-1] if mses else None,
            "rays_per_sec": args.batch_size * self.iteration / max(wall, 1e-9),
            "train_mses": mses,
            "id_uploads": self.sampler.uploads,
        }

    def make_eval_render_fn(self, iteration: int | None = None, full: bool = False):
        """Chunk renderer ``rays -> (rgb, depth)`` of the current weights
        (`ngf_tpu/train/loop.py:1207-1270`). ``full=True`` is the final
        evaluation: the full geometry-derived sample count, no compaction."""
        rcfg = self._render_cfg()
        if full:
            rcfg = dataclasses.replace(
                self._render_cfg(sample_cap=0),
                n_samples=grid_n_samples(self.aabb, self.step_size),
                rgb_cap=0,
            )
        it = self.args.n_iters + 1 if iteration is None else iteration
        params, model_cfg, device = self.params, self.model_cfg, self.device

        @torch.inference_mode()
        def render(rays):
            out = render_rays(params, model_cfg, rcfg, rays.to(device), iteration=it)
            return out["rgb_map"], out["depth_map"]

        return render

    def save(self, path: str) -> None:
        """Write the parameters and the geometry as an ``.npz`` checkpoint
        that `main_torch.py` and `ngf_tpu` read (`ngf_tpu/train/loop.py:1676-1734`
        without the resume state)."""
        meta = {
            "subsystem": self.args.subsystem,
            "model_cfg": dataclasses.asdict(self.model_cfg),
            "aabb": self.aabb.tolist(),
            "grid_size": self.grid_size,
            "step_size": self.step_size,
            "n_samples": self.n_samples,
            "near_far": [float(v) for v in self.train_dataset.near_far],
            "iteration": self.iteration,
        }
        save_checkpoint(path, self.params, meta)


def _leaf_params(tree, device):
    """A copy of the tree as float32 leaf tensors on ``device`` that
    require grad."""
    if isinstance(tree, dict):
        return {k: _leaf_params(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_leaf_params(v, device) for v in tree]
    return tree.detach().to(device=device, dtype=torch.float32, copy=True).requires_grad_(True)
