"""Staged training: `TriPlaneTrainer` of `ngf_tpu/train/loop.py`.

Port of `TriPlaneTrainer` for both tri-plane subsystems (references
`InfoInv/main.py:191-360`, `TriPlane/main.py:200-357`): the geometry and
samples, the bbox ray filter and the epoch sampler, the optimizer, the loss
(MSE + L1 + optional TV) with microbatch accumulation, the grouped or dense
renderer, the occupancy mask events (grid, L1 switch, ray refilter, measured
sample capacity), the learned gauge's shrink (at its first mask event) and
upsample events with their optimizer resets, the run loop with its logs,
``scalars.jsonl``, evaluations, periodic checkpoints written off the loop
and a SIGTERM drain, training resume from either package's checkpoint
(:meth:`TriPlaneTrainer.from_checkpoint`), the final evaluation renderer,
the mesh export (:meth:`TriPlaneTrainer.export_mesh`), and the two parallel
modes over ``torch.distributed`` (``mesh``).

Differences from the JAX trainer:
- The training rays and colours live on the device as one (N, 9) table,
  and so do the sampler's ids (one copy of each epoch's permutation): each
  batch is one ``gather_rows`` of the table (the ``gather_rows`` CUDA
  kernel on the card) at a slice of those ids, with no copy from the host.
- PyTorch runs eagerly, one step at a time: the TPU machinery (event
  prewarm, AOT compiles, ``steps_per_call`` scans, block prefetch) is not
  ported, and ``steps_per_call`` has no effect.
- At a mask event the (N, 9) table is rebuilt on the kept rays with one
  ``gather_rows`` launch, and the occupancy tests are the K3 kernel on the
  grid's uint8 copy.
- The shrink and upsample events replace the planes with new leaf tensors
  (contiguous crops and resizes) and rebuild the optimizer over them.
- ``compute_dtype bfloat16`` trains as the JAX package does: float32
  parameters and Adam, the planes' values fetched in bfloat16 (the gauge
  grids in float32), bfloat16 decoders with float32 products, float32
  densities, colours and losses. The trainer's steps, its run and its
  evaluation renderer turn off cuBLAS's bfloat16 partial-sum reduction and
  TF32 while they run (``utils.precision.float32_accumulation``), which
  PyTorch allows by default and the JAX package never does.
- The checkpoint carries the generator's state (``extra/torch_generator``)
  beside the JAX key (``extra/key``, a threefry key of the seed, which the
  JAX trainer requires and the port does not read). A resume restores the
  state where the checkpoint was written on the same device type, and
  otherwise (another device type, or the JAX package) reseeds from
  ``(seed, iteration)`` and says so: the jitter and the backgrounds then
  differ from an uninterrupted run's, all else is restored exactly.
- Under a mesh (`ngf_tpu_torch/parallel/mesh.py`) every rank is a process
  on one device with the whole parameters. Every rank draws the same global
  batch ids, jitter and background from the same streams and keeps its
  data slice (rows ``[i b, (i + 1) b)`` of each microbatch chunk); the
  parameters start from rank 0's; the gradients, the MSE and the chunks'
  top shaded-group counts go through one all-reduce a step (SUM over the
  world, the gradients then divided by the data axis's size), so every
  rank applies the same update and the parameters stay equal bit for bit.
  The events run on every rank on that replicated state. Rank 0 writes the
  logs, ``scalars.jsonl``, the evaluations and the checkpoints (the same
  format at any world size), the others wait at a barrier; a SIGTERM on
  any rank stops every rank at the same step (a MAX all-reduce of the flag
  at each log step and event). A mesh with a 'sample' axis of more than one
  rank trains the dense sample-parallel renderer
  (`ngf_tpu_torch/parallel/sample_parallel.py`) with sample_cap, rgb_cap
  and group_size 0, mask_stride 1, no occupancy grid in the step and
  n_samples padded to a multiple of the axis, as the JAX trainer does; a
  sample axis of one rank is the data mode (the JAX trainer takes the
  sample-parallel renderer for every 2-D mesh). L1 and TV count once: only
  the ranks of sample index 0 add them.
- ``rgb_cap`` (top-K shading) resolves as the JAX trainer's: K > 0 shades K
  samples a ray (``rgb_cap // G`` groups on the grouped path), -1 shades
  ``max(32, sample_cap // 4)``, -2 shades densely until the first mask
  event, then ``(ceil(1.25 stat) + 1) G`` at each mask and upsample event,
  ``stat`` the running ~p99.9 of the shaded groups a ray since the last
  pick (``rgb_stat``, kept on the device and read only at those events).
  The final evaluation and the sample-parallel mode shade densely.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time

import numpy as np
import torch

from ..config import TrainArgs
from ..convert import named_leaves
from ..data.dataset import RayDataset
from ..data.sampler import DeviceSampler
from ..fields.triplane import (
    TriPlaneConfig,
    density_l1,
    init_triplane,
    shrink_planes,
    upsample_planes,
)
from ..ops.gather import gather_rows
from ..parallel import collectives
from ..parallel.mesh import Mesh, shard_batch
from ..parallel.sample_parallel import render_rays_sp
from ..render.evaluation import evaluation
from ..render.volume import RenderConfig, compute_alpha_grid_chunk, join_stream, render_rays
from ..utils.checkpoint import (
    AsyncCheckpointWriter,
    load_checkpoint,
    load_extra_arrays,
    pack_checkpoint,
    write_arrays_atomic,
)
from ..utils.grid import cal_n_samples, grid_n_samples, grid_step_size, n_to_reso
from ..utils.marching_cubes import convert_density_to_ply
from ..utils.metrics import mse2psnr, tv_loss_2d
from ..utils.precision import float32_accumulation
from ..utils.profiling import annotate
from ..utils.scalars import ScalarWriter
from .occupancy import (
    AlphaGrid,
    auto_sample_cap,
    dense_grid_points,
    filter_rays_alpha,
    filter_rays_bbox,
    occupied_samples_per_ray,
    shrink_box_voxels,
    update_alpha_mask,
)
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


def check_ported(args: TrainArgs) -> None:
    """Raise for the training options that have no meaning."""
    if args.Ortho_weight > 0:
        # As `ngf_tpu/train/loop.py:102-110`: dead code in the reference.
        raise NotImplementedError(
            "Ortho_weight > 0: the reference's vector_comp_diffs is dead code for "
            "tri-plane models; no equivalent is defined."
        )
    if args.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {args.compute_dtype!r}: float32 or bfloat16")
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
        mesh: Mesh | None = None,
    ):
        check_ported(args)
        self.args = args
        self.train_dataset = train_dataset
        self.test_dataset = test_dataset
        self.mesh = mesh
        # Under a mesh rank 0 writes what the run writes; ``_shared_io``
        # says whether some rank does, so every rank meets at its barriers.
        self._shared_io = logfolder is not None
        self.logfolder = logfolder if mesh is None or mesh.rank == 0 else None
        self.device = torch.device(device)
        if mesh is not None and args.batch_size % (mesh.n_data * max(1, args.microbatch)):
            raise ValueError(f"batch_size {args.batch_size} does not split into {args.microbatch} "
                             f"microbatch chunks over {mesh.n_data} data ranks")

        # Geometry and samples (`ngf_tpu/train/loop.py:112-122`).
        self.model_cfg = model_config_from_args(args)
        self.aabb = np.asarray(train_dataset.scene_bbox, np.float32)
        self.reso_cur = n_to_reso(args.plane_res ** 3, self.aabb)
        self.n_samples = min(args.nSamples, cal_n_samples(self.reso_cur, args.step_ratio))
        self.step_size = grid_step_size(self.aabb, self.reso_cur, args.step_ratio)
        self.grid_size = list(self.reso_cur)
        self._check_marching_coverage("init")
        # The upsample events' voxel counts, consumed in order.
        self.n_voxel_list = self._voxel_schedule()

        # One generator on the device: initial weights, then the per-ray
        # jitter and random backgrounds of every step.
        self.gen = torch.Generator(device=self.device).manual_seed(args.seed)
        # Inside :meth:`run` on a card, the stream of each step's batch and
        # packed front end (:func:`render_rays`' ``front_stream``).
        self._front_stream: torch.cuda.Stream | None = None
        params = init_triplane(self.model_cfg, self.gen, self.device) if init_params is None else init_params
        self.params = _leaf_params(params, self.device)
        self.l1_weight = args.L1_weight_initial
        self.iteration = 0
        self.alpha: AlphaGrid | None = None
        self._auto_cap: int | None = None
        # Running max over the steps of the per-batch ~p99.9 of
        # ``shaded_groups`` (`ngf_tpu/train/loop.py:459-465`), on the device;
        # reset at each pick of the measured shading capacity
        # (``rgb_cap`` -2), which is 0 (dense) until the first.
        self.rgb_stat = torch.zeros((), dtype=torch.int32, device=self.device)
        self._auto_rgb_cap = 0
        # One record per event (mask, upsample): what it produced and its
        # phases' seconds.
        self.events: list[dict] = []
        self._scalars: ScalarWriter | None = None  # set while run() runs with a logfolder
        self._ckpt_writer = AsyncCheckpointWriter()
        # SIGTERM seen by this process; the stop every rank has agreed on.
        self._term_seen = False
        self._stop_requested = False
        # Under a mesh: each microbatch chunk's top shaded-group counts of
        # this rank's rays, reduced with the step's gradients.
        self._stat_parts: list[tuple[torch.Tensor, int]] = []

        # Bbox ray filter and sampler (`ngf_tpu/train/loop.py:183-199`).
        # ``_ray_ids``: the kept rays as indices into the dataset's order
        # (the bbox filter's here, composed with the first mask event's),
        # which a checkpoint carries so that a resume rebuilds the same set.
        table = self._dataset_table()
        self._ray_ids = np.arange(table.shape[0], dtype=np.int64)
        if args.filter_rays:
            self._ray_ids = self._ray_ids[filter_rays_bbox(table[:, :6], self.aabb)]
        self._set_table(torch.from_numpy(table[self._ray_ids]).to(self.device))
        self.sampler = DeviceSampler(self._ray_ids.size, args.batch_size, args.seed, self.device)
        # The iteration the sampler was made at (`ngf_tpu/train/loop.py:1313-1319`).
        self._sampler_birth = 0
        self._make_optimizer()
        self._broadcast_params()

    # ------------------------------------------------------------------ setup

    @property
    def _sample_parallel(self) -> bool:
        """A mesh whose 'sample' axis has more than one rank: train with the
        dense sample-parallel renderer (`ngf_tpu/train/loop.py:389-393`)."""
        return self.mesh is not None and self.mesh.n_sample > 1

    def _broadcast_params(self) -> None:
        """Every rank takes rank 0's parameters (one broadcast of a flat
        buffer)."""
        if self.mesh is not None:
            collectives.broadcast_from_rank0(p for _, p in named_leaves(self.params))

    def _dataset_table(self) -> np.ndarray:
        """The training set's (N, 9) rows in the dataset's order: rays in
        columns 0:6, colours in 6:9."""
        ds = self.train_dataset
        return np.concatenate([np.asarray(ds.all_rays, np.float32).reshape(-1, 6),
                               np.asarray(ds.all_rgbs, np.float32).reshape(-1, 3)], 1)

    def _set_table(self, table: torch.Tensor) -> None:
        """The device-resident (N, 9) table of the kept rays, so that a batch
        is one row gather; ``all_rays`` and ``all_rgbs`` are its views."""
        self.batch_table = table
        self.all_rays, self.all_rgbs = table[:, :6], table[:, 6:]

    def _voxel_schedule(self) -> list[int]:
        """The upsample events' voxel counts (`ngf_tpu/train/loop.py:236-258`):
        ``len(upsamp_list)`` points exponentially interpolated from
        ``N_voxel_init`` to ``N_voxel_final``, ``N_voxel_init`` included, as
        the reference's active code has it (`TriPlane/main.py:248-249`). With
        one upsample the only point is ``N_voxel_init``, so with
        ``N_voxel_init`` below the planes' resolution the "upsample" shrinks
        the grid, in both reference codebases."""
        ups = self.args.upsamp_list or []
        if not ups:
            return []
        return [
            int(round(v))
            for v in np.exp(np.linspace(np.log(self.args.N_voxel_init),
                                        np.log(self.args.N_voxel_final), len(ups)))
        ]

    def _check_marching_coverage(self, where: str) -> None:
        """Warn when ``--nSamples`` caps marching below the geometry's need
        (`ngf_tpu/train/loop.py:260-282`)."""
        need = cal_n_samples(self.reso_cur, self.args.step_ratio)
        if self.n_samples < need:
            diag = float(np.linalg.norm(self.aabb[1] - self.aabb[0]))
            cover = self.n_samples * self.step_size / max(diag, 1e-9)
            print(
                f"[trainer] WARNING ({where}): nSamples {self.n_samples} < required {need} at this "
                f"resolution: marching covers only {100.0 * cover:.1f}% of the aabb "
                f"diagonal. Raise --nSamples to >= {need}.",
                flush=True,
            )

    def _make_optimizer(self) -> None:
        """A new optimizer over the current leaf tensors, its state and decay
        schedule from the start (`ngf_tpu/train/loop.py:284-311`): at
        construction and at every shrink and upsample."""
        a = self.args
        decay_iters = a.lr_decay_iters if a.lr_decay_iters > 0 else a.n_iters
        self.optimizer = TriPlaneOptimizer(
            self.params, a.lr_init, a.lr_basis, a.lr_decay_target_ratio, decay_iters
        )

    def _effective_sample_cap(self) -> int:
        """``sample_cap = -1`` (auto) is ``open_sample_cap`` before the first
        occupancy grid, then ``masked_sample_cap`` when set, else the
        capacity the mask event measured (`ngf_tpu/train/loop.py:313-326`)."""
        if self.args.sample_cap != -1:
            return self.args.sample_cap
        if self.alpha is None and self._auto_cap is None:
            return self.args.open_sample_cap
        if self.args.masked_sample_cap > 0:
            return self.args.masked_sample_cap
        return self._auto_cap or 0

    def _resolve_rgb_cap(self) -> int:
        """The shading capacity of ``rgb_cap`` (`ngf_tpu/train/loop.py:328-343`):
        0 dense; K > 0 as it is; -1 ``max(32, cap // 4)`` of the effective
        sample capacity (dense without one); -2 the measured capacity, 0
        (dense) until the first measurement."""
        a = self.args.rgb_cap
        cap = self._effective_sample_cap()
        if a == -1 and cap:
            return max(32, cap // 4)
        if a == -2:
            return self._auto_rgb_cap
        return max(0, a)

    def _update_auto_rgb_cap(self, rec: dict) -> None:
        """With ``rgb_cap`` -2, pick the shading capacity from the shaded
        groups measured since the last pick, at a mask or upsample event
        (`ngf_tpu/train/loop.py:345-366`): ``(ceil(1.25 stat) + 1) G``, then
        reset the statistic's window. Records it in the event's ``rec``."""
        if self.args.rgb_cap != -2:
            return
        stat = int(self.rgb_stat.item())
        if stat <= 0:
            return
        kg = int(np.ceil(stat * 1.25)) + 1
        self._auto_rgb_cap = kg * max(1, self.args.group_size)
        self.rgb_stat = torch.zeros((), dtype=torch.int32, device=self.device)
        rec["rgb_stat"], rec["auto_rgb_cap"] = stat, self._auto_rgb_cap
        print(f"[trainer] auto rgb_cap -> {self._auto_rgb_cap} "
              f"(~p99.9 shaded groups + margin, per-stage window)")

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
            run_len=self.args.run_len,
            tile_q=self.args.tile_q,
            fused_fetch=bool(self.args.fused_fetch),
            pair_gather=bool(self.args.pair_gather),
            duo_bwd=bool(self.args.duo_bwd),
        )

    def _sp_render_cfg(self) -> RenderConfig:
        """The sample-parallel step's configuration: dense, with n_samples
        padded to a multiple of the sample axis (`ngf_tpu/train/loop.py:411-420`)."""
        rcfg = self._render_cfg()
        n_sp = self.mesh.n_sample
        return dataclasses.replace(rcfg, sample_cap=0, rgb_cap=0, group_size=0, mask_stride=1,
                                   n_samples=-(-rcfg.n_samples // n_sp) * n_sp)

    def _alpha_kw(self) -> dict:
        if self.alpha is None:
            return {}
        return {"alpha_volume": self.alpha.occ, "alpha_aabb": self.alpha.aabb}

    def _rows(self, n: int) -> tuple[int, int] | None:
        """Under a mesh, the rows of a microbatch chunk of the global batch
        that this rank's ``n`` rays are (:func:`render_rays`' ``rows``)."""
        if self.mesh is None:
            return None
        return self.mesh.data_index * n, self.mesh.n_data * n

    # ------------------------------------------------------------------ step

    @float32_accumulation()
    def loss_fn(self, rays, rgbs, generator=None, sample_fn=None):
        """MSE + L1 (+ TV) of one batch (`ngf_tpu/train/loop.py:444-482`).
        Returns (loss, mse). Under a mesh: the MSE of this rank's rays, and
        L1 and TV only on the ranks of sample index 0, so that the world's
        sum of the gradients counts them once."""
        rows = self._rows(rays.shape[0])
        if self._sample_parallel:
            out = render_rays_sp(
                self.params, self.model_cfg, self._sp_render_cfg(), rays, self.mesh,
                iteration=self.iteration, generator=generator, rows=rows,
            )
        else:
            out = render_rays(
                self.params, self.model_cfg, self._render_cfg(), rays,
                iteration=self.iteration, sample_fn=sample_fn, generator=generator, rows=rows,
                front_stream=self._front_stream, **self._alpha_kw(),
            )
        mse = ((out["rgb_map"] - rgbs) ** 2).mean()
        cnt = out.get("shaded_groups")
        if cnt is not None:
            # ~p99.9 of the batch: the 5th-largest per-ray count.
            k = min(5, cnt.shape[0])
            top = torch.topk(cnt, k).values
            if self.mesh is None:
                self.rgb_stat = torch.maximum(self.rgb_stat, top[k - 1])
            else:
                self._stat_parts.append((top, cnt.shape[0]))
        if self.mesh is not None and self.mesh.sample_index != 0:
            return mse, mse
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

    @float32_accumulation()
    def compute_grads(self, rays, rgbs, generator=None, sample_fn=None) -> torch.Tensor:
        """Gradients of one batch into the parameters' ``.grad``, averaged
        over ``microbatch`` equal chunks whose backward runs before the next
        chunk's forward (`ngf_tpu/train/loop.py:486-519`). Returns the MSE
        (a device scalar)."""
        micro = max(1, self.args.microbatch)
        with annotate("ngf.optimizer"):
            self.optimizer.zero_grad()
        mse_sum = torch.zeros((), device=rays.device)
        for r, g in zip(rays.chunk(micro), rgbs.chunk(micro)):
            with annotate("ngf.forward"):
                loss, mse = self.loss_fn(r, g, generator, sample_fn)
            with annotate("ngf.backward"):
                loss.backward()
            mse_sum = mse_sum + mse.detach()
        if micro > 1:
            for _, p in named_leaves(self.params):
                if p.grad is not None:
                    p.grad.div_(micro)
        return mse_sum / micro

    def train_step(self, rays, rgbs, generator=None, sample_fn=None) -> torch.Tensor:
        """One optimizer step on a batch (`one_step`,
        `ngf_tpu/train/loop.py:486-523`); returns the MSE as a device scalar
        (under a mesh the global batch's, on every rank)."""
        mse = self.compute_grads(rays, rgbs, generator, sample_fn)
        if self.mesh is not None:
            mse = self._reduce_step(mse)
        with annotate("ngf.optimizer"):
            self.optimizer.step()
        self.iteration += 1
        return mse

    def _reduce_step(self, mse: torch.Tensor) -> torch.Tensor:
        """The step's one all-reduce under a mesh: the gradients, the MSE
        and each microbatch chunk's top shaded-group counts in one flat
        buffer, summed over the world. The gradients are then divided by the
        data axis's size (the sample ranks' add up to their rays'
        gradient), the MSE by the world's (the global batch's mean), and the
        running ``rgb_stat`` takes each chunk's 5th-largest count over the
        data ranks' union. Returns the global MSE."""
        mesh = self.mesh
        leaves = [p for _, p in named_leaves(self.params) if p.grad is not None]
        parts, self._stat_parts = self._stat_parts, []
        slots = torch.full((len(parts), mesh.size, 5), 0.0, device=self.device)
        for i, (top, _) in enumerate(parts):
            slots[i, mesh.rank] = -1.0
            slots[i, mesh.rank, :top.numel()] = top.to(torch.float32)
        flat = torch.cat([p.grad.reshape(-1) for p in leaves]
                         + [mse.reshape(1).to(torch.float32), slots.reshape(-1)])
        torch.distributed.all_reduce(flat)
        sizes = [p.numel() for p in leaves]
        n_grad = sum(sizes)
        flat[:n_grad].div_(mesh.n_data)
        for p, g in zip(leaves, flat[:n_grad].split(sizes)):
            p.grad.copy_(g.view_as(p.grad))
        for chunk, (_, n) in zip(flat[n_grad + 1:].view(len(parts), mesh.size * 5), parts):
            k = min(5, n * mesh.n_data)
            self.rgb_stat = torch.maximum(
                self.rgb_stat, torch.topk(chunk, k).values[k - 1].to(torch.int32))
        return flat[n_grad] / mesh.size

    def next_batch(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(rays (B, 6), rgbs (B, 3)) at the sampler's next ids: one row
        gather of the device-resident table at ids already on the device
        (`ngf_tpu/train/loop.py:1438-1451`). Both are views of one (B, 9)
        tensor. Under a mesh: this rank's rows of the global batch, its
        data slice of each microbatch chunk."""
        ids = self.sampler.nextids()
        if self.mesh is not None:
            micro = max(1, self.args.microbatch)
            ids = shard_batch(self.mesh, ids.view(micro, -1).t()).t().reshape(-1)
        rows = gather_rows(self.batch_table, ids)
        return rows[:, :6], rows[:, 6:]

    # ----------------------------------------------------------------- events

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _event_update_alpha_mask(self, first: bool) -> dict:
        """The mask event (`ngf_tpu/train/loop.py:1274-1351`,
        `InfoInv/main.py:320-332`, `TriPlane/main.py:329-343`): the occupancy
        grid at ``alpha_grid_res`` cubed, pre-culled by the previous grid at
        later events; on the first, the L1 weight drops to
        ``L1_weight_rest``, the learned gauge shrinks its box and planes to
        the occupied voxels (:meth:`_event_shrink`), and the training rays
        are filtered to those touching occupied space, with a new sampler
        from ``seed`` over them (the set stays when none would be kept); then
        the measured sample capacity when ``sample_cap`` is -1. Returns the
        event's record, also appended to ``self.events``."""
        a = self.args
        t = {"start": time.time()}
        near, far = (float(v) for v in self.train_dataset.near_far)
        r = a.alpha_grid_res
        self.alpha, new_aabb = update_alpha_mask(
            self.params, self.model_cfg, self.aabb,
            # The occupancy threshold's length (`ngf_tpu/train/loop.py:1284-1287`).
            a.alpha_mask_len or self.step_size,
            grid_size=(r, r, r), alpha_thres=a.alpha_mask_thre, prev=self.alpha,
            device=self.device,
        )
        self._sync()
        t["grid"] = time.time()
        rec = {"kind": "mask", "iteration": self.iteration, "first": first,
               "voxels": int(self.alpha.occ.sum().item()), "grid_voxels": r ** 3,
               "new_aabb": new_aabb.tolist(), "rays_before": int(self.batch_table.shape[0]),
               "refiltered": False}
        if first:
            self.l1_weight = a.L1_weight_rest
            if a.subsystem == "triplane":
                rec["shrink"] = self._event_shrink(new_aabb)
                self._sync()
                t["shrink"] = time.time()
            keep = filter_rays_alpha(self.all_rays, self.alpha, self.aabb, near, far, self.step_size)
            ids = keep.nonzero().squeeze(1)
            if ids.numel():
                self._set_table(gather_rows(self.batch_table, ids))
                self._ray_ids = self._ray_ids[ids.cpu().numpy()]
                self.sampler = DeviceSampler(ids.numel(), a.batch_size, a.seed, self.device)
                self._sampler_birth = self.iteration
                rec["refiltered"] = True
            else:
                # Degenerate occupancy: keep the training set (`loop.py:1320-1323`).
                print("[trainer] alpha-mask ray filter kept 0 rays; skipping filter")
        rec["rays_kept"] = int(self.batch_table.shape[0])
        self._sync()
        t["filter"] = time.time()
        self._measure_sample_cap(rec, "p99.9 occupied samples/ray")
        t["counts"] = time.time()
        self._update_auto_rgb_cap(rec)
        rec["phases_s"] = self._event_phase_report("mask", t)
        self.events.append(rec)
        return rec

    def _measure_sample_cap(self, rec: dict, why: str) -> None:
        """With ``sample_cap`` -1, the capacity measured at the current box,
        step and sample count (`ngf_tpu/train/loop.py:1326-1335,1393-1407`);
        records it, the sample count and, on the grouped path, the groups
        kept a ray."""
        a = self.args
        if a.sample_cap == -1:
            near, far = (float(v) for v in self.train_dataset.near_far)
            counts = occupied_samples_per_ray(
                self.all_rays, self.alpha, self.aabb, near, far, self.step_size, self.n_samples
            )
            self._auto_cap = auto_sample_cap(counts, self.n_samples)
            rec["counted_rays"] = int(counts.size)
            print(f"[trainer] auto sample_cap -> {self._auto_cap} ({why})")
        cap = self._effective_sample_cap()
        rec["sample_cap"], rec["n_samples"] = cap, self.n_samples
        if a.group_size > 0:
            rec["capg"] = min(-(-self.n_samples // a.group_size),
                              -(-(cap or self.n_samples) // a.group_size))

    def _event_shrink(self, new_aabb: np.ndarray) -> dict:
        """The learned gauge's shrink at its first mask event
        (`ngf_tpu/train/loop.py:1353-1371`, `TriPlane/models/Field.py:117-132`):
        the planes cropped to the occupied voxels' box, the box, grid size and
        step set from it, the optimizer reset. The gauge grids are not
        cropped and ``n_samples`` stays, as in the reference. Returns what it
        set."""
        t_l, b_r = shrink_box_voxels(self.aabb, new_aabb, self.grid_size)
        self.params = _leaf_params(shrink_planes(self.params, t_l, b_r), self.device)
        self.aabb = np.asarray(new_aabb, np.float32)
        self.grid_size = [int(v) for v in (b_r - t_l)]
        self.step_size = grid_step_size(self.aabb, self.grid_size, self.args.step_ratio)
        self._make_optimizer()
        return {"t_l": t_l.tolist(), "b_r": b_r.tolist(), "aabb": self.aabb.tolist(),
                "grid_size": self.grid_size, "step_size": self.step_size}

    def _event_upsample(self) -> dict | None:
        """The learned gauge's upsample event (`ngf_tpu/train/loop.py:1373-1414`,
        `TriPlane/main.py:345-357`): the next voxel count of the schedule
        gives the resolution, the sample count and the step; the planes are
        resized to it, the optimizer reset with its decay restarted, and the
        capacity measured again at the new step. None once the schedule is
        spent. Returns the event's record, also appended to ``self.events``."""
        if not self.n_voxel_list:
            return None
        a = self.args
        t = {"start": time.time()}
        self.reso_cur = n_to_reso(self.n_voxel_list.pop(0), self.aabb)
        self.n_samples = min(a.nSamples, cal_n_samples(self.reso_cur, a.step_ratio))
        self.params = _leaf_params(upsample_planes(self.params, self.reso_cur), self.device)
        self._sync()
        t["resize"] = time.time()
        self.grid_size = list(self.reso_cur)
        self.step_size = grid_step_size(self.aabb, self.grid_size, a.step_ratio)
        self._check_marching_coverage(f"upsample@{self.iteration}")
        self._make_optimizer()
        rec = {"kind": "upsample", "iteration": self.iteration, "grid_size": self.grid_size,
               "step_size": self.step_size,
               "plane_shapes": [list(self.params[n].shape) for n in _PLANES]}
        if self.alpha is not None:
            self._measure_sample_cap(rec, "re-measured at upsampled step size")
        t["counts"] = time.time()
        self._update_auto_rgb_cap(rec)
        rec["phases_s"] = self._event_phase_report("upsample", t)
        self.events.append(rec)
        return rec

    def _event_phase_report(self, kind: str, t: dict) -> dict:
        """Print the event's phases in seconds, successive timestamps, and
        write them to ``scalars.jsonl`` as ``event/<kind>_<phase>_s``
        (`ngf_tpu/train/loop.py:1416-1434`); returns them."""
        parts, prev = {}, t["start"]
        for k, v in t.items():
            if k != "start":
                parts[k] = v - prev
                prev = v
        print(f"[trainer] {kind} event @{self.iteration}: "
              + " ".join(f"{k} {v:.2f}s" for k, v in parts.items()), flush=True)
        if self._scalars is not None:
            self._scalars.write(self.iteration,
                                {f"event/{kind}_{k}_s": round(v, 2) for k, v in parts.items()})
        return parts

    # ------------------------------------------------------------------ run

    def _on_sigterm(self, signum, frame) -> None:
        self._term_seen = True
        if self.mesh is None:
            self._stop_requested = True
        print("[trainer] SIGTERM: will checkpoint and exit after this step"
              + (" (once the ranks agree)" if self.mesh is not None else ""), flush=True)

    def _agree_stop(self, agree_now: bool) -> None:
        """Under a mesh, the stop every rank takes: at the steps where
        every rank meets (``agree_now``: log steps and events), if any rank
        has seen SIGTERM. (Alone, the handler stops the run itself.)"""
        if self.mesh is not None and agree_now and not self._stop_requested:
            self._stop_requested = collectives.any_rank(self._term_seen)

    def _barrier(self) -> None:
        if self.mesh is not None:
            torch.distributed.barrier()

    @float32_accumulation()
    def run(self, progress_cb=None) -> dict:
        """Train to ``n_iters`` with logs, ``scalars.jsonl``, periodic
        evaluation, mask events and checkpoints, then save ``model.npz``
        (`ngf_tpu/train/loop.py:1495-1645`). At an iteration with both, the
        evaluation runs before the events, the mask event before the
        upsample, and the events before the checkpoint, as in the JAX
        trainer. ``save_every`` saves are written off the loop
        (:meth:`save` with ``background=True``); the final save waits for
        them. With a logfolder, SIGTERM (installed from the main thread,
        the previous handler restored on return) finishes the current step
        and its events, saves ``model.npz`` synchronously and returns with
        ``preempted`` True. ``progress_cb(iteration, mse)`` is called after
        every step, with the last MSE read back from the device. Under a
        mesh every rank runs it; rank 0 writes and the others meet it at a
        barrier after each evaluation and save."""
        args = self.args
        log_path = None
        if self.logfolder:
            os.makedirs(os.path.join(self.logfolder, "imgs_vis"), exist_ok=True)
            log_path = os.path.join(self.logfolder, "log.txt")
            self._scalars = ScalarWriter(self.logfolder)
        scalars = self._scalars
        psnrs_test = [0.0]
        # MSEs stay device scalars until a log needs them, so the host does
        # not wait for the card after every step.
        pending: list[torch.Tensor] = []
        mses: list[float] = []
        masks = args.update_AlphaMask_list or []
        ups = (args.upsamp_list or []) if args.subsystem == "triplane" else []
        # The stages between events: steps and seconds on the host clock,
        # from the end of one stage's events to the start of the next's
        # (logs included, evaluations and events not).
        stages: list[dict] = []
        t0 = stage_t = time.time()
        stage_it = self.iteration
        self._term_seen = self._stop_requested = False
        prev_term = None
        # On a card each step's batch and packed front end run on a second
        # stream, so that the host's one read a step (the kept-group count)
        # waits for them alone while the card still runs the previous
        # step's backward and update. That stream waits for this one before
        # the first step and after each event: the batch table, the ids and
        # the occupancy volume it reads are written here.
        front = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._front_stream, fence = front, True
        if self._shared_io:
            try:
                prev_term = signal.signal(signal.SIGTERM, self._on_sigterm)
            except ValueError:  # not the main thread: no drain
                pass
        try:
            # A span around the steps (`chip_smoke.py` counts the
            # host-to-device copies inside it), and one a step.
            with annotate("train_loop"):
                while self.iteration < args.n_iters and not self._stop_requested:
                    with annotate("ngf.step", self.iteration + 1):
                        if fence and front is not None:
                            front.wait_stream(torch.cuda.current_stream(self.device))
                        with torch.cuda.stream(front):
                            with annotate("ngf.batch"):
                                batch = self.next_batch()
                        if front is not None:
                            join_stream(front, batch)
                        pending.append(self.train_step(*batch, self.gen))
                        it = self.iteration
                        event = it in masks or it in ups
                        fence = event
                        self._agree_stop(it % args.progress_refresh_rate == 0 or event)
                        boundary = it == args.n_iters or event or self._stop_requested
                        if boundary:
                            self._sync()
                            stages.append({"from": stage_it, "to": it, "s": time.time() - stage_t})
                        log_now = log_path is not None and it % args.progress_refresh_rate == 0
                        vis_now = (
                            args.N_vis != 0 and args.vis_every > 0 and it % args.vis_every == 0
                            and self.test_dataset is not None and self._shared_io
                        )
                        if log_now or (vis_now and self.logfolder):
                            with annotate("ngf.log"):
                                mses += torch.stack(pending).tolist()
                                pending = []
                                if log_now:
                                    self._write_log(log_path, it, mses, psnrs_test)
                        if vis_now and self.logfolder:
                            psnrs_test = evaluation(
                                self.test_dataset, self.make_eval_render_fn(iteration=it),
                                os.path.join(self.logfolder, "imgs_vis"), n_vis=args.N_vis,
                                prtx=f"{it:06d}_", chunk=args.eval_chunk,
                                compute_extra_metrics=False, write_video=False,
                            ) or [0.0]
                            with open(log_path, "a") as f:
                                f.write(f"Iteration {it:05d}: test/psnr = "
                                        f"{float(np.mean(psnrs_test)):.2f}\n")
                            scalars.write(it, {"test/psnr": float(np.mean(psnrs_test))})
                        if vis_now:
                            self._barrier()
                        if it in masks:
                            # The first event is the first without a grid (`loop.py:1517-1521`).
                            with annotate("ngf.event"):
                                self._event_update_alpha_mask(first=self.alpha is None)
                        if it in ups:
                            with annotate("ngf.event"):
                                self._event_upsample()
                        save_now = args.save_every > 0 and it % args.save_every == 0
                        if save_now and it < args.n_iters and self._shared_io:
                            # The final save below covers n_iters.
                            if self.logfolder:
                                with annotate("ngf.save"):
                                    blocked = self.save(os.path.join(self.logfolder, "model.npz"),
                                                        background=True)
                                scalars.write(it, {"ckpt/blocked_s": round(blocked, 3)})
                            self._barrier()
                        if boundary:
                            self._sync()
                            stage_t, stage_it = time.time(), it
                        if progress_cb is not None:
                            progress_cb(it, mses[-1] if mses else None)
        finally:
            self._front_stream = None
            if prev_term is not None:
                signal.signal(signal.SIGTERM, prev_term)
        if pending:
            mses += torch.stack(pending).tolist()
        wall = time.time() - t0
        if self.logfolder:
            path = os.path.join(self.logfolder, "model.npz")
            with annotate("ngf.save"):
                self.save(path)
            if self._stop_requested:
                print(f"[trainer] preempted at iteration {self.iteration}; resumable checkpoint "
                      f"written to {path}", flush=True)
        if self._shared_io:
            self._barrier()
        return {
            "iterations": self.iteration,
            "wall_time_s": wall,
            "final_train_mse": mses[-1] if mses else None,
            "rays_per_sec": args.batch_size * len(mses) / max(wall, 1e-9),
            "train_mses": mses,
            "id_uploads": self.sampler.uploads,
            "events": self.events,
            "stages": stages,
            "shaded_groups_p999": int(self.rgb_stat.item()),
            "preempted": self._stop_requested,
        }

    def _write_log(self, log_path: str, it: int, mses: list[float],
                   psnrs_test: list[float]) -> None:
        """The log step's line in ``log.txt`` and its ``scalars.jsonl`` entry
        (the running ``rgb_stat`` read back)."""
        train_psnr = np.mean([mse2psnr(m) for m in mses[-50:]])
        with open(log_path, "a") as f:
            f.write(
                f"Iteration {it:05d}: train_psnr = {train_psnr:.2f}"
                f" test_psnr = {float(np.mean(psnrs_test)):.2f} mse = {mses[-1]:.6f}\n"
            )
        self._scalars.write(it, {"train/psnr": train_psnr, "train/mse": mses[-1],
                                 "train/l1_weight": self.l1_weight,
                                 "train/shaded_groups_p999": int(self.rgb_stat.item())})

    def make_eval_render_fn(self, iteration: int | None = None, full: bool = False):
        """Chunk renderer ``rays -> (rgb, depth)`` of the current weights and
        occupancy grid (`ngf_tpu/train/loop.py:1207-1270`). ``full=True`` is
        the final evaluation: the full geometry-derived sample count, no
        compaction (on the grouped path: every group)."""
        rcfg = self._render_cfg()
        if full:
            rcfg = dataclasses.replace(
                self._render_cfg(sample_cap=0),
                n_samples=grid_n_samples(self.aabb, self.step_size),
                rgb_cap=0,
            )
        it = self.args.n_iters + 1 if iteration is None else iteration
        params, model_cfg, device, alpha_kw = self.params, self.model_cfg, self.device, self._alpha_kw()

        @torch.inference_mode()
        @float32_accumulation()
        def render(rays):
            out = render_rays(params, model_cfg, rcfg, rays.to(device), iteration=it, **alpha_kw)
            return out["rgb_map"], out["depth_map"]

        return render

    @torch.no_grad()
    @float32_accumulation()
    def export_mesh(self, path: str, grid_size: int = 256, level: float = 0.005) -> dict:
        """Alpha grid -> marching-cubes PLY at ``path``
        (`ngf_tpu/train/loop.py:1647-1675`; the reference's ``--export_mesh``
        calls an undefined ``mesh()``): the ``grid_size``^3 lattice over the
        current box built on the device, alpha with the gauge at iteration
        -1 and no earlier grid, in chunks of 256 * 256 * 8 points (one K1
        launch each: 32 at 256^3), then ``convert_density_to_ply`` at
        ``level`` on the host. Returns the mesh's vertex and face counts and
        the seconds of the grid, the marching cubes and the write."""
        t0 = time.perf_counter()
        chunk = 256 * 256 * 8
        pts = dense_grid_points(self.aabb, (grid_size,) * 3, self.device).reshape(-1, 3)
        aabb = torch.as_tensor(self.aabb, device=self.device)
        alpha = torch.cat([
            compute_alpha_grid_chunk(self.params, self.model_cfg, pts[i:i + chunk], aabb,
                                     self.step_size)
            for i in range(0, pts.shape[0], chunk)
        ]).reshape((grid_size,) * 3).cpu().numpy()
        grid_s = time.perf_counter() - t0
        return {"grid_s": grid_s, **convert_density_to_ply(alpha, path, self.aabb, level=level)}

    def save(self, path: str, background: bool = False) -> float:
        """Write a resumable ``.npz`` checkpoint that `main_torch.py` and
        `ngf_tpu` read (`ngf_tpu/train/loop.py:1676-1734`): the parameters,
        the geometry, the occupancy mask, ``meta["resume"]`` and the
        ``extra/`` arrays (the optimizer's optax leaves, the JAX key, the
        kept rays' ids, the generator's state). ``background=True`` blocks
        only for the host snapshot and leaves the write to the background
        writer; otherwise the write in flight is waited for and the file
        written before returning. Returns the seconds the caller was
        blocked."""
        t0 = time.time()
        a = self.args
        meta = {
            "subsystem": a.subsystem,
            "model_cfg": dataclasses.asdict(self.model_cfg),
            "aabb": self.aabb.tolist(),
            "grid_size": self.grid_size,
            "step_size": self.step_size,
            "n_samples": self.n_samples,
            "near_far": [float(v) for v in self.train_dataset.near_far],
            "iteration": self.iteration,
            "resume": {
                "l1_weight": float(self.l1_weight),
                "auto_cap": None if self._auto_cap is None else int(self._auto_cap),
                "rgb_stat": int(self.rgb_stat.item()),
                "auto_rgb_cap": int(self._auto_rgb_cap),
                "n_voxel_list": list(self.n_voxel_list),
                "sampler_birth": self._sampler_birth,
                "generator_device": self.device.type,
            },
        }
        extra = {f"opt/{i:04d}": leaf for i, leaf in enumerate(self.optimizer.to_optax_leaves())}
        extra["key"] = _threefry_key(a.seed)
        extra["ray_ids"] = self._ray_ids
        extra["torch_generator"] = self.gen.get_state()
        alpha = self.alpha
        arrays = pack_checkpoint(self.params, meta,
                                 alpha_volume=None if alpha is None else alpha.volume,
                                 alpha_aabb=None if alpha is None else alpha.aabb,
                                 extra_arrays=extra)
        if background:
            self._ckpt_writer.submit(path, arrays)
        else:
            self._ckpt_writer.wait()
            write_arrays_atomic(path, arrays)
        return time.time() - t0

    @classmethod
    def from_checkpoint(
        cls,
        path: str,
        args: TrainArgs,
        train_dataset: RayDataset,
        test_dataset: RayDataset | None = None,
        logfolder: str | None = None,
        device: torch.device | str = "cuda",
        mesh: Mesh | None = None,
    ) -> "TriPlaneTrainer":
        """A trainer that continues the run that wrote ``path`` (by either
        package's :meth:`save`) under the same ``args``
        (`ngf_tpu/train/loop.py:1736-1785,147-225`): the iteration, box,
        grid, step, sample count, L1 weight, capacities, voxel schedule,
        occupancy grid, kept rays, sampler position, optimizer state and
        generator (a checkpoint of any world size, under any ``mesh``).
        Raises ValueError for a checkpoint without resume state, one of
        another subsystem, and optimizer leaves that do not fit."""
        params, meta, alpha_volume, alpha_aabb = load_checkpoint(path, device)
        extra = load_extra_arrays(path)
        if "resume" not in meta or "key" not in extra:
            raise ValueError(f"{path} has no training-resume state (params-only checkpoint): "
                             "re-save it with the current trainer or use --render_only")
        if meta["subsystem"] != args.subsystem:
            raise ValueError(f"checkpoint subsystem {meta['subsystem']!r} != configured "
                             f"{args.subsystem!r}")
        trainer = cls(args, train_dataset, test_dataset, logfolder, init_params=params,
                      device=device, mesh=mesh)
        trainer._restore(meta, extra, alpha_volume, alpha_aabb)
        return trainer

    def _restore(self, meta: dict, extra: dict, alpha_volume, alpha_aabb) -> None:
        """Set the training state a checkpoint carries
        (`ngf_tpu/train/loop.py:147-225`) over a freshly built trainer."""
        a, r = self.args, meta["resume"]
        self.iteration = int(meta["iteration"])
        self.aabb = np.asarray(meta["aabb"], np.float32)
        self.grid_size = [int(v) for v in meta["grid_size"]]
        self.reso_cur = list(self.grid_size)
        self.step_size = float(meta["step_size"])
        self.n_samples = int(meta["n_samples"])
        self.l1_weight = float(r["l1_weight"])
        self._auto_cap = None if r.get("auto_cap") is None else int(r["auto_cap"])
        self.rgb_stat = torch.tensor(int(r["rgb_stat"]), dtype=torch.int32, device=self.device)
        self._auto_rgb_cap = int(r["auto_rgb_cap"])
        self.n_voxel_list = [int(v) for v in r["n_voxel_list"]]
        self._sampler_birth = int(r["sampler_birth"])
        if alpha_volume is not None:
            self.alpha = AlphaGrid.from_volume(alpha_volume, alpha_aabb)
        # The kept rays: the dataset's rows at the checkpoint's ids, gathered
        # on the device; the sampler at the same point of its stream.
        self._ray_ids = np.asarray(extra["ray_ids"], np.int64)
        table = self._dataset_table()
        if self._ray_ids.size == 0 or not 0 <= self._ray_ids.min() <= self._ray_ids.max() < len(table):
            raise ValueError(f"the checkpoint's {self._ray_ids.size} ray ids do not index the "
                             f"dataset's {len(table)} rays: another dataset than the run's")
        table = torch.from_numpy(table).to(self.device)
        self._set_table(gather_rows(table, torch.from_numpy(self._ray_ids).to(self.device)))
        self.sampler = DeviceSampler(self._ray_ids.size, a.batch_size, a.seed, self.device)
        self.sampler.skip(self.iteration - self._sampler_birth)
        n_opt = sum(1 for k in extra if k.startswith("opt/"))
        self.optimizer.load_optax_leaves([extra[f"opt/{i:04d}"] for i in range(n_opt)])
        state = extra.get("torch_generator")
        if state is not None and r.get("generator_device") == self.device.type:
            self.gen.set_state(torch.from_numpy(np.ascontiguousarray(state, np.uint8)))
        else:
            self.gen.manual_seed(a.seed * 1_000_003 + self.iteration)
            print(f"[trainer] generator reseeded from (seed {a.seed}, iteration {self.iteration}): "
                  f"the checkpoint holds no {self.device.type} generator state", flush=True)


def _threefry_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as numpy: the uint32[2] threefry key."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


_PLANES = ("plane_xy", "plane_yz", "plane_xz")


def _leaf_params(tree, device):
    """A copy of the tree as float32 leaf tensors on ``device`` that
    require grad."""
    if isinstance(tree, dict):
        return {k: _leaf_params(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_leaf_params(v, device) for v in tree]
    return tree.detach().to(device=device, dtype=torch.float32, copy=True).requires_grad_(True)
