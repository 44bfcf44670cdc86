"""Training and rendering of the UV-Mapping (NeuTex) subsystem.

Port of `ngf_tpu/train/uv_loop.py:UVTrainer` (reference
`UV-Mapping/train.py:84-175`, `UV-Mapping/model/model.py:66-381`): one
view's sampled pixel batch a step; Adam (0.9, 0.999, 1e-8) in one group
over the subnetworks that are not frozen; the 'lambda', 'step' and
'plateau' learning-rate policies; colour, background-transmittance, origin
and inverse-mapping losses; full-image renders chunked by rays; whole-model
and per-subnetwork checkpoints.

Differences from the JAX trainer:
- PyTorch runs eagerly, one step at a time: ``train_block`` runs its items'
  steps in a Python loop (the JAX trainer fuses them into one ``lax.scan``),
  keeps the losses on the device and reads them once, at the block's end.
  For 'plateau' the block is still the controller's metric block: it
  updates once per call, from the block's mean colour loss.
- Draws come from a ``torch.Generator`` on the device (seeded with
  ``seed``): the segment jitter ``u`` and the template points, per step.
  ``train_block`` also takes them injected (``draws``), so a test can hand
  it the JAX trainer's.
- The whole-model checkpoint keeps the optimizer state in optax's leaf order
  (``extra/opt/<i>``, `convert.adam_to_optax_leaves`), so the JAX trainer
  resumes from the port's checkpoints and the port from the JAX one's. The
  generator's state goes under ``extra/torch_generator``; the JAX key
  (``extra/key``) has no meaning here, and a checkpoint without the
  generator's state (one the JAX trainer wrote) reseeds the generator from
  (seed, step).
- The 512-wide inverse network maps the samples back only when the
  inverse-mapping loss weighs more than 0, and ``render_view`` runs neither
  it nor the template (XLA drops that dead work in the JAX trainer).
- Products sum in float32 (no TF32, no bfloat16 reduction) while the steps
  and renders run (``utils.precision.float32_accumulation``).
- ``run`` is `UV-Mapping/train.py`'s loop (`uv_train.py`'s in the JAX
  package): blocks of at most ``steps_per_call`` steps between the print,
  test and save boundaries, each block's items sampled on the host and
  copied to the device at once, the logs, and SIGTERM's drain. The CLI and
  the benchmark train through it.
- Tracing (`utils/profiling.py`): per step the spans ``ngf.step`` (its id
  the step), ``ngf.forward`` (with ``neutex_forward``'s ``ngf.field``, its
  four networks and ``ngf.render.composite``), ``ngf.backward`` and
  ``ngf.optimizer`` (``zero_grad`` and Adam, two regions; a replayed
  step's rate too); per block ``ngf.batch`` (the items' sampling in
  ``run`` and their copy to the device; a replayed step's inputs copied
  into the graph's too) and ``ngf.log`` (the block's one read of the
  losses, and the log lines).
- On a card Adam is PyTorch's fused kernel (its rate and step counts on
  the card), and after the first ``GRAPH_WARMUP`` steps each step replays
  the captured eager step (forward, backward and update; the inputs copied
  into the graph's own), so that the host queues a block's steps in a few
  launches each and the device sets the pace at the dtu_train.sh shape;
  ``run`` samples a block's items while the block before it runs. The
  capture is split at the step's spans (`utils/profiling.py`'s
  ``capture``), and a traced replay opens them around their graphs: a
  traced step is the step that runs untraced. The kernels' launch counters
  count the host's launches: a capture's once, a replay's none. Under a
  mesh every step runs eager.
- Under a ``mesh`` (`ngf_tpu_torch/parallel/mesh.py`, a 'data' axis; the
  JAX trainer's GSPMD sharding of the ray axis with the parameters
  replicated, `ngf_tpu/train/uv_loop.py:173-190`) every rank is a process
  on one device with the whole parameters, started from rank 0's. Every
  rank holds the same global batch and draws the same jitter and template
  points (the same seed), and keeps its slice of the ray axis of the
  batch, the jitter and the transmittance target. Its losses are its part
  of the world's: the ray means (colour, background, inverse mapping) over
  its rays times its share of the rays, and the origin term, a sum over
  the template points every rank holds, times 1 / D, so that it counts
  once. One all-reduce a step sums the gradients and the losses; every
  rank applies the same update, so the parameters stay equal bit for bit,
  and the result is one device's on the global batch. Rank 0 writes the
  checkpoints; the others meet it at a barrier.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time

import numpy as np
import torch
import torch.distributed as dist

from ..convert import adam_from_optax_leaves, adam_to_optax_leaves, sorted_named_leaves
from ..data.dtu import get_rays_dir
from ..fields.neutex import (
    NeuTexConfig,
    init_neutex,
    neutex_forward,
    neutex_losses,
    template_random_points,
)
from ..parallel.collectives import broadcast_from_rank0
from ..parallel.mesh import Mesh
from ..utils.checkpoint import load_checkpoint, load_extra_arrays, save_checkpoint
from ..utils.device import resolve_device
from ..utils.precision import float32_accumulation
from ..utils.profiling import annotate, capture, replay
from ..utils.scalars import ScalarWriter

SUBNETWORKS = {
    # `Model.get_subnetworks` (`UV-Mapping/model/model.py:375-381`)
    "geometry": "net_geometry_decoder",
    "inverse": "inverse_network",
    "gauge": "gauge_network",
    "texture": "net_texture",
}
LR_POLICIES = ("lambda", "step", "plateau")
# Eager steps on a card before the first capture (lazy initialisations:
# cuBLAS handles and workspaces, the fused update's state).
GRAPH_WARMUP = 3


def lambda_lr(step: int, niter: int, niter_decay: int) -> float:
    """'lambda' policy (`ngf_tpu/train/uv_loop.py:45-48`): constant through
    ``niter``, then linear decay over ``niter_decay``."""
    return 1.0 - max(0, step - niter) / float(niter_decay + 1)


def step_lr(step: int, decay_iters: int) -> float:
    """'step' policy (`ngf_tpu/train/uv_loop.py:51-53`): x0.1 every decay_iters."""
    return 0.1 ** (step // decay_iters)


class UVTrainer:
    """Owns the NeuTex parameters, the optimizer and the generator."""

    def __init__(
        self,
        cfg: NeuTexConfig,
        dataset=None,
        lr: float = 1e-4,
        niter: int = 500_000,
        niter_decay: int = 0,
        loss_weights: dict[str, float] | None = None,
        seed: int = 0,
        save_dir: str | None = None,
        freeze: list[str] | None = None,
        lr_policy: str = "lambda",
        lr_decay_iters: int = 50,
        device: torch.device | str = "cuda",
        mesh: Mesh | None = None,
    ):
        """``device`` 'cuda' (the default) raises without a card; 'cpu'
        runs K5's plain version. ``mesh``: a 1-D data mesh whose ranks
        split each step's rays (module docstring)."""
        if lr_policy not in LR_POLICIES:
            raise NotImplementedError(f"lr policy {lr_policy!r}")
        if mesh is not None and mesh.n_sample != 1:
            raise ValueError(f"the UV trainer splits rays over a 'data' mesh; got {mesh.shape}")
        self.mesh = mesh
        self.cfg = cfg
        self.dataset = dataset
        self.save_dir = save_dir
        self.loss_weights = dict(loss_weights or {
            "color": 1.0, "bg": 1.0, "origin": 1.0, "inverse_mapping": 0.0
        })
        self.lr, self.niter, self.niter_decay = lr, niter, niter_decay
        self.lr_policy, self.lr_decay_iters = lr_policy, lr_decay_iters
        self.seed = seed
        self.device = resolve_device(str(device))
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = init_neutex(cfg, self.gen)
        self.step_count = 0
        # The working ReduceLROnPlateau of `ngf_tpu/train/uv_loop.py:101-110,197-208`.
        self._plateau = ({"best": float("inf"), "bad": 0, "mult": 1.0}
                         if lr_policy == "plateau" else None)

        # Frozen subnetworks (`BaseModel.freeze_subnetworks`) take no
        # gradient, no moments and no update, as optax.set_to_zero.
        frozen = {SUBNETWORKS[f] for f in (freeze or [])}
        self.trainable = [t for path, t in sorted_named_leaves(self.params)
                          if path.split("/")[0] not in frozen]
        for t in self.trainable:
            t.requires_grad_(True)
        # On a card the update is one fused kernel over every leaf, its rate
        # a device tensor, so that a step can be captured in a CUDA graph.
        cuda = self.device.type == "cuda"
        self.adam = torch.optim.Adam(
            self.trainable, lr=torch.tensor(lr, device=self.device) if cuda else lr,
            betas=(0.9, 0.999), eps=1e-8, fused=cuda, capturable=cuda)
        # A card's steps after the first GRAPH_WARMUP replay the captured
        # step (:meth:`_graph_step`), except under a mesh.
        self._graph: dict | None = None
        self._eager_steps = 0
        self.schedule_count = 0
        self._broadcast_params()

    def _broadcast_params(self) -> None:
        """Under a mesh every rank takes rank 0's parameters."""
        if self.mesh is not None:
            broadcast_from_rank0(t for _, t in sorted_named_leaves(self.params))

    def _barrier(self) -> None:
        if self.mesh is not None:
            dist.barrier()

    # ---------------------------------------------------------------- steps

    def _schedule(self, count: int) -> float:
        if self.lr_policy == "lambda":
            return lambda_lr(count, self.niter, self.niter_decay)
        if self.lr_policy == "step":
            return step_lr(count, self.lr_decay_iters)
        return 1.0

    def _plateau_update(self, color_loss: float) -> None:
        """mode min, factor 0.2, relative threshold 0.01, patience 5, per
        metric block (`ngf_tpu/train/uv_loop.py:197-208`)."""
        st = self._plateau
        if color_loss < st["best"] * (1.0 - 0.01):
            st["best"] = color_loss
            st["bad"] = 0
        else:
            st["bad"] += 1
            if st["bad"] > 5:
                st["mult"] *= 0.2
                st["bad"] = 0

    def _draw_one(self, B: int, R: int) -> dict[str, torch.Tensor]:
        u = torch.rand((B, R, self.cfg.sample_num), generator=self.gen, device=self.device)
        tmpl = template_random_points(self.cfg, self.cfg.points_per_primitive, self.gen)
        return {"u": u, "template": tmpl}

    def _step(self, campos, raydir, gt, bg, trans, u, template) -> dict[str, torch.Tensor]:
        if self.device.type == "cuda" and self.mesh is None:
            if self._eager_steps >= GRAPH_WARMUP:
                return self._graph_step(campos, raydir, gt, bg, trans, u, template)
            self._eager_steps += 1
        return self._eager_step(campos, raydir, gt, bg, trans, u, template)

    def _eager_step(self, campos, raydir, gt, bg, trans, u, template) -> dict[str, torch.Tensor]:
        weights = self.loss_weights
        mesh = self.mesh
        if mesh is not None:
            # This rank's rays of the global batch, its jitter and targets.
            r, d = raydir.shape[1], mesh.n_data
            if r % d:
                raise ValueError(f"{r} rays a step do not split over {d} data ranks")
            rows = slice(mesh.data_index * (r // d), (mesh.data_index + 1) * (r // d))
            raydir, gt, u = raydir[:, rows], gt[:, rows], u[:, rows]
            trans = None if trans is None else trans[:, rows]
        with annotate("ngf.forward"):
            out = neutex_forward(self.params, self.cfg, campos, raydir, bg, u=u, template=template,
                                 inverse=weights.get("inverse_mapping", 0) > 0)
            total, losses = neutex_losses(out, gt, trans, weights)
            if mesh is not None:
                # Every term times 1 / D: each ray mean by this rank's share of
                # the rays, and origin, which every rank computes whole, once
                # over the world.
                total = total / mesh.n_data
                losses = {k: v / mesh.n_data for k, v in losses.items()}
        with annotate("ngf.optimizer"):
            if not self._capturing():
                self.adam.zero_grad(set_to_none=True)
        with annotate("ngf.backward"):
            total.backward()
        if mesh is not None:
            losses = self._reduce_step(losses)
        with annotate("ngf.optimizer"):
            self._apply_update()
        # Detached, so that nothing keeps the step's autograd graph (and the
        # parameters' gradient accumulators on its stream) alive after it.
        return {k: v.detach() for k, v in losses.items()}

    def _reduce_step(self, losses: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The step's one all-reduce under a mesh: the gradients and the
        losses in one flat buffer, summed over the data ranks. Returns the
        world's losses."""
        leaves = [t for t in self.trainable if t.grad is not None]
        names = list(losses)
        flat = torch.cat([t.grad.reshape(-1) for t in leaves]
                         + [torch.stack([losses[k].detach().float() for k in names])])
        dist.all_reduce(flat, group=self.mesh.data_group)
        sizes = [t.numel() for t in leaves]
        for t, g in zip(leaves, flat[:sum(sizes)].split(sizes)):
            t.grad.copy_(g.view_as(t.grad))
        return dict(zip(names, flat[sum(sizes):]))

    def _capturing(self) -> bool:
        return self.device.type == "cuda" and torch.cuda.is_current_stream_capturing()

    def _set_rate(self) -> None:
        """``lr`` times the schedule at the update count times the plateau
        multiplier (optax: ``scale_by_adam``, then ``scale_by_schedule`` from
        count 0), into the optimizer's rate: in place on a card, where a
        captured update reads it."""
        mult = self._plateau["mult"] if self._plateau is not None else 1.0
        rate = self.lr * self._schedule(self.schedule_count) * mult
        for g in self.adam.param_groups:
            if torch.is_tensor(g["lr"]):
                g["lr"].fill_(rate)
            else:
                g["lr"] = rate

    def _apply_update(self) -> None:
        """One Adam update from the gradients in ``.grad`` (a captured one
        reads the rate that :meth:`_graph_step` sets before each replay)."""
        if not self._capturing():
            self._set_rate()
        self.adam.step()
        self.schedule_count += 1

    def _graph_step(self, campos, raydir, gt, bg, trans, u, template) -> dict[str, torch.Tensor]:
        """One step as a replay of the captured step: the inputs copied into
        the graph's own, the rate set, then forward, backward and the fused
        update in one graph for each stretch between the step's spans. The
        capture (at the first step of a new shape, or after
        :meth:`load_networks`) records the eager step's kernels, which the
        replays run again on the same memory."""
        inputs = (campos, raydir, gt, bg, trans, u, template)
        key = tuple(None if t is None else (tuple(t.shape), t.dtype) for t in inputs)
        graph = self._graph
        if graph is None or graph["key"] != key:
            graph = self._graph = self._capture(inputs, key)
        with annotate("ngf.batch"):
            for mine, t in zip(graph["inputs"], inputs):
                if t is not None:
                    mine.copy_(t)
        with annotate("ngf.optimizer"):
            self._set_rate()
        replay(graph["program"])
        self.schedule_count += 1
        row = graph["row"].clone()
        return {k: row[i] for i, k in enumerate(graph["names"])}

    def _capture(self, inputs: tuple, key: tuple) -> dict:
        mine = tuple(None if t is None else t.clone() for t in inputs)
        self.adam.zero_grad(set_to_none=True)
        schedule_count = self.schedule_count
        with capture() as program:
            losses = self._eager_step(*mine)
            names = list(losses)
            row = torch.stack([losses[k].detach() for k in names])
        self.schedule_count = schedule_count  # the capture ran no update
        return {"program": program, "key": key, "inputs": mine, "names": names, "row": row}

    def _load_block(self, items: list[dict[str, np.ndarray]]) -> dict:
        """A block's items stacked and copied to the device, one copy a field."""
        def stack(name):
            return torch.as_tensor(np.stack([it[name] for it in items])).to(self.device)

        return {"campos": stack("campos"), "raydir": stack("raydir"), "gt": stack("gt_image"),
                "bg": stack("background_color"),
                "trans": stack("transmittance") if "transmittance" in items[0] else None}

    def train_block(self, items: list[dict[str, np.ndarray]], draws: list[dict] | None = None,
                    progress_cb=None) -> dict[str, np.ndarray]:
        """``len(items)`` optimizer steps, one item (a view's pixel batch,
        `data.dtu`'s ``get_item``) each. ``draws``: per step ``u`` (B, R, S)
        and ``template`` (P, uv_dim), arrays or tensors, or None to draw them
        from the generator. ``progress_cb(step)`` is called after each
        step's update, with the step's number. Returns each loss per step,
        (T,) numpy arrays, read from the device once."""
        with annotate("ngf.batch"):
            batch = self._load_block(items)
        return self._read_block(*self._launch_block(batch, len(items), draws, progress_cb))

    @float32_accumulation()
    def _launch_block(self, batch: dict, n: int, draws: list[dict] | None, progress_cb):
        """The block's steps, queued on the device; returns each step's loss
        row (device tensors) and the losses' names."""
        dev = self.device
        raydir, trans = batch["raydir"], batch["trans"]
        rows, names = [], None
        for t in range(n):
            step = self.step_count + t + 1
            with annotate("ngf.step", step):
                # Each step's draws at its start: the generator's sequence is
                # a block's drawn at once (jitter, template, jitter, ...).
                d = draws[t] if draws is not None else self._draw_one(raydir.shape[1],
                                                                      raydir.shape[2])
                u = torch.as_tensor(d["u"], dtype=torch.float32, device=dev)
                tmpl = torch.as_tensor(d["template"], dtype=torch.float32, device=dev)
                losses = self._step(batch["campos"][t], raydir[t], batch["gt"][t], batch["bg"][t],
                                    None if trans is None else trans[t], u, tmpl)
                names = list(losses)
                rows.append(torch.stack([losses[k].detach() for k in names]))
            if progress_cb is not None:
                progress_cb(step)
        self.step_count += n
        return rows, names

    def _read_block(self, rows: list[torch.Tensor], names: list[str]) -> dict[str, np.ndarray]:
        """The block's one read of its losses (the 'plateau' policy's update
        from them)."""
        with annotate("ngf.log"):
            table = torch.stack(rows).cpu().numpy()
        out = {k: table[:, i] for i, k in enumerate(names)}
        if self._plateau is not None and "color" in out:
            self._plateau_update(float(out["color"].mean()))
        return out

    def train_step(self, item: dict[str, np.ndarray]) -> dict[str, float]:
        """One step on one item."""
        return {k: float(v[-1]) for k, v in self.train_block([item]).items()}

    def run(self, dataset=None, *, steps_per_call: int = 20, print_freq: int = 100,
            test_freq: int = 10000, save_iter_freq: int = 5000, start_step: int | None = None,
            test=None, progress_cb=None) -> dict:
        """Train from ``start_step`` (the step count by default) to ``niter +
        niter_decay`` (`UV-Mapping/train.py:84-175`): blocks of at most
        ``steps_per_call`` steps that end at each multiple of ``print_freq``,
        ``test_freq`` and ``save_iter_freq`` (0: none), each on items sampled
        from ``dataset`` (the trainer's by default) while the block before it
        runs on the device. At a print
        boundary the mean losses since the last one go to standard output,
        ``log.txt`` and ``scalars.jsonl`` in ``save_dir``; at a test boundary
        ``test(step)`` runs; at a save boundary the step's and ``latest``'s
        networks are saved. SIGTERM (installed from the main thread, the
        previous handler restored on return) finishes the running block;
        ``latest`` is saved at the end either way (with a ``save_dir``).
        ``progress_cb(step)`` is called after each optimizer step. Returns
        ``total_steps``, ``preempted`` and each loss of every step run,
        ``losses`` ((T,) numpy arrays)."""
        dataset = self.dataset if dataset is None else dataset
        total = self.step_count if start_step is None else start_step
        writes = self.save_dir is not None and (self.mesh is None or self.mesh.rank == 0)
        log_path = os.path.join(self.save_dir, "log.txt") if writes else None
        scalars = ScalarWriter(self.save_dir) if writes else None
        acc: dict[str, float] = {}
        n_acc = 0
        parts: dict[str, list[np.ndarray]] = {}
        t0 = time.time()

        # SIGTERM drains the running block, saves 'latest' and returns
        # (`uv_train.py:173-191`); a resume continues from it.
        stop = {"v": False}

        def on_term(signum, frame):
            stop["v"] = True
            print("[uv_train_torch] SIGTERM: will save 'latest' and exit at the next block "
                  "boundary", flush=True)

        try:
            prev_term = signal.signal(signal.SIGTERM, on_term)
        except ValueError:  # not the main thread
            prev_term = None

        end_step = self.niter + self.niter_decay

        def block_after(step: int) -> int:
            """Steps up to the next print/test/save boundary after ``step``,
            at most steps_per_call; 0 at the end or once SIGTERM came."""
            if step >= end_step or stop["v"]:
                return 0
            boundaries = [end_step]
            for freq in (print_freq, test_freq, save_iter_freq):
                if freq > 0:
                    boundaries.append(((step // freq) + 1) * freq)
            target = min(b for b in boundaries if b > step)
            return min(max(1, steps_per_call), target - step)

        def load(n: int) -> dict | None:
            if not n:
                return None
            with annotate("ngf.batch"):
                return self._load_block([dataset.sample() for _ in range(n)])

        try:
            block = block_after(total)
            batch = load(block)
            while block:
                rows, names = self._launch_block(batch, block, None, progress_cb)
                total += block
                # The next block's items are sampled on the host while the
                # device runs this block's steps, before its losses are read.
                nxt = block_after(total)
                batch = load(nxt)
                losses = self._read_block(rows, names)
                n_acc += block
                for k, v in losses.items():
                    acc[k] = acc.get(k, 0.0) + float(v.sum())
                    parts.setdefault(k, []).append(v)

                if print_freq > 0 and total % print_freq == 0:
                    with annotate("ngf.log"):
                        msg = (f"End of iteration {total} \t Number of batches {n_acc} "
                               f"\t Time taken: {time.time() - t0:.2f}s\n[Average Loss] "
                               + "   ".join(f"{k}: {v / n_acc:.10f}" for k, v in acc.items()))
                        if writes:
                            print(msg, flush=True)
                            with open(log_path, "a") as f:
                                f.write(msg + "\n")
                            scalars.write(total, {f"loss/{k}": v / n_acc for k, v in acc.items()})
                    acc, n_acc, t0 = {}, 0, time.time()

                if test is not None and test_freq > 0 and total % test_freq == 0:
                    test(total)

                if save_iter_freq > 0 and total % save_iter_freq == 0 and self.save_dir:
                    self.save_networks(total, {"total_steps": total})
                    self.save_networks("latest", {"total_steps": total})
                block = nxt if not stop["v"] else 0
        finally:
            if prev_term is not None:
                signal.signal(signal.SIGTERM, prev_term)

        if self.save_dir:
            self.save_networks("latest", {"total_steps": total})
        return {"total_steps": total, "preempted": stop["v"],
                "losses": {k: np.concatenate(v) for k, v in parts.items()}}

    # ------------------------------------------------------------- rendering

    @torch.no_grad()
    @float32_accumulation()
    def render_view(self, campos: np.ndarray, height: int, width: int, focal, rot, princpt,
                    chunk: int = 1024, edit_texture=None,
                    edit_mode: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """A full image chunked by rays (`ngf_tpu/train/uv_loop.py:247-292`):
        no jitter, a black background. Returns (rgb (H, W, 3), transmittance
        (H, W)) as numpy."""
        px, py = np.meshgrid(np.arange(width, dtype=np.float32),
                             np.arange(height, dtype=np.float32))
        raydir = get_rays_dir(np.stack([px, py], -1), focal, rot, princpt).reshape(-1, 3)
        raydir = torch.as_tensor(raydir.astype(np.float32), device=self.device)
        edit = (None if edit_texture is None
                else torch.as_tensor(np.asarray(edit_texture, np.float32), device=self.device))
        cam = torch.as_tensor(np.asarray(campos, np.float32)[None], device=self.device)
        bg = torch.zeros((1, 3), device=self.device)
        rgbs, trans = [], []
        for i in range(0, raydir.shape[0], chunk):
            out = neutex_forward(self.params, self.cfg, cam, raydir[None, i:i + chunk], bg,
                                 edit_texture=edit, edit_mode=edit_mode, inverse=False)
            rgbs.append(out["color"][0])
            trans.append(out["transmittance"][0])
        return (torch.cat(rgbs).reshape(height, width, 3).cpu().numpy(),
                torch.cat(trans).reshape(height, width).cpu().numpy())

    # ----------------------------------------------------------- checkpoints

    def save_networks(self, epoch: str | int, other_states: dict | None = None) -> None:
        """``{epoch}_net_NeuTex.npz`` (the parameters, the meta and the
        optimizer's optax leaves) and one ``{epoch}_subnet_<name>.npz`` a
        subnetwork (`ngf_tpu/train/uv_loop.py:326-357`); under a mesh rank
        0 writes and every rank meets at a barrier."""
        if self.save_dir is None:
            raise ValueError("save_networks needs a save_dir")
        if self.mesh is not None and self.mesh.rank != 0:
            self._barrier()
            return
        os.makedirs(self.save_dir, exist_ok=True)
        cfg = dataclasses.asdict(self.cfg)
        meta = {"cfg": cfg, "step": self.step_count, "plateau": self._plateau,
                **(other_states or {})}
        leaves = adam_to_optax_leaves(self.adam, self.trainable, self.schedule_count)
        extra = {f"opt/{i:04d}": leaf for i, leaf in enumerate(leaves)}
        extra["torch_generator"] = self.gen.get_state().numpy()
        save_checkpoint(os.path.join(self.save_dir, f"{epoch}_net_NeuTex.npz"), self.params,
                        meta, extra_arrays=extra)
        for friendly, name in SUBNETWORKS.items():
            save_checkpoint(os.path.join(self.save_dir, f"{epoch}_subnet_{friendly}.npz"),
                            self.params[name], {"cfg": cfg})
        self._barrier()

    def load_params(self, tree) -> None:
        """Set the parameters from a tree of arrays or tensors with the same
        names and shapes (a JAX package's ``init_neutex``, say), in place."""
        self._copy_params(self.params, tree)

    def _copy_params(self, dst, src) -> None:
        """Copy a tree of arrays into this trainer's tensors, in place (the
        optimizer keeps its references)."""
        src_leaves = dict(sorted_named_leaves(src))
        dst_leaves = dict(sorted_named_leaves(dst))
        if set(src_leaves) != set(dst_leaves):
            raise ValueError(f"checkpoint names differ: {sorted(set(src_leaves) ^ set(dst_leaves))}")
        with torch.no_grad():
            for k, t in dst_leaves.items():
                v = src_leaves[k]
                v = v.detach() if torch.is_tensor(v) else torch.as_tensor(np.array(v))
                if tuple(v.shape) != tuple(t.shape):
                    raise ValueError(f"{k}: checkpoint shape {tuple(v.shape)}, model {tuple(t.shape)}")
                t.copy_(v)

    def load_networks(self, epoch: str | int, resume_dir: str | None = None) -> dict:
        """Restore ``{epoch}_net_NeuTex.npz`` written by either package: the
        parameters, the step, the plateau state and, where its leaves fit
        this trainer's trainable parameters, the optimizer state (as the JAX
        trainer, `ngf_tpu/train/uv_loop.py:359-382`, which otherwise keeps
        its fresh state; this one says so)."""
        path = os.path.join(resume_dir or self.save_dir, f"{epoch}_net_NeuTex.npz")
        params, meta, _, _ = load_checkpoint(path, "cpu")
        self._copy_params(self.params, params)
        self.step_count = int(meta.get("step", 0))
        extra = load_extra_arrays(path)
        n_opt = sum(1 for k in extra if k.startswith("opt/"))
        try:
            self.schedule_count = adam_from_optax_leaves(
                self.adam, self.trainable, [extra[f"opt/{i:04d}"] for i in range(n_opt)])
            self._graph = None  # the captured update read the replaced state
        except (ValueError, KeyError) as e:
            print(f"{path}: optimizer state not restored ({e})")
        if "torch_generator" in extra:
            self.gen.set_state(torch.as_tensor(extra["torch_generator"], dtype=torch.uint8))
        else:
            self.gen.manual_seed(self.seed * 1_000_003 + self.step_count)
        if meta.get("plateau") and self._plateau is not None:
            self._plateau = dict(meta["plateau"])
        return meta

    def load_subnetworks(self, epoch: str | int, names: list[str],
                         resume_dir: str | None = None) -> None:
        """Warm-start subnetworks from ``{epoch}_subnet_<name>.npz``
        (`ngf_tpu/train/uv_loop.py:384-396`); a missing file is reported and
        skipped."""
        for friendly in names:
            path = os.path.join(resume_dir or self.save_dir, f"{epoch}_subnet_{friendly}.npz")
            if not os.path.isfile(path):
                print(f"cannot load {path}")
                continue
            sub, _, _, _ = load_checkpoint(path, "cpu")
            self._copy_params(self.params[SUBNETWORKS[friendly]], sub)

