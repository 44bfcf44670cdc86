#!/usr/bin/env python3
"""CLI of the PyTorch/CUDA port (`ngf_tpu_torch`), the counterpart of
`main.py`: training of both tri-plane subsystems (the staged recipes:
grouped renderer, occupancy mask events, and for the learned gauge its
shrink and upsample events), and render-only evaluation of a checkpoint.

    python main_torch.py --config configs/synthetic_infoinv_tpu.txt [--device cpu]
    python main_torch.py --config configs/synthetic_triplane_tpu.txt [--device cpu]
    python main_torch.py --config configs/lego_infoinv.txt \\
        --render_only 1 --render_test 1 --ckpt path/to/model.npz [--device cpu]

It reads the same ``configs/*.txt`` and writes and reads the same ``.npz``
checkpoints (with their occupancy mask) as `main.py`, and runs on the GPU
unless ``--device cpu`` is given. In training mode ``--ckpt`` resumes the
run that wrote the checkpoint (either package's), and SIGTERM stops a run
after its current step with a resumable ``model.npz`` and exit code 0.
``--dataset_name blender`` reads a Blender-format scene (``--datadir`` with
``transforms_{train,test}.json``). ``--compute_dtype bfloat16`` trains the
JAX package's bfloat16 recipe (float32 parameters and Adam, bfloat16 plane
values and decoders with float32 sums; ``model.npz`` keeps the float32
parameters). ``--rgb_cap`` K > 0, -1 or -2 trains with top-K shading (-2:
the capacity measured at each mask and upsample event), and ``--group_size
0 --mask_stride K`` queries the occupancy once a window of K samples, as in
`main.py`. ``--dataset_name`` takes every loader of `main.py`: ``synthetic``,
``blender``, ``llff`` (forward-facing, NDC rays, a spiral render path),
``nsvf``, ``tankstemple`` and ``own_data``. ``--export_mesh 1`` writes
``mesh.ply`` (marching cubes at alpha 0.005 over a 256^3 grid of the
trained field) after training. ``steps_per_call`` is read and has no
effect: PyTorch runs one step at a time.

Several ranks (one process each) train one model when the environment opts
in (`ngf_tpu_torch/parallel/mesh.py:maybe_initialize_distributed`): torchrun
with ``NGF_DISTRIBUTED=1``, or ``NGF_COORDINATOR=host:port
NGF_NUM_PROCESSES=N NGF_PROCESS_ID=i`` in each process::

    NGF_DISTRIBUTED=1 torchrun --nproc_per_node 8 main_torch.py \\
        --config configs/synthetic_infoinv_tpu.txt [--mesh_shape 4x2]

``--mesh_shape DxS`` trains on a D x S (data x sample) mesh (D * S must be
the number of ranks; a sample axis of more than one rank trains the dense
sample-parallel renderer); without it several ranks form a data mesh. Each
rank runs on ``cuda:LOCAL_RANK`` unless ``--device`` names a device (ranks
that share one card: ``--device cuda:0`` with ``NGF_DIST_BACKEND=gloo``;
``--device cpu`` trains over gloo on the CPU). Rank 0 writes the logs,
checkpoints and evaluations.
"""

from __future__ import annotations

import datetime
import json
import os
import sys

import numpy as np
import torch


def main(argv=None):
    from ngf_tpu_torch.config import config_parser
    from ngf_tpu_torch.utils.precision import float32_accumulation

    from ngf_tpu_torch.parallel import maybe_initialize_distributed

    args = config_parser(argv)
    maybe_initialize_distributed(device_type=torch.device(args.device).type)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)

    with float32_accumulation():
        if args.render_only and (args.render_test or args.render_path):
            return run_test(args)
        return run_train(args)


def _logfolder(args):
    if args.add_timestamp:
        stamp = datetime.datetime.now().strftime("-%Y%m%d-%H%M%S")
        return f"{args.basedir}/{args.expname}{stamp}"
    return f"{args.basedir}/{args.expname}"


def _rank_device(name: str):
    """The device of this rank: ``name`` as given, except a bare 'cuda'
    among several ranks, which is ``cuda:LOCAL_RANK``."""
    import torch.distributed as dist

    from ngf_tpu_torch.parallel import local_rank
    from ngf_tpu_torch.utils.device import resolve_device

    device = resolve_device(name)
    if device.type == "cuda" and device.index is None and dist.is_initialized():
        device = torch.device("cuda", local_rank())
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    return device


def make_training_mesh(mesh_shape: str):
    """The mesh of ``--mesh_shape DxS`` (`main.py:67-73`): ``make_mesh_2d(D,
    S)`` when D * S > 1, else none; without the flag a data mesh over every
    rank when there are several. D * S must be the number of ranks."""
    import torch.distributed as dist

    from ngf_tpu_torch.parallel import make_mesh, make_mesh_2d

    world = dist.get_world_size() if dist.is_initialized() else 1
    if mesh_shape:
        d, s = (int(v) for v in mesh_shape.lower().split("x"))
        if d * s != world:
            raise ValueError(f"--mesh_shape {mesh_shape} needs {d * s} ranks; this run has {world}")
        return make_mesh_2d(d, s) if d * s > 1 else None
    return make_mesh() if world > 1 else None


def run_train(args):
    """Train (InfoInv or the learned gauge), or resume the run that wrote
    ``--ckpt``, save ``model.npz``, then the final evaluations
    (`main.py:45-117`). With ``--export_mesh 1`` the trained field's
    ``mesh.ply`` is written before the evaluations (rank 0 alone), its
    record under ``export``. Returns the trainer's statistics with the test
    PSNRs under ``test_psnrs`` (empty when no test views were rendered). A run
    stopped by SIGTERM saves ``model.npz`` and returns before the final
    evaluations. Under a mesh only rank 0 runs the final evaluations; the
    other ranks return after training with no test PSNRs."""
    from ngf_tpu_torch.data import load_dataset
    from ngf_tpu_torch.render.evaluation import evaluation, evaluation_path
    from ngf_tpu_torch.train.loop import TriPlaneTrainer, check_ported

    check_ported(args)
    device = _rank_device(args.device)
    mesh = make_training_mesh(args.mesh_shape)

    train_dataset = load_dataset(
        args.dataset_name, args.datadir, split="train",
        downsample=args.downsample_train, is_stack=False,
    )
    test_dataset = load_dataset(
        args.dataset_name, args.datadir, split="test",
        downsample=args.downsample_test, is_stack=True,
    )
    logfolder = _logfolder(args)
    os.makedirs(logfolder, exist_ok=True)
    if args.ckpt:
        # --ckpt in training mode resumes the run that wrote it (`main.py:74-81`).
        trainer = TriPlaneTrainer.from_checkpoint(
            args.ckpt, args, train_dataset, test_dataset, logfolder, device=device, mesh=mesh
        )
        print(f"[trainer] resumed from {args.ckpt} at iteration {trainer.iteration}", flush=True)
    else:
        trainer = TriPlaneTrainer(args, train_dataset, test_dataset, logfolder, device=device,
                                  mesh=mesh)
    stats = trainer.run()
    print(f"training done: { {k: v for k, v in stats.items() if k != 'train_mses'} }")
    if stats["preempted"] or (mesh is not None and mesh.rank != 0):
        # Stopped by SIGTERM: the checkpoint is written; the evaluations
        # wait for the resumed run.
        return {**stats, "test_psnrs": []}

    if args.export_mesh:
        # The mesh of the trained field (`main.py:87-89`), rank 0 alone.
        path = os.path.join(logfolder, "mesh.ply")
        stats["export"] = trainer.export_mesh(path)
        print(f"mesh exported to {path}: {json.dumps(stats['export'])}", flush=True)

    # The final evaluations march the full geometry-derived sample count
    # with no compaction (`main.py:92-95`).
    render_fn = trainer.make_eval_render_fn(full=True)
    psnrs = []
    if args.render_train:
        train_stack = load_dataset(
            args.dataset_name, args.datadir, split="train",
            downsample=args.downsample_train, is_stack=True,
        )
        train_psnrs = evaluation(
            train_stack, render_fn, f"{logfolder}/imgs_train_all", n_vis=-1,
            chunk=args.eval_chunk, compute_extra_metrics=bool(args.compute_extra_metrics),
        )
        print(f"======> {args.expname} train all psnr: {np.mean(train_psnrs)} <========")
    if args.render_test:
        psnrs = evaluation(
            test_dataset, render_fn, f"{logfolder}/imgs_test_all", n_vis=-1,
            chunk=args.eval_chunk, compute_extra_metrics=bool(args.compute_extra_metrics),
        )
        print(f"======> {args.expname} test all psnr: {np.mean(psnrs)} <========")
    if args.render_path and test_dataset.render_path is not None:
        evaluation_path(
            test_dataset, render_fn, test_dataset.render_path,
            f"{logfolder}/imgs_path_all", chunk=args.eval_chunk,
        )
    return {**stats, "test_psnrs": psnrs}


def run_test(args):
    """Render-only from a checkpoint (`main.py:120-194`,
    `InfoInv/main.py:22-58`). Returns the test PSNRs (empty when no test
    views were rendered)."""
    from ngf_tpu_torch.data import load_dataset
    from ngf_tpu_torch.fields.triplane import TriPlaneConfig
    from ngf_tpu_torch.render.evaluation import evaluation, evaluation_path
    from ngf_tpu_torch.render.volume import RenderConfig, render_rays
    from ngf_tpu_torch.utils.checkpoint import load_checkpoint
    from ngf_tpu_torch.utils.device import resolve_device
    from ngf_tpu_torch.utils.grid import grid_n_samples

    device = resolve_device(args.device)

    if not args.ckpt or not os.path.exists(args.ckpt):
        print("the ckpt path does not exists!!")
        return []

    test_dataset = load_dataset(
        args.dataset_name, args.datadir, split="test",
        downsample=args.downsample_test, is_stack=True,
    )
    params, meta, alpha_volume, alpha_aabb = load_checkpoint(args.ckpt, device)
    if alpha_volume is not None:
        # The uint8 copy the occupancy lookup (K3) reads, made once.
        alpha_volume = (alpha_volume > 0).to(torch.uint8)
    model_cfg = TriPlaneConfig(**meta["model_cfg"])
    rcfg = RenderConfig(
        aabb=tuple(map(tuple, meta["aabb"])),
        near=meta["near_far"][0],
        far=meta["near_far"][1],
        # full geometry-derived marching, as the reference's render-only
        # evals (N_samples=-1 -> field nSamples, `InfoInv/main.py:46-58`)
        n_samples=grid_n_samples(meta["aabb"], meta["step_size"]),
        step_size=meta["step_size"],
        distance_scale=args.distance_scale,
        ray_march_weight_thres=args.rm_weight_mask_thre,
        white_bg=test_dataset.white_bg,
        sample_cap=args.sample_cap,
    )

    @torch.inference_mode()
    def render(rays):
        out = render_rays(
            params, model_cfg, rcfg, rays.to(device),
            iteration=args.n_iters + 1,
            alpha_volume=alpha_volume, alpha_aabb=alpha_aabb,
        )
        return out["rgb_map"], out["depth_map"]

    logfolder = os.path.dirname(args.ckpt)
    psnrs = []
    if args.render_train:
        train_stack = load_dataset(
            args.dataset_name, args.datadir, split="train",
            downsample=args.downsample_train, is_stack=True,
        )
        train_psnrs = evaluation(
            train_stack, render, f"{logfolder}/imgs_train_all", n_vis=-1,
            chunk=args.eval_chunk, compute_extra_metrics=bool(args.compute_extra_metrics),
        )
        print(f"======> {args.expname} train all psnr: {np.mean(train_psnrs)} <========")
    if args.render_test:
        psnrs = evaluation(
            test_dataset, render, f"{logfolder}/{args.expname}/imgs_test_all",
            n_vis=-1, chunk=args.eval_chunk,
            compute_extra_metrics=bool(args.compute_extra_metrics),
        )
        print(f"======> {args.expname} test all psnr: {np.mean(psnrs)} <========")
    if args.render_path and test_dataset.render_path is not None:
        evaluation_path(
            test_dataset, render, test_dataset.render_path,
            f"{logfolder}/{args.expname}/imgs_path_all", chunk=args.eval_chunk,
        )
    return psnrs


if __name__ == "__main__":
    main(sys.argv[1:])
