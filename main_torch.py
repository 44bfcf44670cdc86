#!/usr/bin/env python3
"""CLI of the PyTorch/CUDA port (`ngf_tpu_torch`), the counterpart of
`main.py`: dense InfoInv training, and render-only evaluation of a
checkpoint.

    python main_torch.py --config configs/synthetic_infoinv_tpu.txt \\
        --group_size 0 --n_iters 300 [--device cpu]
    python main_torch.py --config configs/lego_infoinv.txt \\
        --render_only 1 --render_test 1 --ckpt path/to/model.npz [--device cpu]

It reads the same ``configs/*.txt`` and writes and reads the same ``.npz``
checkpoints as `main.py`, and runs on the GPU unless ``--device cpu`` is
given. Training covers the open stage: options the port does not carry yet
(events inside ``n_iters``, ``group_size > 0``, the gauge subsystem,
bfloat16, resume) raise, naming ROADMAP.md.
"""

from __future__ import annotations

import datetime
import os
import sys

import numpy as np
import torch


def main(argv=None):
    from ngf_tpu_torch.config import config_parser

    args = config_parser(argv)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)

    if args.render_only and (args.render_test or args.render_path):
        return run_test(args)
    return run_train(args)


def _logfolder(args):
    if args.add_timestamp:
        stamp = datetime.datetime.now().strftime("-%Y%m%d-%H%M%S")
        return f"{args.basedir}/{args.expname}{stamp}"
    return f"{args.basedir}/{args.expname}"


def _full_f32_products():
    # Full float32 products, as the reference computes them.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def run_train(args):
    """Train, save ``model.npz``, then the final evaluations
    (`main.py:45-117`). Returns the trainer's statistics with the test
    PSNRs under ``test_psnrs`` (empty when no test views were rendered)."""
    from ngf_tpu_torch.data import load_dataset
    from ngf_tpu_torch.render.evaluation import evaluation, evaluation_path
    from ngf_tpu_torch.train.loop import TriPlaneTrainer, check_ported
    from ngf_tpu_torch.utils.device import resolve_device

    if args.ckpt:
        raise NotImplementedError(
            "resuming training from --ckpt is not ported to ngf_tpu_torch yet: see "
            "ROADMAP.md queue 1, 'resume'"
        )
    if args.export_mesh:
        raise NotImplementedError(
            "export_mesh is not ported to ngf_tpu_torch yet: see ROADMAP.md, items still missing"
        )
    check_ported(args)
    device = resolve_device(args.device)
    _full_f32_products()

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
    trainer = TriPlaneTrainer(args, train_dataset, test_dataset, logfolder, device=device)
    stats = trainer.run()
    print(f"training done: { {k: v for k, v in stats.items() if k != 'train_mses'} }")

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
    _full_f32_products()

    if not args.ckpt or not os.path.exists(args.ckpt):
        print("the ckpt path does not exists!!")
        return []

    test_dataset = load_dataset(
        args.dataset_name, args.datadir, split="test",
        downsample=args.downsample_test, is_stack=True,
    )
    params, meta, alpha_volume, alpha_aabb = load_checkpoint(args.ckpt, device)
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
