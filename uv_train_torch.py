#!/usr/bin/env python3
"""UV-Mapping (NeuTex) training on the PyTorch/CUDA port, the counterpart of
`uv_train.py` (reference `UV-Mapping/train.py`, `dtu_train.sh`):

    python uv_train_torch.py --dataset_name synthetic_dtu --random_sample balanced \\
        --random_sample_size 24 --sample_num 64 --primitive_type square \\
        --points_per_primitive 2500 --lr 1e-4 --synthetic_views 24 --niter 3000

The same flags as `uv_train.py`, plus ``--device`` (``cuda``, the default,
or ``cpu``). Writes ``<checkpoints_dir>/<name>/``: ``opt.txt``, ``log.txt``,
``scalars.jsonl``, test renders (PNG) and the checkpoints
(``{step}_net_NeuTex.npz``, ``latest_net_NeuTex.npz``, per-subnetwork
files). SIGTERM finishes the running block, saves ``latest`` and exits 0;
``--resume_dir <dir>`` continues from it. At exit it prints the K5 kernel
launches of the run.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--name", type=str, default="experiment")
    p.add_argument("--dataset_name", type=str, default="dtu", choices=["dtu", "synthetic_dtu"])
    p.add_argument("--data_root", type=str, default="./data/DTU/scan83")
    p.add_argument("--checkpoints_dir", type=str, default="./checkpoints/")
    p.add_argument("--resume_dir", type=str, default="")
    p.add_argument("--resume_epoch", type=str, default="latest")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--random_sample", type=str, default="no_crop",
                   choices=["no_crop", "random", "balanced", "patch"])
    p.add_argument("--random_sample_size", type=int, default=64)
    p.add_argument("--test_views", type=str, default="6,13,35,30")
    p.add_argument("--sample_num", type=int, required=True)
    p.add_argument("--primitive_type", type=str, choices=["square", "sphere"], required=True)
    p.add_argument("--points_per_primitive", type=int, required=True)
    p.add_argument("--target_texture", type=str, default="None")
    p.add_argument("--loss_color_weight", type=float, default=1.0)
    p.add_argument("--loss_bg_weight", type=float, default=1.0)
    p.add_argument("--loss_origin_weight", type=float, default=1.0)
    p.add_argument("--loss_inverse_mapping_weight", type=float, default=0.0)
    p.add_argument("--freeze_subnetworks", type=str, default=None)
    p.add_argument("--load_subnetworks", type=str, default="")
    p.add_argument("--load_subnetworks_dir", type=str, default="")
    p.add_argument("--load_subnetworks_epoch", type=str, default="latest")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--niter", type=int, default=500000)
    p.add_argument("--niter_decay", type=int, default=0)
    p.add_argument("--lr_policy", type=str, default="lambda", choices=["lambda", "step", "plateau"])
    p.add_argument("--steps_per_call", type=int, default=20,
                   help="steps a train_block call runs; the losses are read from the card "
                        "once a block, and 'plateau' updates once a block, from its mean "
                        "colour loss (its metric block)")
    p.add_argument("--compute_dtype", type=str, default="float32", choices=["float32", "bfloat16"],
                   help="MLP-stack matmul dtype (float32 masters and sums; compositing and "
                        "losses stay float32)")
    p.add_argument("--lr_decay_iters", type=int, default=50)
    p.add_argument("--print_freq", type=int, default=100)
    p.add_argument("--test_freq", type=int, default=10000)
    p.add_argument("--test_num", type=int, default=1)
    p.add_argument("--save_iter_freq", type=int, default=5000)
    p.add_argument("--train_and_test", type=int, default=1)
    p.add_argument("--synthetic_views", type=int, default=8)
    p.add_argument("--synthetic_wh", type=int, default=64)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the default; raises without a card) or 'cpu'")
    return p.parse_args(argv)


def make_dataset(opt, use_test_data=False):
    if opt.dataset_name == "synthetic_dtu":
        from ngf_tpu_torch.data.dtu import SyntheticDtuDataset

        return SyntheticDtuDataset(
            n_views=opt.synthetic_views, wh=(opt.synthetic_wh, opt.synthetic_wh),
            random_sample=opt.random_sample, random_sample_size=opt.random_sample_size,
            use_test_data=use_test_data, seed=opt.seed,
        )
    from ngf_tpu_torch.data.dtu import DtuDataset

    return DtuDataset(
        opt.data_root, random_sample=opt.random_sample,
        random_sample_size=opt.random_sample_size, use_test_data=use_test_data,
        test_views=opt.test_views, seed=opt.seed,
    )


def make_config(opt):
    from ngf_tpu_torch.fields.neutex import NeuTexConfig

    return NeuTexConfig(primitive_type=opt.primitive_type, sample_num=opt.sample_num,
                        points_per_primitive=opt.points_per_primitive,
                        compute_dtype=opt.compute_dtype)


def to_png(img: np.ndarray) -> np.ndarray:
    """[0, 1] float (H, W, 3) or (H, W) -> (H, W, 3) uint8."""
    img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return np.repeat(img[..., None], 3, axis=-1) if img.ndim == 2 else img


def kernel_launches() -> dict[str, int]:
    from ngf_tpu_torch.ops import cuda_kernels

    return {k: fn.launches for k, fn in cuda_kernels.KERNELS.items() if fn.launches}


def main(argv=None) -> None:
    from ngf_tpu_torch.train.uv_loop import UVTrainer
    from ngf_tpu_torch.utils.device import resolve_device
    from ngf_tpu_torch.utils.image import write_png

    opt = parse_args(argv)
    device = resolve_device(opt.device)
    np.random.seed(opt.seed)
    dataset = make_dataset(opt)
    save_dir = os.path.join(opt.checkpoints_dir, opt.name)
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "opt.txt"), "w") as f:
        f.write("------------ Options -------------\n")
        for k, v in sorted(vars(opt).items()):
            f.write(f"{k}: {v}\n")
        f.write("-------------- End ----------------\n")

    trainer = UVTrainer(
        make_config(opt), dataset, lr=opt.lr, niter=opt.niter, niter_decay=opt.niter_decay,
        lr_policy=opt.lr_policy, lr_decay_iters=opt.lr_decay_iters,
        loss_weights={
            "color": opt.loss_color_weight, "bg": opt.loss_bg_weight,
            "origin": opt.loss_origin_weight, "inverse_mapping": opt.loss_inverse_mapping_weight,
        },
        seed=opt.seed, save_dir=save_dir,
        freeze=opt.freeze_subnetworks.split(",") if opt.freeze_subnetworks else None,
        device=device,
    )
    if opt.load_subnetworks:
        trainer.load_subnetworks(opt.load_subnetworks_epoch, opt.load_subnetworks.split(","),
                                 opt.load_subnetworks_dir or None)
    start_step = 0
    if opt.resume_dir:
        meta = trainer.load_networks(opt.resume_epoch, opt.resume_dir)
        start_step = int(meta.get("total_steps", trainer.step_count))
        print(f"resumed at step {start_step}", flush=True)

    def test(step):
        test_ds = make_dataset(opt, use_test_data=True)
        for vi in range(min(opt.test_num, len(test_ds.indexes))):
            idx = test_ds.indexes[vi]
            rgb, _ = trainer.render_view(
                test_ds.campos[idx], test_ds.height, test_ds.width, test_ds.focal[idx],
                test_ds.extrinsics[idx][0:3, 0:3], test_ds.princpt[idx],
                chunk=opt.random_sample_size ** 2,
            )
            write_png(os.path.join(save_dir, f"{step:08d}-test-{vi}.png"), to_png(rgb))
        print(f"test renders written at step {step}", flush=True)

    out = trainer.run(dataset, steps_per_call=opt.steps_per_call, print_freq=opt.print_freq,
                      test_freq=opt.test_freq, save_iter_freq=opt.save_iter_freq,
                      start_step=start_step, test=test if opt.train_and_test else None)
    if out["preempted"]:
        print(f"preempted at step {out['total_steps']}; 'latest' networks saved "
              f"(resume with --resume_dir {save_dir})", flush=True)
    else:
        print("training finished", flush=True)
    print("[uv_train_torch] kernel launches " + json.dumps(kernel_launches()), flush=True)


if __name__ == "__main__":
    main()
