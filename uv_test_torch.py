#!/usr/bin/env python3
"""UV-Mapping (NeuTex) test and texture export on the PyTorch/CUDA port, the
counterpart of `uv_test.py` (reference `UV-Mapping/test.py`,
`dtu_test.sh`). The flags are `uv_train_torch.py`'s.

Loads ``<resume_dir or checkpoints_dir/name>/<resume_epoch>_net_NeuTex.npz``,
exports the learned texture (the sphere: its six cube faces merged into a
cross image, and an equirectangular view; the square: one image), then
renders every test view chunked by ``random_sample_size**2`` rays, with an
edited ``--target_texture`` swapped in when one is given. Writes PNGs to
``<checkpoints_dir>/<name>/test_output/`` and prints the K5 launches at
exit.
"""

from __future__ import annotations

import json
import os

import numpy as np

from uv_train_torch import kernel_launches, make_config, make_dataset, parse_args, to_png


def main(argv=None) -> None:
    from ngf_tpu_torch.fields.neutex import export_sphere_equirect, export_texture
    from ngf_tpu_torch.train.uv_loop import UVTrainer
    from ngf_tpu_torch.utils.cubemap import (
        load_cube_from_single_texture,
        load_square,
        merge_cube_to_single_texture,
    )
    from ngf_tpu_torch.utils.device import resolve_device
    from ngf_tpu_torch.utils.image import write_png
    from ngf_tpu_torch.utils.precision import float32_accumulation

    opt = parse_args(argv)
    device = resolve_device(opt.device)
    if not opt.resume_dir:
        opt.resume_dir = os.path.join(opt.checkpoints_dir, opt.name)
    dataset = make_dataset(opt, use_test_data=True)
    save_dir = os.path.join(opt.checkpoints_dir, opt.name)
    out_dir = os.path.join(save_dir, "test_output")
    os.makedirs(out_dir, exist_ok=True)

    cfg = make_config(opt)
    trainer = UVTrainer(cfg, dataset, save_dir=save_dir, device=device)
    trainer.load_networks(opt.resume_epoch, opt.resume_dir)
    print(f"loaded checkpoint at step {trainer.step_count}", flush=True)

    viewdir = [0, 0, 1]
    with float32_accumulation():
        if opt.primitive_type == "sphere":
            faces = export_texture(trainer.params, cfg, 512, viewdir).cpu().numpy()
            write_png(os.path.join(out_dir, "texture_cube.png"),
                      to_png(merge_cube_to_single_texture(faces)))
            eq = export_sphere_equirect(trainer.params, cfg, 512, viewdir).cpu().numpy()
            write_png(os.path.join(out_dir, "texture_sphere.png"), to_png(eq))
        else:
            tex = export_texture(trainer.params, cfg, 512, viewdir).cpu().numpy()
            write_png(os.path.join(out_dir, "texture.png"), to_png(tex))
    print("texture exported", flush=True)

    edit = None
    if opt.target_texture != "None":
        load = load_cube_from_single_texture if opt.primitive_type == "sphere" else load_square
        edit = load(opt.target_texture).astype(np.float32)

    chunk = opt.random_sample_size ** 2
    for vi, idx in enumerate(dataset.indexes):
        rgb, trans = trainer.render_view(
            dataset.campos[idx], dataset.height, dataset.width, dataset.focal[idx],
            dataset.extrinsics[idx][0:3, 0:3], dataset.princpt[idx], chunk=chunk,
            edit_texture=edit,
        )
        write_png(os.path.join(out_dir, f"render-{vi:03d}.png"), to_png(rgb))
        write_png(os.path.join(out_dir, f"transmittance-{vi:03d}.png"), to_png(trans))
    print(f"rendered {len(dataset.indexes)} views to {out_dir}", flush=True)
    print("[uv_test_torch] kernel launches " + json.dumps(kernel_launches()), flush=True)


if __name__ == "__main__":
    main()
