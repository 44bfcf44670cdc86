"""A cell's spec cut to a size the CPU runs in seconds, for the tests: the
widths and the scene small, the events at 4 (and 5), a partial mask."""

from __future__ import annotations

from gpubench import spec as spec_mod


def tiny_spec(cell: str):
    sp = spec_mod.load(cell)
    c = sp.config
    c["scene"] = {"train_views": 2, "test_views": 3, "wh": [32, 32]}
    c["widths"].update(plane_res=32, gauge_res=16, alpha_grid_res=16)
    c["args"].update(plane_res=32, gauge_res=16, alpha_grid_res=16, batch_size=64,
                     open_sample_cap=32, masked_sample_cap=40, nSamples=48, density_shift=0.0, alpha_mask_thre=0.0338,
                     update_AlphaMask_list=[4], N_voxel_init=32 ** 3, N_voxel_final=40 ** 3)
    if c["args"]["subsystem"] == "triplane":
        c["args"].update(upsamp_list=[4, 5], gauge_start=4)
    sp.traffic = dict(sp.traffic, warm_steps=4)
    if sp.traffic["driver"] == "render":
        sp.traffic.update(chunk=1024, views=2)
    return sp
