"""The learned-gauge slice against the JAX package on the CPU.

- The coordinate gradient of the bilinear fetch, written out in
  ``grid_sample_2d_backward_coords_plain`` (the plain version of the K2c
  kernel) and returned by ``grid_sample_planes``' backward, against
  ``jax.vjp`` of `ngf_tpu.ops.grid_sample.grid_sample_2d` with respect to the
  coordinates: non-square planes, coordinates on texel edges and outside the
  plane, split fetches. Both sum float32 products in other orders: 1e-5
  relative, and 1e-5 of the largest gradient where terms cancel.
- The plain version of the three-plane K2c,
  ``grid_sample_planes_backward_coords_plain``, in the kernel's layout: the
  plane and the coordinate gradients of 1 to 3 planes of their own shapes,
  split or not, either cotangent alone, on edges and outside, against
  ``jax.vjp`` per plane, to the same tolerance.
- A whole ``triplane_gauge`` + fused fetch on planes of three shapes against
  ``jax.vjp`` of the JAX gauge field: every plane, gauge-grid and decoder
  gradient (1e-5 of each leaf's largest), and before ``gauge_start`` a zero
  (not missing) gauge gradient.
- The events' functions: ``shrink_box_voxels``, ``shrink_planes``,
  ``upsample_planes``, ``resize_bilinear_2d`` (1e-6) and the trainer's voxel
  schedule against their JAX functions; the ``alpha_mask_len`` knob.
- The gauge recipe through `main_torch.py`, its ``model.npz`` read back by
  `ngf_tpu`'s ``load_checkpoint`` and rendered by the render-only CLI.

The kernel itself is tested on the card by `tests/test_torch_cuda.py`.
"""

import dataclasses
import os
import sys
import types

import numpy as np
import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ngf_tpu.fields import triplane as jt  # noqa: E402
from ngf_tpu.ops import grid_sample as j_gs  # noqa: E402
from ngf_tpu.train import occupancy as j_occ  # noqa: E402
from ngf_tpu.train.loop import TriPlaneTrainer as JTrainer  # noqa: E402
from ngf_tpu_torch import convert  # noqa: E402
from ngf_tpu_torch.config import TrainArgs  # noqa: E402
from ngf_tpu_torch.fields import triplane as tt  # noqa: E402
from ngf_tpu_torch.ops import cuda_kernels  # noqa: E402
from ngf_tpu_torch.ops import grid_sample as t_gs  # noqa: E402
from ngf_tpu_torch.train import occupancy as t_occ  # noqa: E402
from ngf_tpu_torch.train.loop import TriPlaneTrainer  # noqa: E402

REL = 1e-5
PLANES = ("plane_xy", "plane_yz", "plane_xz")
GAUGES = ("gauge_xy", "gauge_yz", "gauge_xz")


def _jax_coords_grad(plane, coords, g):
    _, vjp = jax.vjp(lambda c: j_gs.grid_sample_2d(jnp.asarray(plane), c), jnp.asarray(coords))
    return np.asarray(vjp(jnp.asarray(g))[0])


def _assert_close(got, want, rel=REL):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel, atol=rel * scale)


def _edge_coords(H, W, rng):
    """Coordinates on texel centres and edges: with H - 1 and W - 1 powers
    of two, -1 + k / 4 unnormalises to exact multiples of a half texel."""
    kx = rng.integers(0, 4 * (W - 1) // 2 + 1, 60)
    ky = rng.integers(0, 4 * (H - 1) // 2 + 1, 60)
    return np.stack([-1 + kx / ((W - 1) * 2) * 2, -1 + ky / ((H - 1) * 2) * 2], -1).astype(
        np.float32)


@pytest.mark.parametrize("case", ["square", "non-square", "edges", "outside"])
def test_coords_gradient_plain_matches_jax_vjp(case):
    rng = np.random.default_rng(1)
    H, W, C = {"square": (8, 8, 6), "non-square": (7, 12, 5), "edges": (5, 9, 4),
               "outside": (6, 11, 3)}[case]
    plane = rng.normal(size=(H, W, C)).astype(np.float32)
    if case == "edges":
        coords = _edge_coords(H, W, rng).reshape(3, 20, 2)
    else:
        lim = 1.8 if case == "outside" else 1.0
        coords = rng.uniform(-lim, lim, (3, 20, 2)).astype(np.float32)
    g = rng.normal(size=(*coords.shape[:-1], C)).astype(np.float32)
    got = t_gs.grid_sample_2d_backward_coords_plain(
        torch.from_numpy(plane), torch.from_numpy(coords), torch.from_numpy(g))
    assert got.shape == coords.shape and got.dtype == torch.float32
    _assert_close(got.numpy(), _jax_coords_grad(plane, coords, g))
    if case == "outside":
        far = (np.abs(coords) > 1 + 2.0 / (min(H, W) - 1)).any(-1)
        assert far.any() and not got.numpy()[far].any()


@pytest.mark.parametrize("channels,split", [(slice(None), 16), (slice(3, 13), 4),
                                            (slice(None), None)])
def test_fetch_coords_gradient_matches_jax_vjp(channels, split):
    """``grid_sample_planes`` on three planes of three shapes, split, with
    cotangents on both outputs: each plane's coordinate gradient against
    ``jax.vjp`` of `ngf_tpu`'s one-plane gather of those channels."""
    rng = np.random.default_rng(2)
    shapes = [(9, 11), (14, 9), (14, 11)]
    planes = [rng.normal(size=(h, w, 24)).astype(np.float32) for h, w in shapes]
    coords = [rng.uniform(-1.1, 1.1, (40, 2)).astype(np.float32) for _ in shapes]
    cs = [torch.from_numpy(c).requires_grad_(True) for c in coords]
    out_a, out_b = t_gs.grid_sample_planes([torch.from_numpy(p) for p in planes], cs,
                                           channels, split)
    g_a = rng.normal(size=out_a.shape).astype(np.float32)
    loss = (out_a * torch.from_numpy(g_a)).sum()
    g = g_a
    if out_b is not None:
        g_b = rng.normal(size=out_b.shape).astype(np.float32)
        loss = loss + (out_b * torch.from_numpy(g_b)).sum()
        g = np.concatenate([g_a, g_b], -1)
    loss.backward()
    for i, (p, c) in enumerate(zip(planes, coords)):
        _assert_close(cs[i].grad.numpy(), _jax_coords_grad(p[..., channels], c, g[:, i]))


def _gauge_setup(seed, shapes=((9, 11), (14, 9), (14, 11)), G=12):
    """The gauge preset at small widths, planes of three shapes as after a
    shrink and upsample, random gauge grids (zero-init grids deform
    nothing) and numpy points."""
    cfg = dataclasses.replace(jt.TriPlaneConfig.gauge_preset(gauge_start=5), plane_res=16,
                              gauge_res=G)
    params = jax.device_get(jt.init_triplane(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    for name, (h, w) in zip(PLANES, shapes):
        params[name] = (0.5 * rng.normal(size=(h, w, cfg.plane_dim))).astype(np.float32)
    for name in GAUGES:
        params[name] = (0.05 * rng.normal(size=(G, G, 2))).astype(np.float32)
    xyz = rng.uniform(-1.0, 1.0, (6, 30, 3)).astype(np.float32)
    return cfg, params, xyz


def _views(xyz):
    d = np.random.default_rng(0).normal(size=xyz.shape)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _jax_field(cfg, xyz, iteration):
    """(density, rgb) of the gauge field at ``xyz``: the fused fetch at the
    deformed coordinates and both decoders."""
    def fn(params):
        proj = jt.triplane_gauge(params, cfg, *jt.triplane_project(jnp.asarray(xyz)), iteration)
        sigma, feat = jt.triplane_density_and_rgbfeat(params, cfg, *proj)
        return sigma, jt.triplane_rgb_from_feats(params, cfg, feat, jnp.asarray(_views(xyz)))
    return fn


def _port_field(tcfg, tparams, xyz, iteration):
    proj = tt.triplane_gauge(tparams, tcfg, *tt.triplane_project(torch.from_numpy(xyz)), iteration)
    sigma, feat = tt.triplane_density_and_rgbfeat(tparams, tcfg, *proj)
    return sigma, tt.triplane_rgb_from_feats(tparams, tcfg, feat, torch.from_numpy(_views(xyz)))


def test_gauge_field_gradients_match_jax_vjp():
    """Every gradient of the gauge field (deformed fetch on planes of three
    shapes, gauge grids through the coordinate gradient, decoders) against
    ``jax.vjp`` for the same cotangents; 1e-5 of each leaf's largest."""
    cfg, params, xyz = _gauge_setup(3)
    fn = _jax_field(cfg, xyz, 7)
    jparams = jax.tree.map(jnp.asarray, params)
    j_sigma, j_rgb = jax.jit(fn)(jparams)
    rng = np.random.default_rng(4)
    g_sigma = rng.normal(size=j_sigma.shape).astype(np.float32)
    g_rgb = rng.normal(size=j_rgb.shape).astype(np.float32)
    grads = jax.jit(lambda p, cot: jax.vjp(fn, p)[1](cot)[0])(jparams, (g_sigma, g_rgb))
    want = dict(convert.named_leaves(jax.device_get(grads)))

    tcfg = tt.TriPlaneConfig(**dataclasses.asdict(cfg))
    tparams = convert.params_from_numpy(params, "cpu")
    leaves = dict(convert.named_leaves(tparams))
    for t in leaves.values():
        t.requires_grad_(True)
    sigma, rgb = _port_field(tcfg, tparams, xyz, 7)
    np.testing.assert_allclose(sigma.detach().numpy(), np.asarray(j_sigma), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(j_rgb), rtol=1e-5, atol=1e-5)
    ((sigma * torch.from_numpy(g_sigma)).sum() + (rgb * torch.from_numpy(g_rgb)).sum()).backward()
    assert set(want) == set(leaves)
    for name, w in want.items():
        assert float(np.abs(w).max()) > 0, name
        np.testing.assert_allclose(leaves[name].grad.numpy(), w, rtol=0,
                                   atol=REL * float(np.abs(w).max()), err_msg=name)


def test_gauge_grads_are_zero_before_gauge_start():
    """Before ``gauge_start`` the offsets are fetched and multiplied by 0:
    the gauge grids get a zero gradient, not None (Adam then counts their
    steps as optax does), and the planes' gradient equals JAX's."""
    cfg, params, xyz = _gauge_setup(5)
    (j_sigma, j_rgb), vjp = jax.vjp(_jax_field(cfg, xyz, 2), jax.tree.map(jnp.asarray, params))
    want = jax.device_get(vjp((jnp.ones_like(j_sigma), jnp.ones_like(j_rgb)))[0])
    tparams = convert.params_from_numpy(params, "cpu")
    for t in dict(convert.named_leaves(tparams)).values():
        t.requires_grad_(True)
    sigma, rgb = _port_field(tt.TriPlaneConfig(**dataclasses.asdict(cfg)), tparams, xyz, 2)
    (sigma.sum() + rgb.sum()).backward()
    for name in GAUGES:
        assert tparams[name].grad is not None and not tparams[name].grad.any(), name
        assert not np.asarray(want[name]).any()
    for name in PLANES:
        w = np.asarray(want[name])
        np.testing.assert_allclose(tparams[name].grad.numpy(), w, rtol=0,
                                   atol=REL * float(np.abs(w).max()), err_msg=name)


@pytest.mark.parametrize("new_hw", [(23, 17), (6, 9), (11, 14)])
def test_resize_bilinear_2d_matches_jax(new_hw):
    rng = np.random.default_rng(6)
    plane = rng.normal(size=(11, 14, 5)).astype(np.float32)
    got = t_gs.resize_bilinear_2d(torch.from_numpy(plane), new_hw)
    assert got.shape == (*new_hw, 5) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(j_gs.resize_bilinear_2d(plane, new_hw)),
                               rtol=1e-6, atol=1e-6)


def _plane_params(seed, shape=(16, 16)):
    rng = np.random.default_rng(seed)
    params = {n: rng.normal(size=(*shape, 6)).astype(np.float32) for n in PLANES}
    params.update({n: rng.normal(size=(8, 8, 2)).astype(np.float32) for n in GAUGES})
    return params


def test_upsample_planes_matches_jax():
    params = _plane_params(7, (12, 15))
    res = (17, 9, 21)
    got = tt.upsample_planes(convert.params_from_numpy(params, "cpu"), res)
    want = jax.device_get(jt.upsample_planes(jax.tree.map(jnp.asarray, params), res))
    for name in PLANES:
        assert got[name].is_contiguous()
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=1e-6, atol=1e-6)
    for name in GAUGES:  # not resized
        assert np.array_equal(got[name].numpy(), params[name])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shrink_box_and_planes_match_jax(seed):
    rng = np.random.default_rng(seed)
    aabb = np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32)
    lo = rng.uniform(-1.5, -0.2, 3).astype(np.float32)
    new_aabb = np.stack([lo, rng.uniform(0.1, 1.5, 3).astype(np.float32)])
    grid = [16, 16, 16]
    t_l, b_r = t_occ.shrink_box_voxels(aabb, new_aabb, grid)
    j_tl, j_br = j_occ.shrink_box_voxels(aabb, new_aabb, grid)
    assert np.array_equal(t_l, j_tl) and np.array_equal(b_r, j_br)
    params = _plane_params(seed)
    got = tt.shrink_planes(convert.params_from_numpy(params, "cpu"), t_l, b_r)
    want = jt.shrink_planes(params, j_tl, j_br)
    for name in PLANES:
        assert got[name].is_contiguous()
        assert np.array_equal(got[name].numpy(), want[name]), name
    for name in GAUGES:  # the gauge grids are not cropped
        assert np.array_equal(got[name].numpy(), params[name])


@pytest.mark.parametrize("ups,init,final", [([800], 128 ** 3, 256 ** 3), ([], 8 ** 3, 16 ** 3),
                                            ([2000, 3000, 4000], 100 ** 3, 300 ** 3)])
def test_voxel_schedule_matches_jax(ups, init, final):
    args = types.SimpleNamespace(upsamp_list=ups, N_voxel_init=init, N_voxel_final=final)
    got = TriPlaneTrainer._voxel_schedule(types.SimpleNamespace(args=args))
    assert got == JTrainer._voxel_schedule(types.SimpleNamespace(args=args))
    assert len(got) == len(ups) and (not ups or got[0] == init)


def test_alpha_mask_len_sets_the_mask_threshold_length(monkeypatch):
    """``alpha_mask_len > 0`` replaces the current step as the occupancy
    threshold's length at a mask event (`ngf_tpu/train/loop.py:1284-1287`);
    0 keeps the step. The grid built with it equals the JAX package's
    ``update_alpha_mask`` at that length, and differs from the one at the
    step."""
    from ngf_tpu_torch.data import load_dataset

    ds = load_dataset("synthetic", "synthetic:views=1,wh=8", split="train", is_stack=False)
    lengths = {}
    for mask_len in (0.0, 0.37):
        args = TrainArgs(subsystem="triplane", plane_res=16, gauge_res=8, alpha_grid_res=10,
                         nSamples=40, batch_size=64, alpha_mask_len=mask_len, device="cpu")
        trainer = TriPlaneTrainer(args, ds, device="cpu")
        with torch.no_grad():
            for name in PLANES:
                trainer.params[name].mul_(40.0)
        trainer._event_update_alpha_mask(first=False)
        lengths[mask_len] = trainer.alpha.volume.numpy()
        jcfg = jt.TriPlaneConfig(**dataclasses.asdict(trainer.model_cfg))
        jparams = jax.tree.map(jnp.asarray, convert.params_to_numpy(trainer.params))
        with jax.disable_jit():
            grid, _ = j_occ.update_alpha_mask(jparams, jcfg, trainer.aabb,
                                              mask_len or trainer.step_size, grid_size=(10,) * 3,
                                              alpha_thres=args.alpha_mask_thre)
        np.testing.assert_array_equal(lengths[mask_len], np.asarray(grid.volume))
    assert lengths[0.0].sum() != lengths[0.37].sum()


def test_cli_gauge_train_writes_checkpoint_jax_reads(tmp_path):
    """The gauge recipe, cut to a tiny CPU run through `main_torch.py`: the
    gauge on at 3, the mask and shrink at 6, the upsample at 8. The
    ``model.npz`` carries three plane shapes, the gauge grids and the
    post-shrink box; `ngf_tpu`'s ``load_checkpoint`` reads it back, and the
    render-only CLI renders it."""
    import main_torch
    from ngf_tpu.utils.checkpoint import load_checkpoint as j_load

    datadir = "synthetic:views=2,wh=16,test_views=1"
    stats = main_torch.main([
        "--config", os.path.join(REPO, "configs", "synthetic_triplane_tpu.txt"),
        "--device", "cpu", "--plane_res", "32", "--gauge_res", "16", "--alpha_grid_res", "16",
        "--datadir", datadir, "--nSamples", "48", "--batch_size", "256",
        "--open_sample_cap", "32", "--n_iters", "10", "--update_AlphaMask_list", "6",
        "--upsamp_list", "8", "--gauge_start", "3", "--N_voxel_init", str(20 * 24 * 16),
        "--vis_every", "10", "--basedir", str(tmp_path), "--expname", "gauge",
        "--render_test", "1",
    ])
    assert [e["kind"] for e in stats["events"]] == ["mask", "upsample"]
    assert all(np.isfinite(stats["train_mses"])) and len(stats["test_psnrs"]) == 1
    mask, up = stats["events"]
    assert "shrink" in mask and up["plane_shapes"][0][:2] == up["grid_size"][1::-1]
    ckpt = str(tmp_path / "gauge" / "model.npz")
    params, meta, vol, _ = j_load(ckpt)
    assert meta["subsystem"] == "triplane" and vol is not None
    assert meta["aabb"] == mask["shrink"]["aabb"] and meta["grid_size"] == up["grid_size"]
    rx, ry, rz = up["grid_size"]
    assert [np.asarray(params[n]).shape for n in PLANES] == [(ry, rx, 64), (rz, ry, 64),
                                                           (rz, rx, 64)]
    assert all(np.asarray(params[n]).shape == (16, 16, 2) and np.asarray(params[n]).any()
               for n in GAUGES)
    psnrs = main_torch.main([
        "--render_only", "1", "--render_test", "1", "--ckpt", ckpt, "--dataset_name",
        "synthetic", "--datadir", datadir, "--expname", "render", "--device", "cpu",
        "--compute_extra_metrics", "0",
    ])
    assert len(psnrs) == 1 and np.isfinite(psnrs[0])


def _jax_fetch_grads(plane, coords, g, channels):
    """``jax.vjp`` of `ngf_tpu`'s one-plane gather of ``channels`` with
    respect to the whole plane and the coordinates."""
    _, vjp = jax.vjp(lambda p, c: j_gs.grid_sample_2d(p[..., channels], c), jnp.asarray(plane),
                     jnp.asarray(coords))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


# (plane shapes, channels, split, cotangents, coordinates) of the plain
# three-plane K2c's cases.
K2C_CASES = {
    "three_shapes_split": ([(9, 11), (14, 9), (14, 11)], slice(None), 16, "ab", "inside"),
    "one_plane": ([(14, 9)], slice(None), 16, "ab", "inside"),
    "two_planes_one_cotangent": ([(9, 11), (14, 9)], slice(None), 16, "a", "inside"),
    "second_output_only": ([(9, 11), (14, 9), (14, 11)], slice(None), 16, "b", "inside"),
    "no_split": ([(9, 11), (14, 9), (14, 11)], slice(3, 13), 10, "a", "inside"),
    "edges": ([(5, 9), (9, 5), (9, 9)], slice(3, 13), 4, "ab", "edges"),
    "outside": ([(6, 11), (11, 6), (11, 11)], slice(None), 16, "ab", "outside"),
}


@pytest.mark.parametrize("case", list(K2C_CASES))
def test_planes_backward_coords_plain_matches_jax_vjp(case):
    """The plain version of the three-plane K2c, in the kernel's layout
    (cotangents (..., P, C_a) and (..., P, C_b), coordinate gradients
    (..., P, 2)), against ``jax.vjp`` of `ngf_tpu`'s one-plane gather per
    plane: the plane gradient of the fetched channels (nothing outside
    them) and the coordinate gradient, to REL."""
    shapes, channels, split, given, where = K2C_CASES[case]
    rng = np.random.default_rng(3)
    P = len(shapes)
    planes = [rng.normal(size=(h, w, 64)).astype(np.float32) for h, w in shapes]
    if where == "edges":
        coords = [_edge_coords(h, w, rng).reshape(4, 15, 2) for h, w in shapes]
    else:
        lim = 1.8 if where == "outside" else 1.05
        coords = [rng.uniform(-lim, lim, (4, 15, 2)).astype(np.float32) for _ in shapes]
    c0, c1, _ = channels.indices(64)
    g_a = rng.normal(size=(4, 15, P, split)).astype(np.float32)
    g_b = rng.normal(size=(4, 15, P, c1 - c0 - split)).astype(np.float32)
    g_full = np.concatenate([g_a if "a" in given else 0 * g_a, g_b if "b" in given else 0 * g_b],
                            -1)
    grads = [torch.zeros((h, w, 64)) for h, w in shapes]
    got = t_gs.grid_sample_planes_backward_coords_plain(
        [torch.from_numpy(p) for p in planes], [torch.from_numpy(c) for c in coords],
        torch.from_numpy(g_a) if "a" in given else None,
        torch.from_numpy(g_b) if "b" in given and g_b.shape[-1] else None, grads, c0, split)
    assert got.shape == (4, 15, P, 2) and got.dtype == torch.float32
    for i, (plane, c) in enumerate(zip(planes, coords)):
        want_plane, want_coords = _jax_fetch_grads(plane, c, g_full[..., i, :], channels)
        _assert_close(grads[i].numpy(), want_plane)
        _assert_close(got[..., i, :].numpy(), want_coords)
        if where == "outside":
            far = (np.abs(c) > 1 + 2.0 / (min(plane.shape[:2]) - 1)).any(-1)
            assert far.any() and not got[..., i, :].numpy()[far].any()


def test_coords_wrapper_refuses_cpu_tensors():
    """No fallback: K2c's wrapper takes CUDA tensors or raises."""
    plane = torch.zeros((4, 5, 8))
    coords = torch.zeros((3, 2))
    with pytest.raises(ValueError):
        cuda_kernels.bilinear_gather_planes_backward_coords(
            [plane], [coords], torch.zeros((3, 1, 8)), None, [torch.zeros_like(plane)])
    assert "bilinear_gather_planes_backward_coords" in cuda_kernels.KERNELS


def test_chip_smoke_gauge_phase_on_cpu():
    """`chip_smoke.py`'s gauge phase at a tiny size on the CPU (plain
    versions): the gauge CLI run (the gauge on at 4, the mask event with the
    shrink at 10, the upsample at 14 of 20 steps) with its event, stage,
    loss, gauge-grid and checkpoint checks, the render-only CLI on its
    checkpoint, and the kernels-vs-plain step comparison of every gradient."""
    import chip_smoke

    out = chip_smoke.gauge_phase(
        torch.device("cpu"), views=2, wh=16,
        extra=("--plane_res", "32", "--gauge_res", "16", "--nSamples", "48", "--batch_size",
               "256", "--open_sample_cap", "32", "--alpha_grid_res", "16", "--n_iters", "20",
               "--gauge_start", "4", "--update_AlphaMask_list", "10", "--upsamp_list", "14",
               "--N_voxel_init", str(20 * 24 * 16), "--vis_every", "10", "--density_shift", "0"),
    )
    assert len(out["mses"]) == 20 and np.isfinite(out["test_psnr"])
    assert [e["iteration"] for e in out["events"]] == [10, 14]
    assert [(s["from"], s["to"]) for s in out["stages"]] == [(0, 10), (10, 14), (14, 20)]
    assert np.isfinite(out["render"]["psnr"]) and out["render"]["chunks"] == 1
    assert set(out["compare"]["grads"]) >= {"plane_xy", "gauge_xy", "density_decoder/w"}
