"""The bound and operation counts against values worked by hand at small
shapes; the sample counts of a traced run's window against the reference's
full render, and its sampler against the port's over several epochs; the
scene's copy against the port's analytic scene."""

import time

import numpy as np
import pytest
import torch

from gpubench import harness
from gpubench.counts import field, kernels
from gpubench.metrics import common as metrics
from gpubench.reference import check, model as M
from gpubench.scene import synthetic
from gpubench.scene.weights import make_weights
from gpubench.tests.tiny import tiny_spec
from ngf_tpu_torch.data import sampler as port_sampler
from ngf_tpu_torch.data import synthetic as port_synthetic


def test_k1_bound_by_hand():
    # 10 points, one 4x5 plane of 3 float32 channels: 10*3*4 + 8*10 + 4*5*3*4 bytes
    # = 120 + 80 + 240 = 440; 7*10*3 + 30*10 = 510 flops. Bytes bound it.
    assert kernels.k1(10, [(4, 5)], 3) == pytest.approx(440 / 3.35e12)
    assert kernels.k1(10, [(4, 5), (4, 5)], 3) == pytest.approx(880 / 3.35e12)
    # Operations bound a fetch of many channels from a tiny plane:
    # n = 1e6, c = 1000 on 2x2: bytes 4e9 + 8e6 + 16e3; flops 7e9 + 3e7.
    assert kernels.k1(10 ** 6, [(2, 2)], 1000) == pytest.approx(
        max((4e9 + 8e6 + 16e3) / 3.35e12, 7.03e9 / 67e12))


def test_k2_and_k2c_bounds_by_hand():
    # k2: 10 points, 4x5 plane, 3 channels: 120 + 80 + 2*4*5*3*4 = 680 bytes.
    assert kernels.k2(10, 4, 5, 3) == pytest.approx(680 / 3.35e12)
    # k2c: 2 planes 4x5 and 2x3, 3 channels, 10 points: 2*(120 + 160) + 26*3*12.
    assert kernels.k2c(10, 3, [(4, 5), (2, 3)]) == pytest.approx((560 + 936) / 3.35e12)


def test_field_flops_by_hand():
    cfg = {"widths": {"plane_dim": 4, "density_dim": 1, "density_pe": 1, "rgb_pe": 1, "view_pe": 1,
                      "density_mid": 2, "rgb_mid": 2},
           "args": {"subsystem": "infoinv", "infoinv": False}}
    dens, app = field.per_sample(cfg)
    # fetch 3*(7+30) = 111; +10; MLP 3->2->2->1: (12+2) + (8+2) + (4+1) = 29.
    assert dens == 111 + 10 + 29
    # fetch 3*(21+30) = 153; basis 2*9^2 = 162; MLP 9+3+6=18 -> 2 -> 2 -> 3:
    # (72+2) + (8+2) + (12+3) = 99; view PE 12 + 3 + 8.
    assert app == 153 + 162 + 99 + 12 + 3 + 8
    assert field.flops(cfg, 10, 4, train=True) == 3 * (10 * dens + 4 * app)
    assert field.flops(cfg, 10, 4, train=False) == 10 * dens + 4 * app


def test_scene_matches_the_port_at_a_small_size():
    wh = (12, 10)
    port = port_synthetic.SyntheticDataset(split="train", n_views=3, wh=wh)
    rays = synthetic.split_rays("train", 3, wh, "cpu")
    np.testing.assert_allclose(rays.numpy(), port.all_rays, atol=2e-6)
    np.testing.assert_allclose(synthetic.render_gt(rays, chunk=100).numpy(), port.all_rgbs,
                               atol=2e-5)
    test = port_synthetic.SyntheticDataset(split="test", n_views=4, wh=wh)
    np.testing.assert_allclose(synthetic.poses("test", 4), test.poses, atol=1e-6)


def test_scene_split_keeps_host_and_device_copies():
    split = synthetic.TrainSplit(2, (8, 8), "cpu")
    assert split.all_rays.shape == (128, 6) and split.all_rgbs.shape == (128, 3)
    assert torch.equal(torch.from_numpy(split.all_rgbs), split.rgbs)
    assert split.near_far == (2.0, 6.0) and split.white_bg


def test_the_sampler_follows_the_port_over_epochs():
    port = port_sampler.SimpleSampler(1000, 64, seed=2 ** 31 + 7)
    ids = [port.nextids() for _ in range(40)]  # 15 batches an epoch
    got = check.sampler_ids(1000, 64, 2 ** 31 + 7, 5, 35)
    for a, b in zip(ids[5:], got):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cell", ["infoinv-lego.train", "gauge-lego.train"])
def test_sample_counts_match_the_full_render(cell):
    torch.manual_seed(0)
    sp = tiny_spec(cell)
    cfg = sp.config
    tree = make_weights(cfg, 11, torch.device("cpu"))
    flat = M.flatten(tree)
    flat.update({k: v * 3.0 for k, v in flat.items() if k.startswith("plane_")})
    tree = check.unflatten(flat)
    fc = M.FieldCfg.from_config(cfg)
    rays = synthetic.split_rays("train", 1, (16, 16), "cpu")
    rc = M.RenderCfg(aabb=((-1.5,) * 3, (1.5,) * 3), near=2.0, far=6.0, n_samples=48,
                     step_size=0.05, group=8, capg=4, distance_scale=25.0, thres=1e-4)
    vol = (torch.rand(16, 16, 16) > 0.5).float()
    vol_aabb = torch.tensor([[-1.5] * 3, [1.5] * 3])
    jitter = torch.rand(rays.shape[0], 1)
    valid, shaded = M.count_samples(tree, fc, rc, rays, 5, vol, vol_aabb, jitter)
    # The full render's own: every sample decoded, sigma times the mask.
    aabb = torch.tensor(rc.aabb)
    z, vmask, xyz = M.front_end(rays, jitter, aabb, rc.near, rc.far, rc.n_samples, rc.step_size,
                                rc.group, rc.capg, vol, vol_aabb)
    sigma = M.density(tree, fc, *M.gauge(tree, fc, *M.project(xyz), 5)) * vmask
    w = M.blend_weights(sigma, float(np.float32(rc.step_size * rc.distance_scale)))
    assert int(valid) == int(vmask.sum()) > 0
    assert abs(int(shaded) - int((w > rc.thres).sum())) <= 2 and int(shaded) > 0
    # A chunk with nothing in the mask (a view's background) counts nothing.
    assert [int(x) for x in M.count_samples(tree, fc, rc, rays, 5, torch.zeros_like(vol), vol_aabb,
                                            jitter)] == [0, 0]


@pytest.mark.parametrize("cell", ["gauge-lego.train", "infoinv-lego.render"])
def test_a_traced_run_counts_every_step_or_chunk_of_its_window(cell):
    sp = tiny_spec(cell)
    run = sp.driver.run(sp, 3000000019, 0.5, True, torch.device("cpu"), time.perf_counter())
    assert harness.judge(sp.driver.check(sp, run))
    ctx = run["trace"]
    c = ctx["counts"]
    train = cell.endswith(".train")
    assert c["rays"] == (ctx["steps"] * ctx["batch"] if train else ctx["rays"])
    assert 0 < c["shaded"] <= c["valid"]
    ops = field.flops(sp.config, c["valid"], c["shaded"], train)
    assert metrics.mfu(ctx) == pytest.approx(100 * ops / ctx["window_s"] / kernels.FP32_FLOP_PER_S)
    assert metrics.samples_per_unit(ctx) == c["valid"] / metrics.units(ctx)
