"""The port's training slice against the JAX package on the CPU: the plane
gradient of the gather (plain version of the K2 kernel), the row gather
(plain version of the ``gather_rows`` kernel), the sampler, the optimizer,
the trainer's microbatching and random draws, the training CLI and
`chip_smoke.py`'s train phase. The trajectory against the JAX train step is
in `tests/test_torch_train_parity.py`.

Sizes are small (planes 32^2, 96-ray batches, 48 samples); every input comes
from a seed with numpy. Tolerances:
- plane gradients of the gather: GRAD_TOL = 1e-5 absolute, float32 sums of
  at most a few hundred weighted terms of O(1) in another order;
- the optimizer: rtol 1e-5 / atol 1e-7 per step, the same Adam float32
  arithmetic (bias corrections and the decay factor computed in another
  order and precision).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from ngf_tpu.data.sampler import SimpleSampler as JSampler  # noqa: E402
from ngf_tpu.fields import triplane as jt  # noqa: E402
from ngf_tpu.ops import grid_sample as j_gs  # noqa: E402
from ngf_tpu.render import volume as jv  # noqa: E402
from ngf_tpu.train import occupancy as j_occ  # noqa: E402
from ngf_tpu.train.state import make_optimizer, triplane_lr_tree  # noqa: E402
from ngf_tpu.utils import checkpoint as j_ckpt  # noqa: E402
from ngf_tpu.utils import metrics as j_metrics  # noqa: E402
from ngf_tpu_torch import convert  # noqa: E402
from ngf_tpu_torch.config import TrainArgs  # noqa: E402
from ngf_tpu_torch.data import load_dataset  # noqa: E402
from ngf_tpu_torch.data.sampler import SimpleSampler  # noqa: E402
from ngf_tpu_torch.fields import triplane as tt  # noqa: E402
from ngf_tpu_torch.ops import gather as t_gather  # noqa: E402
from ngf_tpu_torch.ops import grid_sample as t_gs  # noqa: E402
from ngf_tpu_torch.render import volume as tv  # noqa: E402
from ngf_tpu_torch.train import occupancy as t_occ  # noqa: E402
from ngf_tpu_torch.train.loop import TriPlaneTrainer  # noqa: E402
from ngf_tpu_torch.train.state import TriPlaneOptimizer  # noqa: E402
from ngf_tpu_torch.utils import checkpoint as t_ckpt  # noqa: E402
from ngf_tpu_torch.utils import metrics as t_metrics  # noqa: E402

GRAD_TOL = 1e-5
N_ITERS = 12
DATADIR = "synthetic:views=2,wh=16,test_views=1"

SPLITS = {"density": slice(0, 24), "appearance": slice(24, 96)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes here are too small to gain from
    more, and the test runner's parallel workers would oversubscribe the
    cores with a full thread pool each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plane(seed=0, res=32, c=96):
    return np.random.default_rng(seed).normal(0.0, 1.0, (res, res, c)).astype(np.float32)


def _scattered_coords(seed=1, n=500):
    """Uniform in [-1.2, 1.2]^2 with the corners, edge points exactly at +-1
    and points outside [-1, 1]."""
    c = np.random.default_rng(seed).uniform(-1.2, 1.2, (n, 2)).astype(np.float32)
    c[:8] = [[-1, -1], [1, 1], [-1, 1], [1, -1], [1, 0.3], [-0.4, -1], [1.0001, 0.2], [0.1, -1.5]]
    return c


def _ray_coords(seed=2, n_rays=24, m=16, res=32):
    """(n_rays, m, 2) ray-consecutive samples half a texel apart, as the
    duo backward requires: some rays cross the plane's border, one runs
    along x = +1 exactly."""
    rng = np.random.default_rng(seed)
    start = rng.uniform(-1.1, 1.1, (n_rays, 1, 2))
    d = rng.normal(size=(n_rays, 1, 2))
    d /= np.abs(d).max(-1, keepdims=True)
    step = 0.5 * 2.0 / (res - 1)
    c = start + d * step * np.arange(m)[None, :, None]
    c[0, :, 0] = 1.0
    return c.astype(np.float32)


def _jax_plane_cot(fn, plane, coords, g, ch):
    _, vjp = jax.vjp(lambda p: fn(p[..., ch], jnp.asarray(coords)), jnp.asarray(plane))
    return np.asarray(vjp(jnp.asarray(g))[0])


def _port_grad(plane, coords, g, ch):
    """The plane gradient through the port's autograd Function."""
    p = torch.from_numpy(plane).requires_grad_(True)
    out = t_gs.grid_sample_2d(p, torch.from_numpy(coords), ch)
    out.backward(torch.from_numpy(g))
    return p.grad.numpy()


@pytest.mark.parametrize("fetch", sorted(SPLITS))
def test_plain_backward_matches_jax_vjp(fetch):
    ch = SPLITS[fetch]
    plane, coords = _plane(), _scattered_coords()
    g = np.random.default_rng(3).normal(size=(coords.shape[0], ch.stop - ch.start)).astype(np.float32)
    want = _jax_plane_cot(j_gs.grid_sample_2d, plane, coords, g, ch)
    grad = torch.zeros(plane.shape)
    t_gs.grid_sample_2d_backward_plain(torch.from_numpy(g), torch.from_numpy(coords), grad, ch.start)
    np.testing.assert_allclose(grad.numpy(), want, atol=GRAD_TOL, rtol=0)
    np.testing.assert_allclose(_port_grad(plane, coords, g, ch), want, atol=GRAD_TOL, rtol=0)
    assert np.abs(want).max() > 0.1  # the gradient is not trivially zero


@pytest.mark.parametrize("fetch", sorted(SPLITS))
def test_plain_backward_matches_duobwd_nocoord(fetch):
    ch = SPLITS[fetch]
    plane, coords = _plane(4), _ray_coords()
    g = np.random.default_rng(5).normal(size=coords.shape[:-1] + (ch.stop - ch.start,))
    g = g.astype(np.float32)
    want = _jax_plane_cot(j_gs.grid_sample_2d_blocks_duobwd_nocoord, plane, coords, g, ch)
    grad = torch.zeros(plane.shape)
    t_gs.grid_sample_2d_backward_plain(torch.from_numpy(g), torch.from_numpy(coords), grad, ch.start)
    np.testing.assert_allclose(grad.numpy(), want, atol=GRAD_TOL, rtol=0)
    assert np.abs(want).max() > 0.1


def test_shared_plane_gradient_is_the_sum_of_both_fetches():
    """Density and appearance fetches of one shared plane add into one
    buffer; the result is both JAX plane cotangents summed, plus any other
    gradient of the plane (here an L1 term)."""
    plane, coords = _plane(6), _scattered_coords(7)
    rng = np.random.default_rng(8)
    gs = {k: rng.normal(size=(coords.shape[0], s.stop - s.start)).astype(np.float32)
          for k, s in SPLITS.items()}
    want = sum(_jax_plane_cot(j_gs.grid_sample_2d, plane, coords, gs[k], s) for k, s in SPLITS.items())
    want = want + 0.5 * np.sign(plane)
    p = torch.from_numpy(plane).requires_grad_(True)
    shared = t_gs.share_plane_grad(p)
    c = torch.from_numpy(coords)
    loss = sum((t_gs.grid_sample_2d(shared, c, s) * torch.from_numpy(gs[k])).sum()
               for k, s in SPLITS.items())
    (loss + 0.5 * p.abs().sum()).backward()
    np.testing.assert_allclose(p.grad.numpy(), want, atol=GRAD_TOL, rtol=0)


def test_gather_rows_plain_matches_probe_reference():
    """The probes' own shapes and reference (`tools/probe_pallas.py:29-40`)."""
    tab = np.arange(512 * 128, dtype=np.float32).reshape(512, 128)
    idx = (np.arange(256, dtype=np.int32) * 7) % 512
    want = np.asarray(tab)[np.asarray(idx)]
    for fn in (t_gather.gather_rows_plain, t_gather.gather_rows):
        got = fn(torch.from_numpy(tab), torch.from_numpy(idx).long())
        np.testing.assert_array_equal(got.numpy(), want)


def test_sampler_ids_match_jax():
    ours, theirs = SimpleSampler(1000, 96, seed=20211202), JSampler(1000, 96, seed=20211202)
    for _ in range(25):  # crosses two epoch reshuffles
        np.testing.assert_array_equal(ours.nextids(), theirs.nextids())
    ours, theirs = SimpleSampler(50, 96, seed=3), JSampler(50, 96, seed=3)
    np.testing.assert_array_equal(ours.nextids(), theirs.nextids())


def test_filter_rays_bbox_matches_jax():
    rng = np.random.default_rng(9)
    rays = np.concatenate([rng.uniform(-5, 5, (3000, 3)), rng.normal(size=(3000, 3))], 1)
    rays[:, 3:] /= np.linalg.norm(rays[:, 3:], axis=-1, keepdims=True)
    rays = rays.astype(np.float32)
    aabb = np.asarray([[-1.5] * 3, [1.5] * 3], np.float32)
    want = j_occ.filter_rays_bbox(rays, aabb, chunk=1000)
    got = t_occ.filter_rays_bbox(rays, aabb, chunk=700)
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.size


def test_density_l1_and_tv_match_jax():
    rng = np.random.default_rng(10)
    params = {n: rng.normal(size=(9, 7, 5)).astype(np.float32)
              for n in ("plane_xy", "plane_yz", "plane_xz")}
    tp = convert.params_from_numpy(params, "cpu")
    np.testing.assert_allclose(float(tt.density_l1(tp)), float(jt.density_l1(params)), rtol=1e-6)
    np.testing.assert_allclose(float(t_metrics.tv_loss_2d(tp["plane_xy"], 0.3)),
                               float(j_metrics.tv_loss_2d(jnp.asarray(params["plane_xy"]), 0.3)),
                               rtol=1e-5)


def _small_tree(rng):
    return {
        "plane_xy": rng.normal(size=(4, 5, 6)).astype(np.float32),
        "gauge_xy": rng.normal(size=(3, 3, 2)).astype(np.float32),
        "rgb_decoder": {"mlp": {"layers": [{"w": rng.normal(size=(6, 3)).astype(np.float32),
                                            "b": rng.normal(size=(3,)).astype(np.float32)}]}},
    }


def test_optimizer_matches_jax():
    """Per-group rates, Adam (0.9, 0.99, 1e-8) and the decay over 12 steps
    fed the same gradients (`ngf_tpu/train/state.py:make_optimizer`)."""
    rng = np.random.default_rng(11)
    params = _small_tree(rng)
    opt = make_optimizer(triplane_lr_tree(params, 0.02, 1e-3), 0.1, N_ITERS)
    state = opt.init(params)
    tparams = jax.tree.map(lambda a: torch.from_numpy(a.copy()).requires_grad_(True), params)
    topt = TriPlaneOptimizer(tparams, 0.02, 1e-3, 0.1, N_ITERS)
    jparams = params
    for _ in range(N_ITERS):
        grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        updates, state = opt.update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for (_, p), (_, gr) in zip(convert.named_leaves(tparams), convert.named_leaves(grads)):
            p.grad = torch.from_numpy(gr)
        topt.step()
        for (name, p), (_, w) in zip(convert.named_leaves(tparams), convert.named_leaves(jparams)):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-7,
                                       err_msg=name)
    assert topt.count == N_ITERS


# ---------------------------------------------------------------- the slice


def _args(infoinv, **kw):
    return TrainArgs(
        dataset_name="synthetic", datadir=DATADIR, subsystem="infoinv", infoinv=infoinv,
        plane_res=32, gauge_res=32, nSamples=48, step_ratio=1.0, batch_size=96,
        n_iters=N_ITERS, group_size=0, device="cpu", **kw,
    )


def _trainer(infoinv, init_params=None):
    ds = load_dataset("synthetic", DATADIR, split="train", is_stack=False)
    return TriPlaneTrainer(_args(infoinv), ds, init_params=init_params, device="cpu"), ds


def test_microbatch_gradient_equals_full_batch():
    trainer, ds = _trainer(True)
    rays, rgbs = trainer.next_batch()
    trainer.compute_grads(rays, rgbs)
    full = {n: p.grad.clone() for n, p in convert.named_leaves(trainer.params)}
    trainer.args.microbatch = 3
    trainer.compute_grads(rays, rgbs)
    for n, p in convert.named_leaves(trainer.params):
        # The mean of three chunk means is the batch mean: float32 sums in
        # another order.
        torch.testing.assert_close(p.grad, full[n], rtol=1e-4, atol=1e-7, msg=n)


def test_train_render_draws_from_generator():
    """Training renders jitter each ray and, without a white background,
    mix in the background from the generator: the same seed repeats them,
    another seed moves them; the depth carries no gradient."""
    trainer, _ = _trainer(True)
    rcfg = dataclasses.replace(trainer._render_cfg(), white_bg=False)
    rays, _ = trainer.next_batch()

    def render(seed):
        g = None if seed is None else torch.Generator().manual_seed(seed)
        return tv.render_rays(trainer.params, trainer.model_cfg, rcfg, rays, generator=g)

    a, b, c, ev = render(1), render(1), render(2), render(None)
    torch.testing.assert_close(a["rgb_map"], b["rgb_map"], rtol=0, atol=0)
    assert (a["depth_map"] - c["depth_map"]).abs().max() > 1e-4
    assert (a["depth_map"] - ev["depth_map"]).abs().max() > 1e-4
    assert a["rgb_map"].requires_grad and not a["depth_map"].requires_grad


def test_cli_train_on_cpu_writes_checkpoint_jax_reads(tmp_path):
    import main_torch

    argv = ["--config", os.path.join(REPO, "configs", "synthetic_infoinv_tpu.txt"),
            "--group_size", "0", "--n_iters", "6", "--device", "cpu", "--datadir", DATADIR,
            "--plane_res", "32", "--nSamples", "48", "--batch_size", "96",
            "--open_sample_cap", "32", "--render_test", "1", "--basedir", str(tmp_path),
            "--expname", "run", "--progress_refresh_rate", "3"]
    out = main_torch.main(argv)
    assert out["iterations"] == 6 and len(out["train_mses"]) == 6
    assert np.isfinite(out["train_mses"]).all() and len(out["test_psnrs"]) == 1
    run = tmp_path / "run"
    assert (run / "imgs_test_all" / "000.png").is_file()
    assert len((run / "log.txt").read_text().splitlines()) == 2
    jparams, meta, vol, _ = j_ckpt.load_checkpoint(str(run / "model.npz"))
    assert vol is None and meta["iteration"] == 6
    assert jparams["plane_xy"].shape == (32, 32, 96)
    cfg = jt.TriPlaneConfig(**meta["model_cfg"])
    rays = np.asarray(load_dataset("synthetic", DATADIR, split="test").all_rays[0][:64])
    rcfg = dict(aabb=tuple(map(tuple, meta["aabb"])), n_samples=40, step_size=meta["step_size"])
    want = jv.render_rays(jparams, cfg, jv.RenderConfig(**rcfg), jnp.asarray(rays), None, is_train=False)
    tparams = t_ckpt.load_checkpoint(str(run / "model.npz"), "cpu")[0]
    got = tv.render_rays(tparams, tt.TriPlaneConfig(**meta["model_cfg"]), tv.RenderConfig(**rcfg),
                         torch.from_numpy(rays))
    np.testing.assert_allclose(got["rgb_map"].detach().numpy(), np.asarray(want["rgb_map"]),
                               rtol=1e-4, atol=1e-4)


def test_chip_smoke_train_phase_on_cpu():
    """`chip_smoke.py`'s train phase at a tiny size on the CPU (plain
    versions): the CLI run and its checks, and the kernels-vs-plain step
    comparison on the trained and on the opaque weights. ``density_shift
    0`` starts the field opaque, so the loss falls from the first step: from
    the default transparent start it stays on a plateau for over a hundred
    steps at any size."""
    import chip_smoke

    out = chip_smoke.train_phase(
        torch.device("cpu"), iters=12, views=2, wh=16,
        extra=("--plane_res", "32", "--nSamples", "48", "--batch_size", "256",
               "--open_sample_cap", "32", "--density_shift", "0"),
    )
    assert len(out["mses"]) == 12 and np.isfinite(out["test_psnr"])
    opaque = out["compare"]["opaque"]
    assert opaque["max_abs_appearance_grad"] > 0
    assert 0 <= opaque["zero_row_share"]["appearance"] < 1
