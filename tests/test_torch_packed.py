"""The packed training render of the grouped path on the CPU.

A grouped training render with dense shading and no ``sample_fn`` decodes
only its kept groups: their slot ids read from K4's ``got``, their rows
gathered (``gather_rows``), decoded and written back into the slot layout
(``ops/gather.py:scatter_rows``, backward ``gather_rows``). Here, on sparse
occupancy volumes (most voxels empty, so that under half of the slots hold
a sample):

- InfoInv (with its PE) and the learned gauge against `ngf_tpu`'s grouped
  training render on the same jitter: rgb, acc, depth, ``shaded_groups``
  and every parameter leaf's gradient (``jax.grad``, compiled);
- a batch with no kept group renders the background and gives every leaf
  a gradient, all zero;
- ``microbatch`` 2 gives the gradients of ``microbatch`` 1 on the same
  batch and jitter;
- under tracing, ``slots`` counts the packed rows in training and every
  slot (``n * capg * G``) where the render is not packed: evaluation, top-K
  shading, a ``sample_fn``;
- ``scatter_rows`` is the converse of ``gather_rows``: its rows written at
  the ids, zeros elsewhere, and its gradient the gather at the same ids.

Tolerances are those of `tests/test_torch_grouped.py`: outputs 1e-4,
``shaded_groups`` exactly, gradients 1e-4 of each leaf's largest (the
InfoInv PE's last-ulp sin/cos); microbatch against one chunk 1e-5 of each
leaf's largest (the same float32 sums in another order).
"""

import dataclasses
import os
import sys
import types

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from test_torch_render import AABB, ALPHA_AABB, STEP, _model, _rays  # noqa: E402
from test_torch_topk import _gauge_model  # noqa: E402

from ngf_tpu.render import volume as jv  # noqa: E402
from ngf_tpu.train import occupancy as j_occ  # noqa: E402
from ngf_tpu_torch import convert  # noqa: E402
from ngf_tpu_torch.config import TrainArgs  # noqa: E402
from ngf_tpu_torch.convert import named_leaves  # noqa: E402
from ngf_tpu_torch.data import load_dataset  # noqa: E402
from ngf_tpu_torch.fields import triplane as tt  # noqa: E402
from ngf_tpu_torch.ops import gather as t_gather  # noqa: E402
from ngf_tpu_torch.ops.compaction import group_sample_compact  # noqa: E402
from ngf_tpu_torch.render import volume as tv  # noqa: E402
from ngf_tpu_torch.train.loop import TriPlaneTrainer  # noqa: E402
from ngf_tpu_torch.utils import profiling  # noqa: E402

RENDER_TOL = 1e-4
GRAD_REL_TOL = 1e-4
MICRO_TOL = 1e-5
G = 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sparse_volume(seed=0, shape=(12, 12, 12), keep=0.2):
    """A {0, 1} occupancy volume with about ``keep`` of its voxels set."""
    return (np.random.default_rng(seed).uniform(size=shape) < keep).astype(np.float32)


def _variant(variant):
    if variant == "gauge":
        return _gauge_model()
    return _model(infoinv=True)


def _rcfgs(**kw):
    kw = dict(aabb=AABB, n_samples=52, step_size=STEP, group_size=G, tile_q=0, **kw)
    return jv.RenderConfig(**kw), tv.RenderConfig(**kw)


def _jitter(n, seed=11):
    return np.random.default_rng(seed).uniform(size=(n, 1)).astype(np.float32)


def _port_render(cfg, params, rcfg, rays, vol, jitter, monkeypatch, **kw):
    """The port's training render with the given jitter; every leaf takes a
    gradient. Returns (outputs, leaves)."""
    monkeypatch.setattr(tv, "_ray_jitter", lambda g, n, device: torch.from_numpy(jitter))
    tparams = convert.params_from_numpy(params, "cpu")
    for _, p in named_leaves(tparams):
        p.requires_grad_(True)
    out = tv.render_rays(tparams, tt.TriPlaneConfig(**dataclasses.asdict(cfg)), rcfg,
                         torch.from_numpy(rays), iteration=3, generator=torch.Generator(),
                         alpha_volume=torch.from_numpy(vol.astype(np.uint8)),
                         alpha_aabb=torch.from_numpy(ALPHA_AABB), **kw)
    return out, tparams


def _kept_groups(rays, vol, jitter, capg):
    _, got, _, vmask, _ = group_sample_compact(
        torch.from_numpy(rays), None if jitter is None else torch.from_numpy(jitter),
        torch.tensor(AABB), 2.0, 6.0, 52, STEP, G,
        capg, torch.from_numpy(vol.astype(np.uint8)), torch.from_numpy(ALPHA_AABB), indices=True)
    return int(got.sum()), float(vmask.sum())


@pytest.mark.parametrize("variant", ["infoinv", "gauge"])
def test_packed_training_render_and_leaf_gradients_match_jax(variant, monkeypatch):
    cfg, params = _variant(variant)
    jr, tr = _rcfgs()
    rays = _rays()
    n, capg = rays.shape[0], -(-52 // G)
    vol = _sparse_volume()
    key = jax.random.PRNGKey(5)
    # The JAX path's jitter (`ngf_tpu/ops/rays.py:89-90`), given to the port.
    k_jit, _ = jax.random.split(key)
    jitter = np.array(jax.random.uniform(k_jit, (n, 1), dtype=jnp.float32))
    groups, kept = _kept_groups(rays, vol, jitter, capg)
    # Sparse: under half the slots hold a sample, and packing drops rows.
    assert kept < 0.5 * n * capg * G and 0 < groups < n * capg
    g = np.random.default_rng(2).normal(size=(n, 3)).astype(np.float32)
    jgrid = j_occ.AlphaGrid(volume=jnp.asarray(vol), aabb=jnp.asarray(ALPHA_AABB)).build_table()

    def j_loss(p):
        out = jv.render_rays(p, cfg, jr, jnp.asarray(rays), key, is_train=True, iteration=3,
                             alpha_volume=jgrid.volume, alpha_aabb=jgrid.aabb,
                             alpha_table=jgrid.table)
        return jnp.sum(out["rgb_map"] * g) + jnp.sum(out["acc_map"]), out

    (_, want), grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    out, tparams = _port_render(cfg, params, tr, rays, vol, jitter, monkeypatch)
    ((out["rgb_map"] * torch.from_numpy(g)).sum() + out["acc_map"].sum()).backward()
    assert 0.02 < float(out["acc_map"].detach().mean()) < 0.98
    for k in ("rgb_map", "depth_map", "acc_map"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(want[k]), rtol=RENDER_TOL,
                                   atol=RENDER_TOL, err_msg=k)
    assert out["shaded_groups"].dtype == torch.int32
    np.testing.assert_array_equal(out["shaded_groups"].numpy(), np.asarray(want["shaded_groups"]))
    want_leaves = dict(named_leaves(convert.params_from_numpy(jax.device_get(grads), "cpu")))
    for leaf, p in named_leaves(tparams):
        w = want_leaves[leaf].numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=GRAD_REL_TOL * scale,
                                   err_msg=leaf)
    if variant == "gauge":
        assert float(tparams["gauge_xy"].grad.abs().max()) > 0


@pytest.mark.parametrize("variant", ["infoinv", "gauge"])
def test_batch_without_kept_groups_renders_background_with_zero_gradients(variant, monkeypatch):
    cfg, params = _variant(variant)
    _, tr = _rcfgs()
    rays = _rays()
    vol = np.zeros((12, 12, 12), np.float32)
    jitter = _jitter(rays.shape[0])
    assert _kept_groups(rays, vol, jitter, -(-52 // G))[0] == 0
    out, tparams = _port_render(cfg, params, tr, rays, vol, jitter, monkeypatch)
    (out["rgb_map"].sum() + out["acc_map"].sum()).backward()
    assert bool((out["rgb_map"] == 1.0).all()) and bool((out["acc_map"] == 0).all())
    assert bool((out["shaded_groups"] == 0).all())
    for leaf, p in named_leaves(tparams):
        assert p.grad is not None, leaf
        assert bool((p.grad == 0).all()), leaf


DATADIR = "synthetic:views=2,wh=16,test_views=1"


def _trainer(tmp_path, microbatch):
    args = TrainArgs(dataset_name="synthetic", datadir=DATADIR, subsystem="infoinv", infoinv=True,
                     plane_res=32, nSamples=48, step_ratio=1.0, batch_size=96, n_iters=1,
                     group_size=G, open_sample_cap=32, device="cpu", N_vis=0, seed=5,
                     microbatch=microbatch)
    ds = load_dataset("synthetic", DATADIR, split="train", is_stack=False)
    trainer = TriPlaneTrainer(args, ds, logfolder=str(tmp_path / f"m{microbatch}"), device="cpu")
    occ = torch.from_numpy(_sparse_volume(3, (16, 16, 16), 0.15).astype(np.uint8))
    trainer.alpha = types.SimpleNamespace(occ=occ, aabb=torch.tensor(trainer.aabb, dtype=torch.float32))
    return trainer


def test_microbatch_two_matches_one(tmp_path, monkeypatch):
    a, b = _trainer(tmp_path, 1), _trainer(tmp_path, 2)
    leaves_a, leaves_b = dict(named_leaves(a.params)), dict(named_leaves(b.params))
    for k in leaves_a:
        assert torch.equal(leaves_a[k], leaves_b[k]), k
    rays, rgbs = a.all_rays[:96].clone(), a.all_rgbs[:96].clone()
    jitter = torch.from_numpy(_jitter(96))
    # Each render takes the next rows of the batch's jitter.
    at = [0]

    def rows_of_batch(g, n, device):
        out = jitter[at[0]:at[0] + n]
        at[0] = (at[0] + n) % 96
        return out

    monkeypatch.setattr(tv, "_ray_jitter", rows_of_batch)
    packed = []
    pack_map = tv._pack_map

    def spy(got):
        ids = pack_map(got)
        packed.append(ids.shape[0] < got.numel())
        return ids

    monkeypatch.setattr(tv, "_pack_map", spy)
    mse_a, mse_b = float(a.compute_grads(rays, rgbs, torch.Generator())), float(
        b.compute_grads(rays, rgbs, torch.Generator()))
    assert packed == [True] * 3  # one render of 96 rays, then two of 48, each packed
    assert abs(mse_a - mse_b) <= 1e-6 * mse_a
    for k, p in leaves_a.items():
        want, got = p.grad, leaves_b[k].grad
        scale = float(want.abs().max())
        assert scale > 0, k
        assert float((got - want).abs().max()) <= MICRO_TOL * scale, k


# (mode, RenderConfig overrides, training, sample_fn): packed only in the first.
SLOT_CASES = [("train", {}, True, False), ("eval", {}, False, False),
              ("train_topk", {"rgb_cap": 16}, True, False),
              ("train_sample_fn", {}, True, True)]


@pytest.mark.parametrize("mode,kw,train,with_fn", SLOT_CASES, ids=[c[0] for c in SLOT_CASES])
def test_slots_count_the_rows_the_field_decodes(mode, kw, train, with_fn, tmp_path):
    cfg, params = _model(infoinv=True)
    _, tr = _rcfgs(**kw)
    rays = _rays()
    n, capg = rays.shape[0], -(-52 // G)
    vol = _sparse_volume()
    jitter = _jitter(n)
    tparams = convert.params_from_numpy(params, "cpu")
    fn = None
    if with_fn:
        from ngf_tpu_torch.ops.grid_sample import grid_sample_2d_plain

        def fn(plane, coords, name):
            return grid_sample_2d_plain(plane, coords)

    tv_jitter = tv._ray_jitter
    tv._ray_jitter = lambda g, n, device: torch.from_numpy(jitter)
    try:
        with profiling.trace(str(tmp_path / "tb")):
            tv.render_rays(tparams, tt.TriPlaneConfig(**dataclasses.asdict(cfg)), tr,
                           torch.from_numpy(rays), iteration=3,
                           generator=torch.Generator() if train else None,
                           alpha_volume=torch.from_numpy(vol.astype(np.uint8)),
                           alpha_aabb=torch.from_numpy(ALPHA_AABB), sample_fn=fn)
    finally:
        tv._ray_jitter = tv_jitter
    c = profiling.report()["counters"]
    groups, kept = _kept_groups(rays, vol, jitter if train else None, capg)
    want = groups if mode == "train" else n * capg
    assert c["rays"] == n and c["slots"] == want * G
    assert c["kept"] == kept > 0
    if mode == "train":
        assert 0.5 < c["kept"] / c["slots"] <= 1.0 and want < n * capg


@pytest.mark.parametrize("count", [1, 8])
def test_scatter_rows_is_the_converse_of_gather_rows(count):
    rows, D = 12, 6
    src = torch.randn((count, D), generator=torch.Generator().manual_seed(1), requires_grad=True)
    idx = torch.tensor([7, 0, 3, 11, 5, 2, 9, 4])[:count]
    out = t_gather.scatter_rows(src, idx, rows)
    want = torch.zeros((rows, D))
    want[idx] = src.detach()
    assert torch.equal(out.detach(), want)
    g = torch.randn((rows, D), generator=torch.Generator().manual_seed(2))
    (out * g).sum().backward()
    assert torch.equal(src.grad, g[idx])
    assert torch.equal(t_gather.gather_rows(out.detach(), idx), src.detach())
