"""The port's occupancy module against the JAX package on the CPU: the plain
version of the K3 kernel (``occupancy_lookup_plain``) against
``grid_sample_3d(...) > 0`` and the bf16 parity-table lookup that the JAX
trainer runs, ``max_pool_3d``, the mask event's ``update_alpha_mask`` (with
and without a previous grid, and with nothing occupied), the ray filter,
the occupied-sample counts with their subsample and the auto capacity, and
``compute_alpha_grid_chunk``.

The JAX event functions are jitted in the JAX package; here they run under
``jax.disable_jit()``, op by op, since XLA's fused CPU loops contract
``o + d * t`` into an FMA that moves a sample on the box's face in or out
(as `tests/test_torch_train_parity.py` explains). Sizes: 16 x 16 planes,
grids of at most 16^3 voxels, a few hundred rays. Tolerances: the lookups,
volumes, keep-masks, counts and capacities exactly; the tight bbox to 1e-6;
alpha to 1e-5 (float32 decoders summed in another order).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ngf_tpu.fields import triplane as jt  # noqa: E402
from ngf_tpu.ops import grid_sample as j_gs  # noqa: E402
from ngf_tpu.render import volume as jv  # noqa: E402
from ngf_tpu.train import occupancy as j_occ  # noqa: E402
from ngf_tpu_torch import convert  # noqa: E402
from ngf_tpu_torch.fields import triplane as tt  # noqa: E402
from ngf_tpu_torch.ops import grid_sample as t_gs  # noqa: E402
from ngf_tpu_torch.render import volume as tv  # noqa: E402
from ngf_tpu_torch.train import occupancy as t_occ  # noqa: E402

AABB = np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32)
VOL_AABB = np.array([[-1.2, -1.3, -1.1], [1.4, 1.2, 1.3]], np.float32)
SHAPE = (12, 14, 16)  # (D, H, W): every axis its own size


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ball_volume(shape=SHAPE, seed=0) -> np.ndarray:
    """A ball of radius 0.6 in [-1, 1]^3 with random voxels flipped, then
    dilated by one voxel: a {0, 1} float32 volume like an event's."""
    D, H, W = shape
    z, y, x = np.meshgrid(*(np.linspace(-1, 1, s) for s in shape), indexing="ij")
    vol = (x * x + y * y + z * z < 0.36)
    vol ^= np.random.default_rng(seed).uniform(size=shape) < 0.05
    vol = np.asarray(j_gs.max_pool_3d(jnp.asarray(vol.astype(np.float32)), 3))
    return vol.astype(np.float32)


def _coords(kind: str, seed: int = 1, shape=SHAPE) -> np.ndarray:
    """(N, 3) coordinates, x -> W: random in [-1.1, 1.1]^3; exactly on texel
    centres; or on texel edges (half-integer texels), the faces at +-1 and
    just outside them."""
    D, H, W = shape
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.uniform(-1.1, 1.1, (3000, 3)).astype(np.float32)
    sizes = np.array([W, H, D])
    idx = rng.integers(0, sizes, (3000, 3)).astype(np.float32)
    if kind == "edges":
        idx += 0.5 * rng.integers(-1, 2, (3000, 3))
    c = (idx * 2.0 / (sizes - 1) - 1.0).astype(np.float32)
    if kind == "edges":
        c[:6] = [[1, 1, 1], [-1, -1, -1], [1.0001, 0, 0], [0, -1.0001, 0], [0, 0, 1], [-1, 0.3, 1]]
    return c


@pytest.mark.parametrize("kind", ["random", "centers", "edges"])
def test_occupancy_lookup_plain_matches_jax(kind):
    vol = _ball_volume()
    coords = _coords(kind)
    f32 = np.asarray(j_gs.grid_sample_3d(jnp.asarray(vol[..., None]), jnp.asarray(coords)))[..., 0] > 0
    table = j_gs.make_block_table_3d(jnp.asarray(vol[..., None], jnp.bfloat16))
    bf16 = np.asarray(j_gs.grid_sample_3d_blocks(table, vol.shape + (1,), jnp.asarray(coords)))
    bf16 = bf16[..., 0].astype(np.float32) > 0
    occ = torch.from_numpy(vol.astype(np.uint8))
    got = t_gs.occupancy_lookup_plain(occ, torch.from_numpy(coords)).numpy()
    np.testing.assert_array_equal(got, f32)
    np.testing.assert_array_equal(got, bf16)
    assert 0.05 < got.mean() < 0.95
    # The wrapper on the CPU is the plain version; a float volume tests > 0.
    np.testing.assert_array_equal(t_gs.occupancy_lookup(occ, torch.from_numpy(coords)).numpy(), f32)
    np.testing.assert_array_equal(
        t_gs.occupancy_lookup_plain(torch.from_numpy(vol), torch.from_numpy(coords)).numpy(), f32)


def test_occupancy_lookup_with_aabb_matches_jax_normalize():
    """World points normalised with the grid's box (the kernel's own
    ``normalize_coord``), in a strided (n, m, 3) view as the grouped path's
    query points are."""
    vol = _ball_volume(seed=2)
    pts = np.random.default_rng(3).uniform(-1.6, 1.6, (40, 64, 3)).astype(np.float32)
    coords = jv.normalize_coord(jnp.asarray(pts[:, 2::4]), jnp.asarray(VOL_AABB))
    want = np.asarray(j_gs.grid_sample_3d(jnp.asarray(vol[..., None]), coords))[..., 0] > 0
    got = t_gs.occupancy_lookup(torch.from_numpy(vol.astype(np.uint8)),
                                torch.from_numpy(pts)[:, 2::4], torch.from_numpy(VOL_AABB))
    assert got.shape == (40, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_max_pool_3d_matches_jax():
    vol = np.random.default_rng(4).normal(size=SHAPE).astype(np.float32)
    want = np.asarray(j_gs.max_pool_3d(jnp.asarray(vol), 3))
    np.testing.assert_array_equal(t_gs.max_pool_3d(torch.from_numpy(vol), 3).numpy(), want)


def _model(bias: float, seed: int = 0):
    """A 16^2 InfoInv model with planes 300 times their initial scale, so
    that density varies over space, and a density bias that puts the mask
    threshold inside its range: part of the lattice is occupied."""
    cfg = dataclasses.replace(jt.TriPlaneConfig.infoinv_preset(True), plane_res=16)
    params = jax.device_get(jt.init_triplane(jax.random.PRNGKey(seed), cfg))
    for name in ("plane_xy", "plane_yz", "plane_xz"):
        params[name] = params[name] * np.float32(300.0)
    params["density_decoder"]["mlp"]["layers"][-1]["b"] = np.full((1,), bias, np.float32)
    tcfg = tt.TriPlaneConfig(**dataclasses.asdict(cfg))
    return cfg, params, tcfg, convert.params_from_numpy(params, "cpu")


def _prev_grids(seed=5):
    vol = _ball_volume((16, 16, 16), seed)
    jgrid = j_occ.AlphaGrid(volume=jnp.asarray(vol), aabb=jnp.asarray(VOL_AABB)).build_table()
    tgrid = t_occ.AlphaGrid.from_volume(torch.from_numpy(vol), torch.from_numpy(VOL_AABB))
    return jgrid, tgrid


STEP = 0.1


@pytest.mark.parametrize("case", ["first", "with_prev", "empty"])
def test_update_alpha_mask_matches_jax(case):
    cfg, params, tcfg, tparams = _model(bias=-40.0 if case == "empty" else -1.0)
    grid = (13, 14, 16)  # (gx, gy, gz)
    jprev, tprev = _prev_grids() if case == "with_prev" else (None, None)
    with jax.disable_jit():
        jgrid, jbox = j_occ.update_alpha_mask(params, cfg, AABB, STEP, grid, 1e-4, prev=jprev,
                                              chunk=1000)
    tgrid, tbox = t_occ.update_alpha_mask(tparams, tcfg, AABB, STEP, grid, 1e-4, prev=tprev,
                                          chunk=777)
    want = np.asarray(jgrid.volume)
    assert want.shape == (16, 14, 13)
    np.testing.assert_array_equal(tgrid.volume.numpy(), want)
    np.testing.assert_array_equal(tgrid.occ.numpy(), want.astype(np.uint8))
    np.testing.assert_array_equal(tgrid.aabb.numpy(), AABB)
    np.testing.assert_allclose(tbox, jbox, atol=1e-6, rtol=0)
    if case == "empty":
        assert not want.any()
        np.testing.assert_array_equal(tbox, AABB)
    else:
        assert 0.02 < want.mean() < 0.98, want.mean()
        assert (np.asarray(jbox) != AABB).any()  # the tight box is tighter


def _rays(n=600, seed=6) -> np.ndarray:
    """Rays from a sphere of radius 4 aimed into [-3, 3]^3: some cross
    occupied space, some miss the grid."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-3.0, 3.0, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d], 1).astype(np.float32)


def test_filter_rays_and_counts_match_jax():
    jgrid, tgrid = _prev_grids(seed=7)
    rays = _rays()
    trays = torch.from_numpy(rays)
    with jax.disable_jit():
        keep = j_occ.filter_rays_alpha(rays, jgrid, AABB, 2.0, 6.0, STEP, chunk=250)
        counts = j_occ.occupied_samples_per_ray(rays, jgrid, AABB, 2.0, 6.0, STEP, 48,
                                                max_rays=400, chunk=150)
    got_keep = t_occ.filter_rays_alpha(trays, tgrid, AABB, 2.0, 6.0, STEP, chunk=170)
    np.testing.assert_array_equal(got_keep.numpy(), keep)
    assert 0 < keep.sum() < keep.size
    got = t_occ.occupied_samples_per_ray(trays, tgrid, AABB, 2.0, 6.0, STEP, 48,
                                         max_rays=400, chunk=130)
    assert got.shape == (400,)  # the same 400-ray subsample of 600
    np.testing.assert_array_equal(got, counts)
    assert counts.max() > 0
    for n_samples in (48, 1000):
        assert t_occ.auto_sample_cap(got, n_samples) == j_occ.auto_sample_cap(counts, n_samples)
    empty = np.zeros((0,), np.int64)
    assert t_occ.auto_sample_cap(empty, 48) == j_occ.auto_sample_cap(empty, 48) == 48


def test_dense_grid_points_match_jax():
    want = j_occ.dense_grid_points(AABB, (5, 7, 9))
    np.testing.assert_array_equal(t_occ.dense_grid_points(AABB, (5, 7, 9)).numpy(), want)


@pytest.mark.parametrize("with_alpha", [False, True])
def test_compute_alpha_grid_chunk_matches_jax(with_alpha):
    cfg, params, tcfg, tparams = _model(bias=4.0, seed=8)
    xyz = np.random.default_rng(9).uniform(-1.6, 1.6, (700, 3)).astype(np.float32)
    jgrid, tgrid = _prev_grids(seed=10)
    j_kw = dict(alpha_volume=jgrid.volume, alpha_aabb=jgrid.aabb, alpha_table=jgrid.table) if with_alpha else {}
    t_kw = dict(alpha_volume=tgrid.occ, alpha_aabb=tgrid.aabb) if with_alpha else {}
    want = np.asarray(jv.compute_alpha_grid_chunk(params, cfg, jnp.asarray(xyz), jnp.asarray(AABB),
                                                  STEP, **j_kw))
    got = tv.compute_alpha_grid_chunk(tparams, tcfg, torch.from_numpy(xyz), torch.from_numpy(AABB),
                                      STEP, **t_kw).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert want.max() > 1e-3
    if with_alpha:
        assert (want == 0).any() and (got[want == 0] == 0).all()
