"""The port's grouped render path against the JAX package on the CPU: the
compaction of the front end (``group_compact_plain``, built from
``group_compact_indices`` and ``gather_groups``) against `ngf_tpu`'s, the
plain version of the K4 kernel (``group_sample_compact_plain``, the whole
front end from the rays to the kept samples' coordinates) against the JAX
front end composed op by op, and ``render_rays(group_size > 0)`` against
``_render_rays_grouped`` (`ngf_tpu/render/volume.py:170-372`): G = 8 (two
occupancy queries a group) and G = 3 (one, at the centre; 52 samples pad to
54), with and without an occupancy mask (the JAX side with the bf16 parity
table its trainer builds), a sample capacity that truncates, evaluation and
training mode with the same jitter injected into both, and the plane
gradients against ``jax.vjp``.

Scene and model as `tests/test_torch_render.py` has them (16 x 16 planes,
an 8 x 8 view, 52 samples at step 0.1). Tolerances: the compaction, the
front end's outputs (coordinates included) and ``shaded_groups`` exactly; rgb, depth and acc 1e-4 (float32 sums over the
samples of fields that agree to ~1e-5, the InfoInv PE's last-ulp sin/cos);
plane gradients 1e-4 of the largest (they run back through the InfoInv
appearance PE, as `tests/test_torch_fused_fetch.py` states).
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
from test_torch_render import AABB, ALPHA_AABB, STEP, _alpha_volume, _model, _rays  # noqa: E402

from ngf_tpu.ops import compaction as j_comp  # noqa: E402
from ngf_tpu.ops import rays as j_rays  # noqa: E402
from ngf_tpu.render import volume as jv  # noqa: E402
from ngf_tpu.train import occupancy as j_occ  # noqa: E402
from ngf_tpu_torch import convert  # noqa: E402
from ngf_tpu_torch.fields import triplane as tt  # noqa: E402
from ngf_tpu_torch.ops import compaction as t_comp  # noqa: E402
from ngf_tpu_torch.render import volume as tv  # noqa: E402

RENDER_TOL = 1e-4
GRAD_REL_TOL = 1e-4
PLANES = ("plane_xy", "plane_yz", "plane_xz")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _compaction_inputs(n=40, S=53, G=4, seed=0):
    """(z (n, s_pad), valid (n, s_pad)) padded as the renderer pads them
    (edge depths, invalid pad samples): rays of scattered valid runs, one
    ray with none, one with all."""
    ng = -(-S // G)
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(2.0, 6.0, (n, S)), axis=-1).astype(np.float32)
    valid = rng.uniform(size=(n, S)) < np.linspace(0.02, 0.6, n)[:, None]
    valid[0] = False
    valid[1] = True
    pad = ng * G - S
    z = np.concatenate([z, np.repeat(z[:, -1:], pad, 1)], 1)
    valid = np.concatenate([valid, np.zeros((n, pad), bool)], 1)
    return z, valid, ng


@pytest.mark.parametrize("capg", [3, 8, 14])  # 14 = ng: no truncation
def test_group_compaction_matches_jax(capg):
    G = 4
    z, valid, ng = _compaction_inputs(G=G)
    gvalid = valid.reshape(z.shape[0], ng, G).any(-1)
    assert (gvalid.sum(-1) > 3).any() and not gvalid[0].any()
    j_idx, j_got = j_comp.group_compact_indices(jnp.asarray(gvalid), capg)
    idx, got = t_comp.group_compact_indices(torch.from_numpy(gvalid), capg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_got))
    assert idx.dtype == torch.int32
    payload = np.stack([z, valid.astype(np.float32)], -1)
    j_sel = np.asarray(j_comp.gather_groups(jnp.asarray(payload), j_idx, G))
    np.testing.assert_array_equal(
        t_comp.gather_groups(torch.from_numpy(payload), idx, G).numpy(), j_sel)
    # The compaction of the front end's plain version, as
    # `ngf_tpu/render/volume.py:257-260` composes it.
    j_vmask = j_sel[..., 1] * np.repeat(np.asarray(j_got).astype(np.float32), G, axis=1)
    i2, g2, z_c, vmask = t_comp.group_compact_plain(torch.from_numpy(z), torch.from_numpy(valid),
                                                    G, capg)
    np.testing.assert_array_equal(i2.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(g2.numpy(), np.asarray(j_got))
    np.testing.assert_array_equal(z_c.numpy(), j_sel[..., 0])
    np.testing.assert_array_equal(vmask.numpy(), j_vmask)
    # Pad slots hold group 0's depths; an all-invalid ray holds only those.
    np.testing.assert_array_equal(z_c[0].numpy(), np.tile(z[0, :G], capg))


def _configs(G, sample_cap, fused_fetch=True):
    """The JAX and port render configurations; the port's ``fused_fetch``
    matters only to top-K shading (`tests/test_torch_topk.py`): without it
    both values fetch through one K1 launch."""
    kw = dict(aabb=AABB, n_samples=52, step_size=STEP, group_size=G, sample_cap=sample_cap,
              tile_q=0)
    return jv.RenderConfig(**kw, fused_fetch=fused_fetch), tv.RenderConfig(**kw)


def _alpha_both(seed=0):
    vol = _alpha_volume(seed)
    jgrid = j_occ.AlphaGrid(volume=jnp.asarray(vol), aabb=jnp.asarray(ALPHA_AABB)).build_table()
    t_kw = dict(alpha_volume=torch.from_numpy(vol.astype(np.uint8)),
                alpha_aabb=torch.from_numpy(ALPHA_AABB))
    j_kw = dict(alpha_volume=jgrid.volume, alpha_aabb=jgrid.aabb, alpha_table=jgrid.table)
    return j_kw, t_kw


def _render_grouped_both(G, sample_cap, with_alpha, train, monkeypatch, fused_fetch=True, seed=0):
    cfg, params = _model(seed)
    jr, tr = _configs(G, sample_cap, fused_fetch)
    rays = _rays()
    j_kw, t_kw = _alpha_both(seed) if with_alpha else ({}, {})
    key = jax.random.PRNGKey(seed + 11) if train else None
    want = jv.render_rays(params, cfg, jr, jnp.asarray(rays), key, is_train=train, iteration=3,
                          **j_kw)
    gen = None
    if train:
        # The jitter the JAX path draws (`ngf_tpu/ops/rays.py:89-90`),
        # injected into the port's draw.
        k_jit, _ = jax.random.split(key)
        jitter = np.array(jax.random.uniform(k_jit, (rays.shape[0], 1), dtype=jnp.float32))
        monkeypatch.setattr(tv, "_ray_jitter", lambda g, n, device: torch.from_numpy(jitter))
        gen = torch.Generator()
    tparams = convert.params_from_numpy(params, "cpu")
    got = tv.render_rays(tparams, tt.TriPlaneConfig(**dataclasses.asdict(cfg)), tr,
                         torch.from_numpy(rays), iteration=3, generator=gen, **t_kw)
    return got, want


# (G, sample_cap, mask, mode): both query layouts, with and without a
# truncating capacity, open and masked, evaluation and training.
CASES = [(8, 0, False, "eval"), (8, 0, True, "eval"), (8, 24, True, "eval"),
         (8, 0, False, "train"), (8, 24, True, "train"), (3, 0, False, "eval"),
         (3, 0, True, "eval"), (3, 20, True, "train")]


@pytest.mark.parametrize("G,sample_cap,with_alpha,mode", CASES,
                         ids=[f"g{g}_cap{c}_{'masked' if a else 'open'}_{m}" for g, c, a, m in CASES])
def test_grouped_render_matches_jax(G, sample_cap, with_alpha, mode, monkeypatch):
    got, want = _render_grouped_both(G, sample_cap, with_alpha, mode == "train", monkeypatch)
    acc = got["acc_map"].detach().numpy()
    assert 0.02 < acc.mean() < 0.98, acc.mean()
    for k in ("rgb_map", "depth_map", "acc_map"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=RENDER_TOL,
                                   atol=RENDER_TOL, err_msg=k)
    if mode == "train":
        assert got["shaded_groups"].dtype == torch.int32
        np.testing.assert_array_equal(got["shaded_groups"].numpy(), np.asarray(want["shaded_groups"]))
        assert got["shaded_groups"].numpy().max() > 0
    else:
        assert "shaded_groups" not in got


def test_grouped_separate_fetches_give_the_same_values(monkeypatch):
    """The JAX package's ``fused_fetch 0`` (separate fetches) renders the
    values the port's one fused fetch renders."""
    got, want = _render_grouped_both(8, 24, True, False, monkeypatch, fused_fetch=False)
    for k in ("rgb_map", "depth_map", "acc_map"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RENDER_TOL,
                                   atol=RENDER_TOL, err_msg=k)


def test_grouped_knob_preconditions_are_kept():
    cfg, params = _model()
    tparams = convert.params_from_numpy(params, "cpu")
    tcfg = tt.TriPlaneConfig(**dataclasses.asdict(cfg))
    rays = torch.from_numpy(_rays(wh=2))
    for kw, msg in (({"pair_gather": True}, "pair_gather"), ({"duo_bwd": True}, "duo_bwd"),
                    ({"tile_q": 2, "run_len": 4}, "run_len")):
        rcfg = tv.RenderConfig(aabb=AABB, n_samples=52, step_size=STEP, group_size=3, **kw)
        with pytest.raises(ValueError, match=msg):
            tv.render_rays(tparams, tcfg, rcfg, rays)


def test_grouped_plane_gradients_match_jax_vjp():
    """Masked, with a truncating capacity."""
    cfg, params = _model(seed=1)
    jr, tr = _configs(8, 24)
    rays = _rays()  # the shapes of the render cases: JAX reuses their ops
    j_kw, t_kw = _alpha_both(1)
    g = np.random.default_rng(2).normal(size=(rays.shape[0], 3)).astype(np.float32)

    def j_loss(planes):
        p = {**params, **planes}
        out = jv.render_rays(p, cfg, jr, jnp.asarray(rays), None, is_train=False, **j_kw)
        return jnp.sum(out["rgb_map"] * g) + jnp.sum(out["acc_map"])

    want = jax.grad(j_loss)({n: jnp.asarray(params[n]) for n in PLANES})
    tparams = convert.params_from_numpy(params, "cpu")
    for n in PLANES:
        tparams[n].requires_grad_(True)
    out = tv.render_rays(tparams, tt.TriPlaneConfig(**dataclasses.asdict(cfg)), tr,
                         torch.from_numpy(rays), **t_kw)
    ((out["rgb_map"] * torch.from_numpy(g)).sum() + out["acc_map"].sum()).backward()
    scale = max(float(np.abs(np.asarray(want[n])).max()) for n in PLANES)
    assert scale > 1e-3
    for n in PLANES:
        np.testing.assert_allclose(tparams[n].grad.numpy(), np.asarray(want[n]), rtol=0,
                                   atol=GRAD_REL_TOL * scale, err_msg=n)


def _front_end_rays():
    """The 8 x 8 view's rays, one along -z (zero x and y direction
    components) through the box, and one that misses it."""
    extra = [[0.3, -0.2, 4.0, 0.0, 0.0, -1.0], [4.0, 4.0, 4.0, 1.0, 0.0, 0.0]]
    return np.concatenate([_rays(), extra]).astype(np.float32)


def _jax_front_end(rays, G, capg, jgrid, key):
    """The JAX grouped front end (`ngf_tpu/render/volume.py:218-264`) op by
    op under ``jax.disable_jit()``: (idx, got, z_c, vmask, xyz_n)."""
    S, n = 52, rays.shape[0]
    ng = -(-S // G)
    s_pad = ng * G
    aabb = jnp.asarray(AABB, jnp.float32)
    ro, rd = jnp.asarray(rays[:, :3]), jnp.asarray(rays[:, 3:])
    with jax.disable_jit():
        pts, z, valid = j_rays.stratified_sample(key, ro, rd, aabb, 2.0, 6.0, S, STEP,
                                                 key is not None)
        valid = valid & (jnp.arange(S) < S - 1)
        pts = jnp.pad(pts, ((0, 0), (0, s_pad - S), (0, 0)), mode="edge")
        z = jnp.pad(z, ((0, 0), (0, s_pad - S)), mode="edge")
        valid = jnp.pad(valid, ((0, 0), (0, s_pad - S)))
        if jgrid is not None:
            q, per = (pts[:, G // 4 :: G // 2], G // 2) if G >= 4 and G % 2 == 0 else (
                pts[:, G // 2 :: G], G)
            occ = jv._sample_alpha_volume(jgrid.volume, jv.normalize_coord(q, jgrid.aabb),
                                          jgrid.table) > 0
            valid = valid & jnp.repeat(occ, per, axis=1)
        idx, got = j_comp.group_compact_indices(valid.reshape(n, ng, G).any(-1), capg)
        sel = j_comp.gather_groups(jnp.stack([z, valid.astype(z.dtype)], -1), idx, G)
        vmask = sel[..., 1] * jnp.repeat(got.astype(sel.dtype), G, axis=1)
        xyz_n = jv.normalize_coord(ro[:, None, :] + rd[:, None, :] * sel[..., 0][..., None], aabb)
    return [np.asarray(a) for a in (idx, got, sel[..., 0], vmask, xyz_n)]


@pytest.mark.parametrize("G,sample_cap,with_alpha,mode", CASES,
                         ids=[f"g{g}_cap{c}_{'masked' if a else 'open'}_{m}" for g, c, a, m in CASES])
def test_front_end_plain_matches_jax(G, sample_cap, with_alpha, mode):
    """``group_sample_compact_plain``, and the dispatcher on the CPU, equal
    the JAX front end exactly in every output, the normalised coordinates
    included: under ``jax.disable_jit()`` both make the same float32
    roundings (no FMA), and ``2 / size`` and PyTorch's ``reciprocal * 2``
    round alike."""
    rays = _front_end_rays()
    S, n = 52, rays.shape[0]
    ng = -(-S // G)
    capg = min(ng, -(-(sample_cap or S) // G))
    key = jax.random.split(jax.random.PRNGKey(7))[0] if mode == "train" else None
    jitter = None if key is None else torch.from_numpy(
        np.array(jax.random.uniform(key, (n, 1), dtype=jnp.float32)))
    jgrid, vol = None, None
    if with_alpha:
        j_kw, t_kw = _alpha_both()
        jgrid = j_occ.AlphaGrid(volume=j_kw["alpha_volume"], aabb=j_kw["alpha_aabb"],
                                table=j_kw["alpha_table"])
        vol = (t_kw["alpha_volume"], t_kw["alpha_aabb"])
    want = _jax_front_end(rays, G, capg, jgrid, key)
    args = (torch.from_numpy(rays), jitter, torch.tensor(AABB), 2.0, 6.0, S, STEP, G, capg,
            *(vol or (None, None)))
    for got in (t_comp.group_sample_compact_plain(*args),
                t_comp.group_sample_compact(*args, indices=True)):
        for a, b, name in zip(got, want, ("idx", "got", "z_c", "vmask", "xyz_n")):
            assert tuple(a.shape) == b.shape, name
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    _, got_mask, z_c, vmask, xyz_n = got
    assert got_mask[-2].any() and not got_mask[-1].any()  # the axis ray hits, the last misses
    assert 0 < vmask.mean() < 1 and xyz_n.shape == (n, capg * G, 3)
    if sample_cap:
        assert (got_mask.sum(-1) == capg).any()  # the cap truncates rays
    idx, got_mask, *_ = t_comp.group_sample_compact(*args)
    assert idx is None and got_mask is None
