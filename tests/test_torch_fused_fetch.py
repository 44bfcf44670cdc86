"""The fused tri-plane fetch against the JAX package on the CPU: the port's
``triplane_density_and_rgbfeat`` / ``triplane_rgb_from_feats`` against
`ngf_tpu/fields/triplane.py:262-303`, its plane gradients against
``jax.vjp``, the dense ``render_rays`` that now takes it against
`ngf_tpu`'s, and the plain version of the three-plane gather kernel
(``grid_sample_planes_plain``) against three one-plane gathers. On the CPU
every gather runs its plain version; the kernel itself is tested on the
card by `tests/test_torch_cuda.py`.

Inputs are those of `tests/test_torch_triplane.py` (16 x 16 planes at the
presets' channel widths, numpy points from a seed). Tolerances, as that
file states them: float32 1e-5; the InfoInv appearance PE at 12
frequencies takes sin/cos of arguments up to 2^11, where the two libraries'
float32 sin differ in the last ulps, so appearance features and rgb with
InfoInv 1e-4; bfloat16 5e-2 relative; rendered maps 1e-4. Plane gradients
run back through the decoders, whose float32 products sum in another order:
1e-5 of the largest gradient, 1e-4 with the InfoInv appearance PE in them.
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
from test_torch_triplane import (  # noqa: E402
    BF16_RTOL,
    PE_TOL,
    TOL,
    _jax_proj,
    _setup,
    _torch_proj,
)

from ngf_tpu.fields import triplane as jt  # noqa: E402
from ngf_tpu.render import volume as jv  # noqa: E402
from ngf_tpu_torch import convert  # noqa: E402
from ngf_tpu_torch.fields import triplane as tt  # noqa: E402
from ngf_tpu_torch.ops import cuda_kernels  # noqa: E402
from ngf_tpu_torch.ops import grid_sample as t_gs  # noqa: E402
from ngf_tpu_torch.ops.encoding import infoinv_modulate  # noqa: E402
from ngf_tpu_torch.render import volume as tv  # noqa: E402

RENDER_TOL = 1e-4
PRESETS = ["infoinv", "infoinv_off", "gauge"]
PLANES = ("plane_xy", "plane_yz", "plane_xz")


def _both_fused(name, seed, compute_dtype="float32"):
    jcfg, params, tcfg, tparams, xyz, views = _setup(name, seed, compute_dtype)
    want = jt.triplane_density_and_rgbfeat(params, jcfg, *_jax_proj(params, jcfg, xyz))
    got = tt.triplane_density_and_rgbfeat(tparams, tcfg, *_torch_proj(tparams, tcfg, xyz))
    return (jcfg, params, tcfg, tparams, views), want, got


@pytest.mark.parametrize("name", PRESETS)
def test_density_and_rgbfeat_match_jax(name):
    (jcfg, *_), (j_sigma, j_feat), (sigma, feat) = _both_fused(name, seed=0)
    assert feat.shape == (6, 37, 3 * jcfg.rgb_dim)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(j_sigma), rtol=TOL, atol=TOL)
    tol = PE_TOL if jcfg.infoinv else TOL
    np.testing.assert_allclose(feat.numpy(), np.asarray(j_feat), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", PRESETS)
def test_rgb_from_feats_matches_jax(name):
    (jcfg, params, tcfg, tparams, views), (_, j_feat), (_, feat) = _both_fused(name, seed=1)
    want = jt.triplane_rgb_from_feats(params, jcfg, j_feat, jnp.asarray(views))
    got = tt.triplane_rgb_from_feats(tparams, tcfg, feat, torch.from_numpy(views))
    assert got.dtype == torch.float32
    tol = PE_TOL if jcfg.infoinv else TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", PRESETS)
def test_fused_pair_equals_the_two_fetches(name):
    """The fused pair gives what ``triplane_density`` and ``triplane_rgb``
    give, which fetch density and appearance apart."""
    _, _, tcfg, tparams, xyz, views = _setup(name, seed=2)
    proj = _torch_proj(tparams, tcfg, xyz)
    sigma, feat = tt.triplane_density_and_rgbfeat(tparams, tcfg, *proj)
    views = torch.from_numpy(views)
    torch.testing.assert_close(sigma, tt.triplane_density(tparams, tcfg, *proj), rtol=0, atol=0)
    torch.testing.assert_close(tt.triplane_rgb_from_feats(tparams, tcfg, feat, views),
                               tt.triplane_rgb(tparams, tcfg, *proj, views), rtol=0, atol=0)


@pytest.mark.parametrize("name", ["infoinv", "gauge"])
def test_bfloat16_fused_pair(name):
    (jcfg, params, tcfg, tparams, views), (j_sigma, j_feat), (sigma, feat) = _both_fused(
        name, seed=3, compute_dtype="bfloat16")
    assert sigma.dtype == torch.float32
    np.testing.assert_allclose(sigma.numpy(), np.asarray(j_sigma), rtol=BF16_RTOL, atol=1e-6)
    want = jt.triplane_rgb_from_feats(params, jcfg, j_feat, jnp.asarray(views))
    got = tt.triplane_rgb_from_feats(tparams, tcfg, feat, torch.from_numpy(views))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=BF16_RTOL, atol=1e-2)


@pytest.mark.parametrize("freqs,C", [(4, 24), (12, 72)])
def test_decoder_input_is_the_cat_of_three_modulations(freqs, C):
    """One PE broadcast over the (..., 3, C) features is, element by element,
    the cat of three ``infoinv_modulate`` calls."""
    rng = np.random.default_rng(freqs)
    feats = torch.from_numpy(rng.normal(size=(5, 7, 3, C)).astype(np.float32))
    xyz = torch.from_numpy(rng.uniform(-1, 1, (5, 7, 3)).astype(np.float32))
    cfg = tt.TriPlaneConfig(infoinv=True)
    want = torch.cat([infoinv_modulate(feats[..., i, :], xyz, freqs) for i in range(3)], -1)
    assert torch.equal(tt._decoder_input(feats, cfg, xyz, freqs), want)
    plain = tt._decoder_input(feats, dataclasses.replace(cfg, infoinv=False), None, freqs)
    assert torch.equal(plain, feats.reshape(5, 7, 3 * C))


def _planes_and_coords(seed, C=96, n=300):
    rng = np.random.default_rng(seed)
    planes = [torch.from_numpy(rng.normal(size=(12, 10, C)).astype(np.float32)) for _ in range(3)]
    xyz = torch.from_numpy(rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32))
    return planes, (xyz[:, 0:2], xyz[:, 1:3], xyz[:, 0::2])


@pytest.mark.parametrize("channels,split", [
    (slice(None), 24), (slice(None), None), (slice(8, 72), 16), (slice(3, 13), 5),
])
def test_planes_plain_is_three_plain_gathers(channels, split):
    planes, coords = _planes_and_coords(4)
    out_a, out_b = t_gs.grid_sample_planes_plain(planes, coords, channels, split)
    for i, (p, c) in enumerate(zip(planes, coords)):
        one = t_gs.grid_sample_2d_plain(p[..., channels], c)
        if split is None:
            assert out_b is None and torch.equal(out_a[:, i], one)
        else:
            assert torch.equal(out_a[:, i], one[:, :split])
            assert torch.equal(out_b[:, i], one[:, split:])
    assert out_a.is_contiguous() and (out_b is None or out_b.is_contiguous())


def test_grid_sample_planes_routes_coordinate_gradients_to_plain_autograd():
    """Coordinates that need a gradient (the gauge variant) go through the
    Function like the rest: its backward gives the coordinate gradient
    written out (``grid_sample_2d_backward_coords_plain``, the plain version
    of K2c) and the plane gradients, and both equal plain autograd's through
    ``grid_sample_planes_plain`` (1e-5 of the largest; the sums run in
    another order)."""
    planes, coords = _planes_and_coords(5, C=8, n=50)
    rng = np.random.default_rng(6)
    g_a = torch.from_numpy(rng.normal(size=(50, 3, 3)).astype(np.float32))
    g_b = torch.from_numpy(rng.normal(size=(50, 3, 5)).astype(np.float32))
    grads = {}
    for how, fn in (("function", t_gs.grid_sample_planes),
                    ("autograd", t_gs.grid_sample_planes_plain)):
        ps = [p.clone().requires_grad_(True) for p in planes]
        cs = [c.clone().requires_grad_(True) for c in coords]
        out_a, out_b = fn(ps, cs, split=3)
        ((out_a * g_a).sum() + (out_b * g_b).sum()).backward()
        grads[how] = [t.grad for t in ps + cs]
    for got, want in zip(grads["function"], grads["autograd"]):
        scale = want.abs().max().item()
        assert scale > 0
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("name", ["infoinv", "infoinv_off"])
def test_fused_plane_gradients_match_jax_vjp(name):
    """Plane gradients of the fused pair through ``_BilinearGatherPlanes``
    (one float32 buffer per plane, both outputs' plain backward into it)
    against ``jax.vjp`` of `ngf_tpu`'s pair, for the same cotangents."""
    jcfg, params, tcfg, tparams, xyz, _ = _setup(name, seed=6)
    rng = np.random.default_rng(7)
    g_sigma = rng.normal(size=xyz.shape[:-1]).astype(np.float32)
    g_feat = rng.normal(size=(*xyz.shape[:-1], 3 * jcfg.rgb_dim)).astype(np.float32)

    def jax_fn(planes):
        p = {**params, **dict(zip(PLANES, planes))}
        return jt.triplane_density_and_rgbfeat(p, jcfg, *_jax_proj(p, jcfg, xyz))

    _, vjp = jax.vjp(jax_fn, [jnp.asarray(params[n]) for n in PLANES])
    want = vjp((jnp.asarray(g_sigma), jnp.asarray(g_feat)))[0]

    for n in PLANES:
        tparams[n].requires_grad_(True)
    sigma, feat = tt.triplane_density_and_rgbfeat(tparams, tcfg, *_torch_proj(tparams, tcfg, xyz))
    ((sigma * torch.from_numpy(g_sigma)).sum() + (feat * torch.from_numpy(g_feat)).sum()).backward()
    scale = max(float(np.abs(w).max()) for w in want)
    tol = (PE_TOL if jcfg.infoinv else TOL) * scale
    for n, w in zip(PLANES, want):
        np.testing.assert_allclose(tparams[n].grad.numpy(), np.asarray(w), atol=tol, rtol=0,
                                   err_msg=n)
    assert scale > 0.1


@pytest.mark.parametrize("infoinv", [True, False], ids=["infoinv", "plain_pe"])
def test_render_rays_fused_matches_jax_dense(infoinv):
    """The dense ``render_rays`` on the fused fetch against `ngf_tpu`'s
    dense path, which fetches density and appearance apart (1e-4), and
    against the port's own per-plane route through a ``sample_fn``."""
    cfg = dataclasses.replace(jt.TriPlaneConfig.infoinv_preset(infoinv), plane_res=16)
    params = jax.device_get(jt.init_triplane(jax.random.PRNGKey(8), cfg))
    params["density_decoder"]["mlp"]["layers"][-1]["b"] = np.full((1,), 5.5, np.float32)
    rng = np.random.default_rng(9)
    d = rng.normal(size=(40, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([-3.5 * d + 0.3 * rng.normal(size=(40, 3)), d], 1).astype(np.float32)
    kw = dict(aabb=((-1.5,) * 3, (1.5,) * 3), n_samples=52, step_size=0.1)
    want = jv.render_rays(params, cfg, jv.RenderConfig(**kw), jnp.asarray(rays), None,
                          is_train=False)
    tparams = convert.params_from_numpy(params, "cpu")
    tcfg = tt.TriPlaneConfig(**dataclasses.asdict(cfg))
    got = tv.render_rays(tparams, tcfg, tv.RenderConfig(**kw), torch.from_numpy(rays))
    per_plane = tv.render_rays(tparams, tcfg, tv.RenderConfig(**kw), torch.from_numpy(rays),
                               sample_fn=lambda p, c, name: t_gs.grid_sample_2d_plain(p, c))
    assert 0.02 < got["acc_map"].mean().item() < 0.98
    for k in ("rgb_map", "depth_map", "acc_map"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RENDER_TOL,
                                   atol=RENDER_TOL, err_msg=k)
        torch.testing.assert_close(got[k], per_plane[k], rtol=0, atol=0, msg=k)


_ALIGNED = 1 << 20


@pytest.mark.parametrize("dtype,C,split,strides,ptrs,lanes", [
    (torch.float32, 96, 24, [96] * 3, [_ALIGNED] * 5, 4),  # the fused fetch
    (torch.bfloat16, 96, 24, [96] * 3, [_ALIGNED] * 5, 8),
    (torch.float32, 64, 16, [64] * 3, [_ALIGNED] * 5, 4),  # gauge preset planes
    (torch.bfloat16, 64, 20, [64] * 3, [_ALIGNED] * 5, 1),  # split not a multiple of 8
    (torch.float32, 72, 72, [96], [_ALIGNED + 4 * 24, _ALIGNED], 4),  # appearance alone
    (torch.float32, 2, 2, [2] * 3, [_ALIGNED] * 4, 1),  # gauge grids
    (torch.float32, 10, 5, [96] * 3, [_ALIGNED + 12] * 3 + [_ALIGNED] * 2, 1),  # offset 3
    (torch.float32, 96, 24, [96, 98, 96], [_ALIGNED] * 5, 1),  # one texel stride
    (torch.float32, 96, 24, [96] * 3, [_ALIGNED] * 4 + [_ALIGNED + 8], 1),  # an output pointer
])
def test_gather_lanes(dtype, C, split, strides, ptrs, lanes):
    """The gather takes 16-byte loads and stores only where every one of
    them is 16-byte aligned, and scalar ones otherwise."""
    assert cuda_kernels.gather_lanes(dtype, C, split, strides, ptrs) == lanes


def test_planes_wrapper_refuses_cpu_tensors():
    """No fallback: the kernel's wrapper takes CUDA tensors or raises."""
    planes, coords = _planes_and_coords(10, C=8, n=5)
    with pytest.raises(ValueError):
        cuda_kernels.bilinear_gather_planes(planes, coords, split=4)
