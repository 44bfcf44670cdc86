"""The port's tri-plane field (`ngf_tpu_torch/fields/`) against
`ngf_tpu/fields/triplane.py` on the CPU.

Parameters come from the JAX package's ``init_triplane`` and go into the port
through ``convert.params_from_numpy``; the same numpy points go through both.
Planes are 16 x 16 at the presets' channel widths (InfoInv fixes
C = 6 * freqs: 24 density and 72 appearance channels).
Tolerance: RTOL = ATOL = 1e-5 in float32, for a few MLP layers over
features that agree to a few ulps; the InfoInv PE at 12 frequencies takes
sin/cos of arguments up to 2^11, where the two libraries' float32 sin may
differ in the last ulps, so rgb with InfoInv uses 1e-4. In bfloat16 the two
packages round at other places (JAX keeps matmul outputs in float32 before
the bias), so density and rgb agree to 5e-2 relative there.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ngf_tpu.fields import triplane as jt  # noqa: E402
from ngf_tpu_torch import convert  # noqa: E402
from ngf_tpu_torch.fields import triplane as tt  # noqa: E402

TOL = 1e-5
PE_TOL = 1e-4
BF16_RTOL = 5e-2


def _configs():
    infoinv = dataclasses.replace(jt.TriPlaneConfig.infoinv_preset(True), plane_res=16)
    plain = dataclasses.replace(jt.TriPlaneConfig.infoinv_preset(False), plane_res=16)
    gauge = dataclasses.replace(jt.TriPlaneConfig.gauge_preset(0), plane_res=16, gauge_res=8)
    return {"infoinv": infoinv, "infoinv_off": plain, "gauge": gauge}


def _setup(name, seed=0, compute_dtype="float32"):
    jcfg = dataclasses.replace(_configs()[name], compute_dtype=compute_dtype)
    params = jax.device_get(jt.init_triplane(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    if jcfg.variant == "gauge":
        for g in ("gauge_xy", "gauge_yz", "gauge_xz"):
            params[g] = (0.05 * rng.normal(size=params[g].shape)).astype(np.float32)
    tcfg = tt.TriPlaneConfig(**dataclasses.asdict(jcfg))
    tparams = convert.params_from_numpy(params, "cpu")
    xyz = rng.uniform(-1.05, 1.05, (6, 37, 3)).astype(np.float32)
    views = rng.normal(size=(6, 37, 3)).astype(np.float32)
    views /= np.linalg.norm(views, axis=-1, keepdims=True)
    return jcfg, params, tcfg, tparams, xyz, views


def _jax_proj(params, cfg, xyz, iteration=1):
    xy, yz, xz = jt.triplane_project(jnp.asarray(xyz))
    return jt.triplane_gauge(params, cfg, xy, yz, xz, iteration)


def _torch_proj(params, cfg, xyz, iteration=1):
    xy, yz, xz = tt.triplane_project(torch.from_numpy(xyz))
    return tt.triplane_gauge(params, cfg, xy, yz, xz, iteration)


@pytest.mark.parametrize("name", ["infoinv", "infoinv_off", "gauge"])
def test_density_matches_jax(name):
    jcfg, params, tcfg, tparams, xyz, _ = _setup(name)
    want = jt.triplane_density(params, jcfg, *_jax_proj(params, jcfg, xyz))
    got = tt.triplane_density(tparams, tcfg, *_torch_proj(tparams, tcfg, xyz))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["infoinv", "infoinv_off", "gauge"])
def test_rgb_matches_jax(name):
    jcfg, params, tcfg, tparams, xyz, views = _setup(name, seed=1)
    want = jt.triplane_rgb(params, jcfg, *_jax_proj(params, jcfg, xyz), jnp.asarray(views))
    got = tt.triplane_rgb(tparams, tcfg, *_torch_proj(tparams, tcfg, xyz), torch.from_numpy(views))
    tol = PE_TOL if jcfg.infoinv else TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("iteration", [-1, 5])
def test_gauge_schedule(iteration):
    """Offsets apply from gauge_start on and are multiplied out before."""
    jcfg, params, tcfg, tparams, xyz, _ = _setup("gauge", seed=2)
    jcfg = dataclasses.replace(jcfg, gauge_start=0)
    tcfg = dataclasses.replace(tcfg, gauge_start=0)
    want = _jax_proj(params, jcfg, xyz, iteration)
    got = _torch_proj(tparams, tcfg, xyz, iteration)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)
    moved = not np.allclose(got[0].numpy(), xyz[..., 0:2])
    assert moved == (iteration >= 0)


@pytest.mark.parametrize("name", ["infoinv", "gauge"])
def test_bfloat16_compute(name):
    jcfg, params, tcfg, tparams, xyz, views = _setup(name, seed=3, compute_dtype="bfloat16")
    jproj, tproj = _jax_proj(params, jcfg, xyz), _torch_proj(tparams, tcfg, xyz)
    want = jt.triplane_density(params, jcfg, *jproj)
    got = tt.triplane_density(tparams, tcfg, *tproj)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=BF16_RTOL, atol=1e-6)
    want = jt.triplane_rgb(params, jcfg, *jproj, jnp.asarray(views))
    got = tt.triplane_rgb(tparams, tcfg, *tproj, torch.from_numpy(views))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=BF16_RTOL, atol=1e-2)


@pytest.mark.parametrize("name", ["infoinv", "gauge"])
def test_init_tree_matches_jax(name):
    """The port's init builds the JAX tree: same names, shapes, layouts,
    and the torch-init bounds."""
    jcfg = _configs()[name]
    jtree = jax.device_get(jt.init_triplane(jax.random.PRNGKey(0), jcfg))
    tcfg = tt.TriPlaneConfig(**dataclasses.asdict(jcfg))
    ttree = convert.params_to_numpy(tt.init_triplane(tcfg, torch.Generator().manual_seed(0)))
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = jax.tree_util.tree_flatten_with_path(ttree)[0]
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (path, a), (_, b) in zip(jflat, tflat):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if a.ndim == 2 and np.abs(a).max() > 0:  # linear weights: same uniform bound
            bound = np.abs(a).max()
            assert np.abs(b).max() <= bound * 1.05 + 1e-6, path


def test_params_numpy_round_trip():
    _, params, _, tparams, _, _ = _setup("infoinv")
    back = convert.params_to_numpy(tparams)
    for (pa, a), (pb, b) in zip(
        jax.tree_util.tree_flatten_with_path(params)[0],
        jax.tree_util.tree_flatten_with_path(back)[0],
    ):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
