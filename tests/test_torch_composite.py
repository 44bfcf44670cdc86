"""The tri-plane composite (K5's tri-plane mode) against the JAX package on
the CPU: the port's ``composite`` (its plain forward ``composite_plain``
and its reverse-scan backward ``composite_backward_plain``, through the
``autograd.Function`` the renderers call) against the JAX renderers'
composite lines (`ngf_tpu/ops/compositing.py:32` with
`ngf_tpu/render/volume.py:311-358` grouped and `:469-505` dense, written
below as a function of sigma, dist, z and rgb) and ``jax.vjp`` of them; and
one dense render's plane gradients with opaque samples against ``jax.vjp``
of `ngf_tpu`'s ``render_rays``. The kernel itself is held against the plain
pair on the card by `tests/test_torch_cuda.py`.

Cases: dense per-sample lengths with the trailing zero, white background,
and in evaluation without one; the grouped constant length with the valid
mask (whose factor in the JAX shading mask the port leaves implied) and the
training background drawn 0 and 1; runs of sigma dist > 17 (alpha rounds to
1, f to 1e-10) up to 88 samples long; rays with no valid sample and rays
whose acc is below 6e-8 on a white background (rgb_map exactly 1, where the
clip passes half the gradient, as ``jnp.clip`` does); blend weights on both
sides of the shading threshold.

Tolerances: outputs and gradients 1e-5 of each one's largest magnitude
(float32 products and sums over up to 128 samples in another order); the
render's plane gradients 1e-4 of the largest, as `tests/test_torch_grouped.py`
states for gradients through the InfoInv appearance PE.
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
from test_torch_render import AABB, STEP, _model, _rays  # noqa: E402

from ngf_tpu.ops import compositing as j_comp  # noqa: E402
from ngf_tpu.render import volume as jv  # noqa: E402
from ngf_tpu_torch import convert  # noqa: E402
from ngf_tpu_torch.fields import triplane as tt  # noqa: E402
from ngf_tpu_torch.ops import compositing as t_comp  # noqa: E402
from ngf_tpu_torch.render import volume as tv  # noqa: E402

TOL = 1e-5
GRAD_REL_TOL = 1e-4
THRES = 1e-4
STEP_DIST = float(np.float32(0.01 * 25.0))  # the grouped path's step * distance_scale
PLANES = ("plane_xy", "plane_yz", "plane_xz")


def _jax_composite(sigma, dist, rgb, z, ray_last, background, vmask=None):
    """The JAX renderers' composite: dense (`volume.py:469-505`) without
    ``vmask``, grouped (`:311-358`) with it. ``background``: "white", a
    0/1 draw, or None."""
    if vmask is not None:
        sigma = sigma * vmask
    _, weight, _ = j_comp.raw2alpha(sigma, dist)
    acc = jnp.sum(weight, axis=-1)
    if vmask is None:
        rgb_mask = (weight > THRES).astype(weight.dtype)
        rgb_map = jnp.sum(weight[..., None] * (rgb * rgb_mask[..., None]), axis=-2)
    else:
        rgb_mask = (weight > THRES).astype(weight.dtype) * vmask
        rgb_map = jnp.sum((weight * rgb_mask)[..., None] * rgb, axis=-2)
    if background == "white":
        rgb_map = rgb_map + (1.0 - acc[..., None])
    elif background is not None:
        rgb_map = rgb_map + jnp.float32(background) * (1.0 - acc[..., None])
    rgb_map = jnp.clip(rgb_map, 0.0, 1.0)
    depth = jax.lax.stop_gradient(jnp.sum(weight * z, axis=-1) + (1.0 - acc) * ray_last)
    return rgb_map, acc, depth, weight


def _inputs(case, n=48, s=128, seed=0):
    """(sigma, dist (array or number), rgb, z, ray_last, vmask or None,
    background) for a case, from numpy."""
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(2.0, 6.0, (n, s)), axis=-1).astype(np.float32)
    ray_last = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    rgb = rng.uniform(0.0, 1.0, (n, s, 3)).astype(np.float32)
    # Densities over five decades across the rays: blend weights on both
    # sides of the threshold.
    sigma = (rng.uniform(0.0, 3.0, (n, s)) * (rng.uniform(size=(n, s)) < 0.6)
             * np.logspace(-5, 0, n)[:, None]).astype(np.float32)
    dense = case.startswith("dense")
    if dense:
        dist = np.concatenate([np.diff(z, axis=-1), np.zeros((n, 1), np.float32)], -1) * 25.0
        dist = dist.astype(np.float32)
        vmask = None
    else:
        dist = STEP_DIST
        vmask = (rng.uniform(size=(n, s)) < 0.7).astype(np.float32)
        sigma = sigma * 8.0
    background = {"dense_white": "white", "dense_eval": None, "grouped_draw0": 0.0,
                  "grouped_draw1": 1.0}.get(case, "white")
    if case == "opaque":
        # sigma dist = 20 > 17 on runs of 0 to 88 consecutive samples.
        for i in range(n):
            run = (i * 11) % 89
            sigma[i, 5:5 + run] = 20.0 / STEP_DIST
    if case == "empty":
        vmask[: n // 2] = 0.0  # no valid sample
        sigma[n // 2:] = 1e-9  # acc ~ 3e-8 < 6e-8: 1 - acc rounds to 1
    return sigma, dist, rgb, z, ray_last, vmask, background


def _port(sigma, dist, rgb, z, ray_last, vmask, background, g_rgb, g_acc):
    """The port's composite as the renderers call it, and its gradients of
    sum(rgb_map g_rgb) + sum(acc g_acc) in sigma (before the valid mask)
    and rgb."""
    s = torch.from_numpy(sigma).requires_grad_(True)
    c = torch.from_numpy(rgb).requires_grad_(True)
    sig = s if vmask is None else s * torch.from_numpy(vmask)
    d = torch.from_numpy(dist) if isinstance(dist, np.ndarray) else dist
    if background == "white":
        b = 1.0
    elif background is not None:
        b = torch.tensor(background, dtype=torch.float32)  # the training draw, on the device
    else:
        b = None
    rgb_map, acc, depth, w = t_comp.composite(sig, d, c, torch.from_numpy(z),
                                              torch.from_numpy(ray_last), b, THRES, weights=True)
    ((rgb_map * torch.from_numpy(g_rgb)).sum() + (acc * torch.from_numpy(g_acc)).sum()).backward()
    return [t.detach().numpy() for t in (rgb_map, acc, depth, w)], s.grad.numpy(), c.grad.numpy()


def _close(got, want, what):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= TOL * scale, (what, err, scale)


CASES = ["dense_white", "dense_eval", "grouped_draw0", "grouped_draw1", "opaque", "empty"]


@pytest.mark.parametrize("case", CASES)
def test_composite_matches_jax_and_its_vjp(case):
    sigma, dist, rgb, z, ray_last, vmask, background = _inputs(case)
    rng = np.random.default_rng(1)
    g_rgb = rng.normal(size=(sigma.shape[0], 3)).astype(np.float32)
    g_acc = rng.normal(size=sigma.shape[0]).astype(np.float32)

    def j_fn(s, c):
        return _jax_composite(s, jnp.asarray(dist), c, jnp.asarray(z), jnp.asarray(ray_last),
                              background, None if vmask is None else jnp.asarray(vmask))

    want, vjp = jax.vjp(j_fn, jnp.asarray(sigma), jnp.asarray(rgb))
    want_ds, want_drgb = vjp((jnp.asarray(g_rgb), jnp.asarray(g_acc),
                              jnp.zeros(sigma.shape[0], jnp.float32), jnp.zeros_like(want[3])))
    got, ds, drgb = _port(sigma, dist, rgb, z, ray_last, vmask, background, g_rgb, g_acc)
    for a, b, what in zip(got, want, ("rgb_map", "acc", "depth", "w")):
        _close(a, b, what)
    _close(ds, want_ds, "d sigma")
    _close(drgb, want_drgb, "d rgb")
    w = got[3]
    if case.startswith("dense"):
        assert (w > THRES).any() and ((w > 0) & (w <= THRES)).any()  # both sides
    if vmask is not None:
        # The valid mask's factor is implied: a culled sample's w is 0.
        assert (w[vmask == 0] == 0).all()
    if case == "opaque":
        assert (sigma * STEP_DIST > 17).sum(-1).max() == 88
        assert np.isfinite(ds).all() and np.abs(np.asarray(want_ds)).max() > 0
    if case == "empty":
        # On the clip's bound, where jnp.clip passes half the gradient
        # (torch.clamp all of it, which fails the d sigma comparison).
        assert (got[0] == 1.0).all() and (got[1] < 6e-8).all()


def test_backward_mask_is_the_forwards():
    """The reverse scan sheds rgb gradient exactly where the forward's
    shading mask is 0, sample for sample."""
    sigma, dist, rgb, z, ray_last, _, _ = _inputs("dense_white", seed=5)
    g_rgb = np.random.default_rng(6).uniform(0.5, 1.0, (sigma.shape[0], 3)).astype(np.float32)
    got, _, drgb = _port(sigma, dist, rgb, z, ray_last, None, "white", g_rgb,
                         np.zeros(sigma.shape[0], np.float32))
    inside = (got[0] > 0) & (got[0] < 1)  # rays whose colour passes the clip
    shaded = got[3] > THRES
    np.testing.assert_array_equal((drgb[..., 0] != 0)[inside[:, 0]], shaded[inside[:, 0]])
    assert shaded[inside[:, 0]].any() and (~shaded[inside[:, 0]]).any()


def test_plain_pair_is_autograd_of_the_plain_forward():
    """``composite_backward_plain`` (the reverse scan) against autograd
    through ``composite_plain``'s cumprod on ordinary inputs."""
    sigma, dist, rgb, z, ray_last, vmask, _ = _inputs("grouped_draw1", seed=7)
    s = torch.from_numpy(sigma * vmask).requires_grad_(True)
    c = torch.from_numpy(rgb).requires_grad_(True)
    bg = torch.tensor(1.0)
    rgb_map, y, acc, _, _ = t_comp.composite_plain(s, dist, c, torch.from_numpy(z),
                                                   torch.from_numpy(ray_last), bg, THRES)
    g = torch.randn(rgb_map.shape, generator=torch.Generator().manual_seed(0))
    ga = torch.randn(acc.shape, generator=torch.Generator().manual_seed(1))
    ((rgb_map * g).sum() + (acc * ga).sum()).backward()
    ds, drgb = t_comp.composite_backward_plain(s.detach(), dist, c.detach(), bg, THRES,
                                               y.detach(), g, ga)
    _close(ds.numpy(), s.grad.numpy(), "d sigma")
    _close(drgb.numpy(), c.grad.numpy(), "d rgb")


def test_render_gradients_with_opaque_samples_match_jax_vjp():
    """A dense render whose samples turn opaque (density bias 20: sigma
    dist ~25 inside the field, alpha 1 in float32) through the composite's
    reverse scan: the plane gradients of sum(rgb_map g) + sum(acc) against
    ``jax.vjp`` of `ngf_tpu`'s ``render_rays``."""
    cfg, params = _model(seed=2, bias=20.0)
    kw = dict(aabb=AABB, n_samples=52, step_size=STEP)
    jr, tr = jv.RenderConfig(**kw), tv.RenderConfig(**kw)
    rays = _rays()
    g = np.random.default_rng(4).normal(size=(rays.shape[0], 3)).astype(np.float32)

    def j_out(planes):
        out = jv.render_rays({**params, **planes}, cfg, jr, jnp.asarray(rays), None,
                             is_train=False)
        return out["rgb_map"], out["acc_map"]

    (j_rgb, j_acc), vjp = jax.vjp(j_out, {n: jnp.asarray(params[n]) for n in PLANES})
    want = vjp((jnp.asarray(g), jnp.ones_like(j_acc)))[0]
    tparams = convert.params_from_numpy(params, "cpu")
    for n in PLANES:
        tparams[n].requires_grad_(True)
    out = tv.render_rays(tparams, tt.TriPlaneConfig(**dataclasses.asdict(cfg)), tr,
                         torch.from_numpy(rays))
    ((out["rgb_map"] * torch.from_numpy(g)).sum() + out["acc_map"].sum()).backward()
    acc = out["acc_map"].detach().numpy()
    assert 0.3 < acc.mean() and acc.max() > 1.0 - 1e-6  # opaque rays
    np.testing.assert_allclose(out["rgb_map"].detach().numpy(), np.asarray(j_rgb), rtol=0,
                               atol=GRAD_REL_TOL)
    scale = max(float(np.abs(np.asarray(want[n])).max()) for n in PLANES)
    assert scale > 1e-3
    for n in PLANES:
        np.testing.assert_allclose(tparams[n].grad.numpy(), np.asarray(want[n]), rtol=0,
                                   atol=GRAD_REL_TOL * scale, err_msg=n)
