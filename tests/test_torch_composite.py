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

K5's shard mode (the sample-parallel renderer's composite of one shard of
a ray's samples from a starting transmittance t0): its plain pair
``composite_shard_plain`` / ``composite_shard_backward_plain`` and the
totals against `ngf_tpu/parallel/sample_parallel.py:95-117`'s arithmetic for
one shard and ``jax.vjp`` of it (the gradients of sigma, rgb and t0 from
cotangents of y, acc and t_end), with t0 random and t0 = 0 behind opaque
samples; and 2 or 4 shards chained through ``composite_shard``'s exchange
against the whole-ray composite and its ``jax.vjp``.

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


def _jax_shard(sigma, rgb, z, t0, dist):
    """One shard of `ngf_tpu/parallel/sample_parallel.py:95-117` from its
    prefix ``t0``: (y, acc, depth) before the sums over the shards, and the
    shard's total ``local_total``."""
    alpha = 1.0 - jnp.exp(-sigma * dist)
    one_m = 1.0 - alpha + 1e-10
    local_excl = jnp.cumprod(
        jnp.concatenate([jnp.ones_like(one_m[:, :1]), one_m[:, :-1]], -1), -1)
    local_total = local_excl[:, -1] * one_m[:, -1]
    weight = alpha * local_excl * t0[:, None]
    rgb_mask = (weight > THRES).astype(weight.dtype)
    y = jnp.sum(weight[..., None] * (rgb * rgb_mask[..., None]), -2)
    return y, jnp.sum(weight, -1), jnp.sum(weight * z, -1), local_total


def _shard_inputs(case, n=48, s=96, seed=0):
    """The grouped constant length, densities over five decades, and for
    ``opaque`` runs of sigma dist = 20 up to 88 samples; t0 random in
    (0, 1], with t0 = 0 (behind an opaque shard) on a quarter of the rays
    for ``opaque``."""
    sigma, _, rgb, z, ray_last, vmask, _ = _inputs("grouped_draw1" if case != "opaque" else case,
                                                   n=n, s=s, seed=seed)
    sigma = sigma * vmask
    t0 = (1.0 - np.random.default_rng(seed + 1).uniform(size=n)).astype(np.float32)
    if case == "opaque":
        t0[: n // 4] = 0.0
    return sigma, rgb, z, ray_last, t0


@pytest.mark.parametrize("case", ["random", "opaque"])
def test_shard_plain_pair_matches_jax_shard_and_its_vjp(case):
    """``composite_shard_totals_plain``, ``composite_shard_plain`` and
    ``composite_shard_backward_plain`` against one shard's arithmetic in the
    JAX package and ``jax.vjp`` of it in sigma, rgb and t0 (cotangents of y,
    acc and t_end); the autograd nodes' gradient of t0 (from the forward's
    local sums) likewise; no NaN with t0 = 0 and alpha 1."""
    sigma, rgb, z, _, t0 = _shard_inputs(case)
    n = sigma.shape[0]
    rng = np.random.default_rng(3)
    g_y, g_acc, g_tend = (rng.normal(size=sh).astype(np.float32) for sh in ((n, 3), (n,), (n,)))

    want, vjp = jax.vjp(lambda s_, c_, t_: _jax_shard(s_, c_, jnp.asarray(z), t_, STEP_DIST),
                        jnp.asarray(sigma), jnp.asarray(rgb), jnp.asarray(t0))
    want_grads = vjp((jnp.asarray(g_y), jnp.asarray(g_acc), jnp.zeros(n, jnp.float32),
                      jnp.asarray(g_tend)))
    ts, tr, tz, tt0 = (torch.from_numpy(a) for a in (sigma, rgb, z, t0))
    y, acc, depth, local, w = t_comp.composite_shard_plain(ts, STEP_DIST, tr, tz, tt0, THRES)
    t_end = t_comp.composite_shard_totals_plain(ts, STEP_DIST)
    for a, b, what in zip((y, acc, depth, t_end), want, ("y", "acc", "depth", "t_end")):
        _close(a.numpy(), b, what)
    got = t_comp.composite_shard_backward_plain(ts, STEP_DIST, tr, tt0, THRES,
                                                *(torch.from_numpy(g) for g in (g_y, g_acc, g_tend)))
    for a, b, what in zip(got, want_grads, ("d sigma", "d rgb", "d t0")):
        assert np.isfinite(a.numpy()).all(), what
        _close(a.numpy(), b, what)
    # Through the autograd nodes: t0 a leaf the exchange returns.
    s_ = ts.clone().requires_grad_(True)
    c_ = tr.clone().requires_grad_(True)
    t0_ = tt0.clone().requires_grad_(True)
    held = {}

    def exchange(t_end_):
        held["t_end"] = t_end_
        return t0_ + 0.0 * t_end_

    y2, acc2, _ = t_comp.composite_shard(s_, STEP_DIST, c_, tz, THRES, exchange)
    ((y2 * torch.from_numpy(g_y)).sum() + (acc2 * torch.from_numpy(g_acc)).sum()
     + (held["t_end"] * torch.from_numpy(g_tend)).sum()).backward()
    for a, b, what in zip((s_.grad, c_.grad, t0_.grad), want_grads, ("d sigma", "d rgb", "d t0")):
        _close(a.numpy(), b, "autograd " + what)
    if case == "opaque":
        assert (sigma * STEP_DIST >= 20).sum(-1).max() > 40
        assert (y.numpy()[: n // 4] == 0).all() and np.abs(np.asarray(want_grads[0])).max() > 0


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("case", ["random", "opaque"])
def test_chained_shards_equal_the_whole_composite(m, case):
    """m shards chained through ``composite_shard`` (each exchange the
    product of the earlier shards' totals), their sums with the white
    background and the clip, against the whole-ray composite: rgb_map, acc
    and depth, and the gradients of sigma and rgb against ``jax.vjp`` of
    the JAX renderers' whole composite."""
    sigma, rgb, z, ray_last, _ = _shard_inputs(case, s=96)
    n, S = sigma.shape
    rng = np.random.default_rng(4)
    g_rgb, g_acc = rng.normal(size=(n, 3)).astype(np.float32), rng.normal(size=n).astype(np.float32)
    want, vjp = jax.vjp(
        lambda s_, c_: _jax_composite(s_, STEP_DIST, c_, jnp.asarray(z), jnp.asarray(ray_last),
                                      "white")[:3], jnp.asarray(sigma), jnp.asarray(rgb))
    want_ds, want_drgb = vjp((jnp.asarray(g_rgb), jnp.asarray(g_acc), jnp.zeros(n, jnp.float32)))

    s_ = torch.from_numpy(sigma).requires_grad_(True)
    c_ = torch.from_numpy(rgb).requires_grad_(True)
    tz = torch.from_numpy(z)
    totals, sums = [], []
    k = S // m
    for j in range(m):
        def exchange(t_end, j=j):
            totals.append(t_end)
            t0 = torch.ones_like(t_end) + 0.0 * t_end
            for t in totals[:j]:
                t0 = t0 * t
            return t0

        sums.append(t_comp.composite_shard(s_[:, j * k:(j + 1) * k], STEP_DIST,
                                           c_[:, j * k:(j + 1) * k], tz[:, j * k:(j + 1) * k],
                                           THRES, exchange))
    y = sum(p[0] for p in sums)
    acc = sum(p[1] for p in sums)
    depth = sum(p[2] for p in sums) + (1.0 - acc.detach()) * torch.from_numpy(ray_last)
    rgb_map = torch.minimum(torch.maximum(y + (1.0 - acc[:, None]), y.new_zeros(())), y.new_ones(()))
    ((rgb_map * torch.from_numpy(g_rgb)).sum() + (acc * torch.from_numpy(g_acc)).sum()).backward()
    for a, b, what in zip((rgb_map, acc, depth), want, ("rgb_map", "acc", "depth")):
        _close(a.detach().numpy(), b, what)
    _close(s_.grad.numpy(), want_ds, "d sigma")
    _close(c_.grad.numpy(), want_drgb, "d rgb")
    assert np.isfinite(s_.grad.numpy()).all()
