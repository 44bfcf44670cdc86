"""Top-K shading (``rgb_cap``) and the dense ``mask_stride`` of the port
against the JAX package on the CPU.

- K5's top-K mode: the port's ``composite_weights`` then ``composite_topk``
  (their plain versions, ``composite_topk_plain`` and
  ``composite_topk_backward_plain`` with the reverse scan's ``g_w`` input,
  through the ``autograd.Function`` pair the renderers call), with the
  selected colours gathered by ``gather_group_rows``, against the JAX
  renderers' top-K lines (`ngf_tpu/render/volume.py:473-487` dense,
  `:315-353` grouped, written below as a function of sigma and rgb) and
  ``jax.vjp`` of them: dense K 16 and 48, grouped kg < capg, the three
  backgrounds, opaque runs (alpha rounding to 1), empty rays.
- ``gather_group_rows`` (the ``gather_rows`` kernel's plain version with its
  backward, the scatter) against `ngf_tpu/ops/compaction.py:gather_groups`
  and its ``jax.vjp``, float32 and bfloat16.
- ``render_rays`` with ``rgb_cap`` on the dense path (K 16, 48) and the
  grouped one (kg < capg, ``fused_fetch`` 0 and 1), float32 and bfloat16,
  InfoInv and the learned gauge (whose coordinates carry the gradient
  through the gather), and opaque samples: outputs against `ngf_tpu`'s
  ``render_rays`` and the gradients of every parameter leaf against
  ``jax.grad`` of it.
- The dense ``mask_stride`` 2 and 4: the valid mask exactly as
  `ngf_tpu/render/volume.py:429-452` builds it, with a tail window.
- The trainer: ``rgb_cap -2`` equals dense shading once measured (the
  port's twin of `tests/test_train_e2e.py:79`), staged trajectories with
  ``rgb_cap`` -2 and 64 across mask events against the JAX trainer (the
  statistic and the picked capacity exactly), a checkpoint with a measured
  capacity read by both packages, and the CLI on `configs/synthetic_smoke.txt`
  and with ``--rgb_cap`` -1 / -2 and ``--group_size 0 --mask_stride 4``.

``torch.topk`` does not promise ``jax.lax.top_k``'s order among equal
weights; the ties are weights of 0, which shade nothing and take no
gradient, so outputs and gradients are compared, and the picked samples
only where the K-th weight clears the threshold and the next lies clearly
below it.

Tolerances: composite outputs and gradients 1e-5 of each one's largest
magnitude; renders 1e-4 and leaf gradients 1e-5 of each leaf's largest in
float32 (2e-2 in bfloat16: the two packages round the bfloat16 features and
decoders alike but sum in another order); ``-2`` against dense, the loss to
rtol 1e-6 and the gradients to 1e-4; the trajectories' losses to rtol 2e-3,
as `tests/test_torch_staged_parity.py`.
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
from test_torch_composite import THRES, _inputs  # noqa: E402
from test_torch_render import AABB, ALPHA_AABB, REPO, STEP, _alpha_volume, _model, _rays  # noqa: E402
from test_torch_staged_parity import _step_jitter  # noqa: E402

from ngf_tpu.config import config_parser as j_config_parser  # noqa: E402
from ngf_tpu.data import registry as j_registry  # noqa: E402
from ngf_tpu.fields import triplane as jt  # noqa: E402
from ngf_tpu.ops import compaction as j_compaction  # noqa: E402
from ngf_tpu.ops import compositing as j_comp  # noqa: E402
from ngf_tpu.render import volume as jv  # noqa: E402
from ngf_tpu.train.loop import TriPlaneTrainer as JTrainer  # noqa: E402
from ngf_tpu_torch import convert  # noqa: E402
from ngf_tpu_torch.config import config_parser as t_config_parser  # noqa: E402
from ngf_tpu_torch.convert import named_leaves  # noqa: E402
from ngf_tpu_torch.data import load_dataset  # noqa: E402
from ngf_tpu_torch.fields import triplane as tt  # noqa: E402
from ngf_tpu_torch.ops import compositing as t_comp  # noqa: E402
from ngf_tpu_torch.ops import gather as t_gather  # noqa: E402
from ngf_tpu_torch.ops.grid_sample import normalize_coord  # noqa: E402
from ngf_tpu_torch.ops.rays import stratified_sample  # noqa: E402
from ngf_tpu_torch.render import volume as tv  # noqa: E402
from ngf_tpu_torch.train.loop import TriPlaneTrainer, model_config_from_args  # noqa: E402

TOL = 1e-5
RENDER_TOL = 1e-4
BF16_TOL = 2e-2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what, tol=TOL):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


# ------------------------------------------------------------- composite


def _jax_topk_composite(sigma, dist, rgb, z, ray_last, background, k, group, vmask):
    """The JAX renderers' top-K lines from sigma and the colours of every
    sample: dense (`volume.py:473-487`, ``group`` 0: the top k samples) or
    grouped (`:315-338`, the top k groups of ``group``)."""
    if vmask is not None:
        sigma = sigma * vmask
    _, weight, _ = j_comp.raw2alpha(sigma, dist)
    acc = jnp.sum(weight, axis=-1)
    if group == 0:
        top_w, top = jax.lax.top_k(weight, k)
        rgb_k = jnp.take_along_axis(rgb, top[..., None], axis=1)
        w_k, mask = top_w, (top_w > THRES).astype(weight.dtype)
    else:
        n, s = weight.shape
        _, top = jax.lax.top_k(weight.reshape(n, s // group, group).max(-1), k)
        m = jnp.ones_like(weight) if vmask is None else vmask
        wm = j_compaction.gather_groups(jnp.stack([weight, m], -1), top, group)
        rgb_k = j_compaction.gather_groups(rgb, top, group)
        w_k = wm[..., 0]
        mask = (w_k > THRES).astype(weight.dtype) * wm[..., 1]
    rgb_map = jnp.sum((w_k * mask)[..., None] * rgb_k, axis=-2)
    if background == "white":
        rgb_map = rgb_map + (1.0 - acc[..., None])
    elif background is not None:
        rgb_map = rgb_map + jnp.float32(background) * (1.0 - acc[..., None])
    rgb_map = jnp.clip(rgb_map, 0.0, 1.0)
    depth = jax.lax.stop_gradient(jnp.sum(weight * z, axis=-1) + (1.0 - acc) * ray_last)
    return rgb_map, acc, depth, top


def _port_topk(sigma, dist, rgb, z, ray_last, vmask, background, k, group, g_rgb, g_acc):
    """The port's top-K composite as the renderers run it, the colours
    gathered with ``gather_group_rows``; returns its outputs, the picked
    ids and the gradients of sum(rgb_map g_rgb) + sum(acc g_acc) in sigma
    and rgb."""
    s = torch.from_numpy(sigma).requires_grad_(True)
    c = torch.from_numpy(rgb).requires_grad_(True)
    sig = s if vmask is None else s * torch.from_numpy(vmask)
    d = torch.from_numpy(dist) if isinstance(dist, np.ndarray) else dist
    if background == "white":
        b = 1.0
    elif background is not None:
        b = torch.tensor(background, dtype=torch.float32)  # the training draw
    else:
        b = None
    w, acc, depth = t_comp.composite_weights(sig, d, torch.from_numpy(z), torch.from_numpy(ray_last))
    n, S = w.shape
    g = max(group, 1)
    best = w.detach() if group == 0 else w.detach().reshape(n, S // g, g).amax(-1)
    top = torch.topk(best, k, dim=-1).indices
    rgb_map = t_comp.composite_topk(w, acc, top, g, t_gather.gather_group_rows(c, top, g), b, THRES)
    ((rgb_map * torch.from_numpy(g_rgb)).sum() + (acc * torch.from_numpy(g_acc)).sum()).backward()
    outs = [t.detach().numpy() for t in (rgb_map, acc, depth)]
    return outs, top.numpy(), best.numpy(), s.grad.numpy(), c.grad.numpy()


COMPOSITE_CASES = [("dense_white", 16, 0), ("dense_eval", 48, 0), ("grouped_draw1", 4, 8),
                   ("grouped_draw0", 3, 8), ("opaque", 1, 8), ("empty", 5, 8)]


@pytest.mark.parametrize("case,k,group", COMPOSITE_CASES, ids=[c[0] for c in COMPOSITE_CASES])
def test_topk_composite_matches_jax_and_its_vjp(case, k, group):
    sigma, dist, rgb, z, ray_last, vmask, background = _inputs(case)
    n = sigma.shape[0]
    rng = np.random.default_rng(5)
    g_rgb = rng.normal(size=(n, 3)).astype(np.float32)
    g_acc = rng.normal(size=(n,)).astype(np.float32)
    outs, top, best, d_sigma, d_rgb = _port_topk(sigma, dist, rgb, z, ray_last, vmask, background,
                                                 k, group, g_rgb, g_acc)

    def f(s, c):
        rgb_map, acc, _, _ = _jax_topk_composite(s, dist, c, z, ray_last, background, k, group,
                                                 vmask)
        return rgb_map, acc

    (j_rgb, j_acc), vjp = jax.vjp(f, jnp.asarray(sigma), jnp.asarray(rgb))
    j_ds, j_drgb = vjp((jnp.asarray(g_rgb), jnp.asarray(g_acc)))
    _, _, j_depth, j_top = _jax_topk_composite(sigma, dist, rgb, z, ray_last, background, k, group,
                                               vmask)
    for got, want, what in zip(outs + [d_sigma, d_rgb],
                               [j_rgb, j_acc, j_depth, j_ds, j_drgb],
                               ("rgb_map", "acc", "depth", "d sigma", "d rgb")):
        _close(got, np.asarray(want), what)
    if case == "empty":  # no weight clears the threshold: nothing to pick
        assert (outs[0][: n // 2] == 1.0).all()
        return
    # The picks, where the k-th weight clears the threshold and the next
    # lies clearly below it (not within the two packages' rounding).
    srt = -np.sort(-best, axis=-1)
    distinct = (srt[:, k - 1] > srt[:, k] * (1 + 1e-3)) & (srt[:, k - 1] > THRES)
    assert distinct.any()
    for i in np.flatnonzero(distinct):
        assert set(top[i]) == set(np.asarray(j_top)[i]), i


@pytest.mark.parametrize("ids", ["in range", "outside"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 8])
def test_gather_group_rows_matches_gather_groups_and_its_vjp(dtype, group, ids):
    """``ids`` "outside": each ray's ids are -1, -ng, ng, -ng - 1 and 2 in
    some order. ``take_along_axis`` wraps the first two into the ray's
    groups and fills the last ray's NaN for the next two (their cotangent
    dropped); the port must neither read nor write a neighbouring ray."""
    rng = np.random.default_rng(group)
    n, ng, d = 6, 5, 7
    if ids == "in range":
        k = 3
        idx = np.stack([rng.permutation(ng)[:k] for _ in range(n)]).astype(np.int64)
    else:
        k = 5
        idx = np.stack([rng.permutation([-1, -ng, ng, -ng - 1, 2]) for _ in range(n)])
    x = rng.normal(size=(n, ng * group, d)).astype(np.float32)
    g = rng.normal(size=(n, k * group, d)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want, vjp = jax.vjp(lambda a: j_compaction.gather_groups(a, jnp.asarray(idx), group),
                        jnp.asarray(x, jdt))
    (want_g,) = vjp(jnp.asarray(g, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    got = t_gather.gather_group_rows(xt, torch.from_numpy(idx), group)
    got.backward(torch.from_numpy(g).to(tdt))
    assert got.dtype == xt.grad.dtype == tdt
    # assert_array_equal holds a NaN equal to a NaN.
    np.testing.assert_array_equal(got.detach().float().numpy(), np.asarray(want, np.float32))
    np.testing.assert_array_equal(xt.grad.float().numpy(), np.asarray(want_g, np.float32))
    assert np.isnan(np.asarray(want, np.float32)).any() == (ids == "outside")
    # The segments' absolute rows, each inside its own ray's segment, NaN
    # where an id names none; the scatter writes those rows and zeros
    # everywhere else, its own ray's rows only.
    tab = torch.from_numpy(x).reshape(n * ng, group * d)
    flat = torch.from_numpy(idx).reshape(-1)
    ray = torch.arange(n * k) // k
    inside = (flat >= -ng) & (flat < ng)
    rows = torch.where(flat < 0, flat + ng, flat) + ray * ng
    assert bool((rows[inside] // ng == ray[inside]).all())
    picked = t_gather.gather_rows_plain(tab, flat, k, ng)
    assert torch.equal(picked[inside], tab[rows[inside]]) and bool(picked[~inside].isnan().all())
    back = t_gather.scatter_rows_plain(torch.ones((n * k, group * d)), flat, n * ng, k, ng)
    written = torch.zeros(n * ng, dtype=torch.bool)
    written[rows[inside]] = True
    assert torch.equal(back.abs().sum(-1) > 0, written) and bool((back[written] == 1).all())


# ---------------------------------------------------------------- render


def _gauge_model(seed=0, bias=5.5):
    cfg = dataclasses.replace(jt.TriPlaneConfig.gauge_preset(gauge_start=0), plane_res=16,
                              gauge_res=8)
    params = jax.device_get(jt.init_triplane(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    for name in ("gauge_xy", "gauge_yz", "gauge_xz"):
        params[name] = (0.05 * rng.normal(size=params[name].shape)).astype(np.float32)
    params["density_decoder"]["b"] = np.full((1,), bias, np.float32)
    return cfg, params


# (id, RenderConfig overrides, compute dtype, variant, density bias, mask).
# "infoinv" is the InfoInv model without its PE multiply, "pe" with it.
RENDER_CASES = [
    ("dense16", {"rgb_cap": 16}, "float32", "infoinv", 5.5, False),
    ("dense48_masked", {"rgb_cap": 48}, "float32", "infoinv", 5.5, True),
    ("dense16_pe", {"rgb_cap": 16}, "float32", "pe", 5.5, False),
    ("dense16_bf16", {"rgb_cap": 16}, "bfloat16", "pe", 5.5, False),
    ("grouped_fused0", {"group_size": 8, "rgb_cap": 16}, "float32", "infoinv", 5.5, True),
    ("grouped_fused1", {"group_size": 8, "rgb_cap": 16, "fused_fetch": True}, "float32",
     "infoinv", 5.5, False),
    ("grouped_fused0_bf16", {"group_size": 8, "rgb_cap": 16}, "bfloat16", "pe", 5.5, False),
    ("grouped_fused1_bf16", {"group_size": 8, "rgb_cap": 24, "fused_fetch": True}, "bfloat16",
     "pe", 5.5, True),
    ("dense16_gauge", {"rgb_cap": 16}, "float32", "gauge", 5.5, False),
    ("grouped_gauge", {"group_size": 8, "rgb_cap": 16}, "float32", "gauge", 5.5, False),
    ("dense16_opaque", {"rgb_cap": 16}, "float32", "infoinv", 17.0, False),
]
# The InfoInv PE multiply at 12 frequencies: JAX's compiled sin and cos
# round otherwise than PyTorch's, which moves the gradients of the planes
# and of the appearance basis by up to 4e-5 of the largest on the dense
# path without top-K too (`tests/test_torch_grouped.py` holds them to 1e-4).
PE_GRAD_TOL = 1e-4


def _render_and_grads(cfg, params, kw, masked):
    """rgb, depth and acc of the port's and of `ngf_tpu`'s ``render_rays``
    (evaluation mode) and the gradients of every leaf of sum(rgb_map g) +
    sum(acc_map), the JAX side by ``jax.grad``, compiled."""
    kw = dict(aabb=AABB, n_samples=52, step_size=STEP, tile_q=0, **kw)
    jr, tr = jv.RenderConfig(**kw), tv.RenderConfig(**kw)
    rays = _rays()
    j_kw, t_kw = {}, {}
    if masked:
        vol = _alpha_volume(1)
        j_kw = dict(alpha_volume=jnp.asarray(vol), alpha_aabb=jnp.asarray(ALPHA_AABB))
        t_kw = dict(alpha_volume=torch.from_numpy(vol), alpha_aabb=torch.from_numpy(ALPHA_AABB))
    g = np.random.default_rng(2).normal(size=(rays.shape[0], 3)).astype(np.float32)

    def j_loss(p):
        out = jv.render_rays(p, cfg, jr, jnp.asarray(rays), None, is_train=False, iteration=3,
                             **j_kw)
        return jnp.sum(out["rgb_map"] * g) + jnp.sum(out["acc_map"]), out

    (_, want), grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    tparams = convert.params_from_numpy(params, "cpu")
    for _, p in named_leaves(tparams):
        p.requires_grad_(True)
    out = tv.render_rays(tparams, tt.TriPlaneConfig(**dataclasses.asdict(cfg)), tr,
                         torch.from_numpy(rays), iteration=3, **t_kw)
    ((out["rgb_map"] * torch.from_numpy(g)).sum() + out["acc_map"].sum()).backward()
    want_leaves = dict(named_leaves(convert.params_from_numpy(jax.device_get(grads), "cpu")))
    got = {k: out[k].detach().numpy() for k in ("rgb_map", "depth_map", "acc_map")}
    pairs = {leaf: (p.grad.numpy(), want_leaves[leaf].numpy()) for leaf, p in named_leaves(tparams)}
    return got, {k: np.asarray(want[k]) for k in got}, pairs


def _rel_err(pair) -> float:
    got, want = pair
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name,kw,dtype,variant,bias,masked", RENDER_CASES,
                         ids=[c[0] for c in RENDER_CASES])
def test_topk_render_and_leaf_gradients_match_jax(name, kw, dtype, variant, bias, masked):
    """float32: outputs to 1e-4, each leaf's gradient to 1e-5 of its
    largest (PE_GRAD_TOL behind the PE). bfloat16: outputs to rtol 2e-2;
    the gradients against the float32 ones of JAX (the same function in
    more precision): each leaf's port gradient no farther from them than
    the JAX package's bfloat16 gradient, plus 2e-2 of the largest. (The
    JAX package's bfloat16 plane gradients lie up to 1e-1 of the largest
    away, from its bfloat16 fetch's backward, 6e-2 with dense shading; the
    port's within 3e-2. Both packages' bfloat16 decoders lie about 4e-2
    away, rounding in different orders.)"""
    if variant == "gauge":
        cfg, params = _gauge_model(bias=bias)
    else:
        cfg, params = _model(bias=bias, infoinv=variant == "pe")
    cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    if kw.get("group_size"):
        assert kw["rgb_cap"] // 8 < -(-52 // 8)  # the grouped top-K branch
    got, want, pairs = _render_and_grads(cfg, params, kw, masked)
    assert 0.02 < got["acc_map"].mean() < 0.98 or bias > 10, got["acc_map"].mean()
    bf16 = dtype == "bfloat16"
    tol = BF16_TOL if bf16 else RENDER_TOL
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol, err_msg=k)
    if bf16:
        _, _, f32 = _render_and_grads(dataclasses.replace(cfg, compute_dtype="float32"), params,
                                      kw, masked)
        for leaf, (g, w) in pairs.items():
            ref = f32[leaf][1]
            assert _rel_err((g, ref)) <= _rel_err((w, ref)) + BF16_TOL, leaf
    else:
        for leaf, (g, w) in pairs.items():
            pe = variant == "pe" and (leaf.startswith("plane") or leaf == "rgb_decoder/basis/w")
            _close(g, w, leaf, PE_GRAD_TOL if pe else TOL)
    if variant == "gauge":
        assert np.abs(pairs["gauge_xy"][0]).max() > 0


@pytest.mark.parametrize("stride", [2, 4])
def test_dense_mask_stride_valid_mask_is_jax_exactly(stride):
    """53 samples: the tail window's centre lies past the last sample for
    both strides, and takes the last centre's test."""
    rays = torch.from_numpy(_rays())
    aabb = torch.tensor(AABB)
    pts, _, _ = stratified_sample(rays[:, :3], rays[:, 3:], aabb, 2.0, 6.0, 53, STEP)
    vol = _alpha_volume(2)
    got = tv._occupied(torch.from_numpy(vol.astype(np.uint8)), pts, torch.from_numpy(ALPHA_AABB),
                       stride)
    # `ngf_tpu/render/volume.py:431-452` on the same points.
    jp = jnp.asarray(pts.numpy())
    sub = jp[:, stride // 2 :: stride]
    a_sub = jv._sample_alpha_volume(jnp.asarray(vol), jv.normalize_coord(sub, jnp.asarray(ALPHA_AABB)))
    alphas = jnp.repeat(a_sub, stride, axis=1)
    assert alphas.shape[1] < 53  # the tail window
    alphas = jnp.concatenate([alphas, jnp.repeat(alphas[:, -1:], 53 - alphas.shape[1], 1)], 1)
    want = np.asarray(alphas[:, :53] > 0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.05 < want.mean() < 0.95
    # Every window shares its centre's test.
    w = got[:, : (53 // stride) * stride].reshape(got.shape[0], -1, stride)
    assert bool((w == w[..., :1]).all())
    assert normalize_coord(pts, aabb).shape == pts.shape


@pytest.mark.parametrize("stride", [4])
def test_dense_mask_stride_render_matches_jax(stride):
    cfg, params = _model(3)
    kw = dict(aabb=AABB, n_samples=53, step_size=STEP, mask_stride=stride)
    vol = _alpha_volume(3)
    rays = _rays()
    want = jv.render_rays(params, cfg, jv.RenderConfig(**kw), jnp.asarray(rays), None,
                          is_train=False, alpha_volume=jnp.asarray(vol),
                          alpha_aabb=jnp.asarray(ALPHA_AABB))
    got = tv.render_rays(convert.params_from_numpy(params, "cpu"),
                         tt.TriPlaneConfig(**dataclasses.asdict(cfg)), tv.RenderConfig(**kw),
                         torch.from_numpy(rays), alpha_volume=torch.from_numpy(vol),
                         alpha_aabb=torch.from_numpy(ALPHA_AABB))
    for k in ("rgb_map", "depth_map", "acc_map"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RENDER_TOL,
                                   atol=RENDER_TOL, err_msg=k)


# --------------------------------------------------------------- trainer

DATADIR = "synthetic:views=2,wh=16,test_views=1"
ARGV = [
    "--config", os.path.join(REPO, "configs", "synthetic_infoinv_tpu.txt"), "--datadir", DATADIR,
    "--plane_res", "32", "--nSamples", "96", "--batch_size", "64", "--open_sample_cap", "96",
    "--alpha_grid_res", "12", "--prewarm_events", "0", "--eval_chunk", "64",
    # A threshold at which the measured capacity (-2) picks fewer groups
    # than the masked stage keeps, so that it caps.
    "--rm_weight_mask_thre", "1e-3",
]


def _start_weights(targs, seed=3):
    """The JAX initialisation with the planes 300 times their scale and the
    density bias at 0: the events find part of the lattice occupied
    (`tests/test_torch_staged_parity.py`)."""
    cfg = jt.TriPlaneConfig(**dataclasses.asdict(model_config_from_args(targs)))
    params = jax.device_get(jt.init_triplane(jax.random.PRNGKey(seed), cfg))
    for name in ("plane_xy", "plane_yz", "plane_xz"):
        params[name] = params[name] * np.float32(300.0)
    params["density_decoder"]["mlp"]["layers"][-1]["b"] = np.full((1,), 0.0, np.float32)
    return params


def test_auto_rgb_cap_matches_dense():
    """``rgb_cap -2`` reproduces dense shading once measured: every group it
    drops is below the shading threshold, which shades nothing in either
    mode (the port's twin of `tests/test_train_e2e.py:79`)."""
    targs = t_config_parser(ARGV + ["--n_iters", "6", "--update_AlphaMask_list", "3",
                                    "--rgb_cap", "-2", "--device", "cpu"])
    tds = load_dataset("synthetic", DATADIR, split="train", is_stack=False)
    ours = TriPlaneTrainer(targs, tds, init_params=convert.params_from_numpy(
        _start_weights(targs), "cpu"), device="cpu")
    ours.run()
    assert ours._auto_rgb_cap > 0 and ours._auto_rgb_cap % targs.group_size == 0
    rcfg = ours._render_cfg()
    assert rcfg.rgb_cap == ours._auto_rgb_cap
    capg = -(-ours._effective_sample_cap() // targs.group_size)
    assert rcfg.rgb_cap // targs.group_size < capg  # the top-K branch runs
    rays, rgbs = ours.all_rays[:256], ours.all_rgbs[:256]
    results = []
    for r in (rcfg, dataclasses.replace(rcfg, rgb_cap=0)):
        for _, p in named_leaves(ours.params):
            p.grad = None
        out = tv.render_rays(ours.params, ours.model_cfg, r, rays, iteration=ours.iteration,
                             generator=torch.Generator().manual_seed(7), **ours._alpha_kw())
        loss = ((out["rgb_map"] - rgbs) ** 2).mean()
        loss.backward()
        results.append((loss.item(), {n: p.grad.clone() for n, p in named_leaves(ours.params)},
                        out["shaded_groups"]))
    (l_top, g_top, shaded), (l_dense, g_dense, _) = results
    assert int(shaded.max()) <= rcfg.rgb_cap // targs.group_size  # why it is exact here
    assert l_top == pytest.approx(l_dense, rel=1e-6)
    for n, g in g_dense.items():
        np.testing.assert_allclose(g_top[n].numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(g.abs().max()), err_msg=n)


@pytest.mark.parametrize("rgb_cap", [-2, 64])
def test_topk_trajectory_matches_jax_trainer(monkeypatch, tmp_path, rgb_cap):
    """Five grouped steps with mask events after the second and the
    fourth, from identical weights on the same batches and jitter: the
    losses, and at each event the statistic and the picked capacity. With
    -2 a checkpoint holding the measured capacity is read back by both
    packages."""
    events, n_iters = (2, 4), 5
    argv = ARGV + ["--n_iters", str(n_iters), "--rgb_cap", str(rgb_cap)] + [
        a for e in events for a in ("--update_AlphaMask_list", str(e))]
    jargs = j_config_parser(argv)
    targs = t_config_parser(argv + ["--device", "cpu"])
    jds = j_registry.load_dataset("synthetic", DATADIR, split="train", is_stack=False)
    tds = load_dataset("synthetic", DATADIR, split="train", is_stack=False)
    params = _start_weights(targs)
    ours = TriPlaneTrainer(targs, tds, init_params=convert.params_from_numpy(params, "cpu"),
                           device="cpu")
    with jax.disable_jit():
        theirs = JTrainer(jargs, jds, init_params=jax.tree.map(jnp.asarray, params))
    gen = torch.Generator()
    losses_j, losses_t, topk_steps = [], [], 0
    for _ in range(n_iters):
        rcfg = ours._render_cfg()
        assert rcfg.rgb_cap == theirs._render_cfg().rgb_cap
        capg = -(-ours._effective_sample_cap() // 8)
        topk_steps += 0 < rcfg.rgb_cap and rcfg.rgb_cap // 8 < capg
        jitter = _step_jitter(theirs)
        monkeypatch.setattr(tv, "_ray_jitter", lambda g, n, device: torch.from_numpy(jitter))
        losses_j.append(float(theirs.train_block(1)[0]))
        losses_t.append(float(ours.train_step(*ours.next_batch(), gen)))
        assert int(ours.rgb_stat) == theirs._rgb_stat
        if ours.iteration in events:
            first = ours.iteration == events[0]
            with jax.disable_jit():
                theirs._event_update_alpha_mask(first=first)
            ours._event_update_alpha_mask(first=first)
            assert ours._auto_cap == theirs._auto_cap
            assert int(ours.rgb_stat) == theirs._rgb_stat
            assert ours._auto_rgb_cap == theirs._auto_rgb_cap
    np.testing.assert_allclose(losses_t, losses_j, rtol=2e-3, atol=2e-5)
    assert topk_steps >= 2
    if rgb_cap == -2:
        assert ours._auto_rgb_cap > 0
        path = str(tmp_path / "ours.npz")
        ours.save(path)
        with jax.disable_jit():
            back = JTrainer.from_checkpoint(path, jargs, jds)
        assert back._auto_rgb_cap == ours._auto_rgb_cap and back._rgb_stat == int(ours.rgb_stat)
        jpath = str(tmp_path / "theirs.npz")
        theirs.save(jpath)
        mine = TriPlaneTrainer.from_checkpoint(jpath, targs, tds, device="cpu")
        assert mine._auto_rgb_cap == theirs._auto_rgb_cap
        assert int(mine.rgb_stat) == theirs._rgb_stat
        assert mine._render_cfg().rgb_cap == theirs._auto_rgb_cap


CLI_CASES = {
    "smoke": ["--config", os.path.join(REPO, "configs", "synthetic_smoke.txt")],
    "auto": ["--config", os.path.join(REPO, "configs", "synthetic_infoinv_tpu.txt"),
             "--rgb_cap", "-2"],
    "quarter": ["--config", os.path.join(REPO, "configs", "synthetic_infoinv_tpu.txt"),
                "--rgb_cap", "-1", "--open_sample_cap", "160"],
    "dense_stride": ["--config", os.path.join(REPO, "configs", "synthetic_infoinv_tpu.txt"),
                     "--group_size", "0", "--mask_stride", "4", "--rgb_cap", "16"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_trains_with_topk_and_mask_stride(tmp_path, case):
    """`main_torch.py` on the CPU at a tiny size: the smoke recipe as it is
    (grouped, ``rgb_cap 64``, ``sample_cap 512``, ``microbatch 4``),
    ``--rgb_cap -2`` and ``-1``, and the dense path with ``--mask_stride 4``;
    each trains across a mask event and renders the test view."""
    import main_torch

    argv = CLI_CASES[case] + [
        "--device", "cpu", "--plane_res", "32", "--alpha_grid_res", "16", "--nSamples", "96",
        "--batch_size", "128", "--n_iters", "6", "--update_AlphaMask_list", "3",
        "--density_shift", "0", "--datadir", "synthetic:views=2,wh=16,test_views=1",
        "--render_test", "1", "--compute_extra_metrics", "0", "--basedir", str(tmp_path),
        "--expname", case]
    out = main_torch.main(argv)
    assert out["iterations"] == 6 and np.isfinite(out["train_mses"]).all()
    assert [e["iteration"] for e in out["events"]] == [3]
    assert len(out["test_psnrs"]) == 1 and np.isfinite(out["test_psnrs"][0])
    assert (tmp_path / case / "model.npz").is_file()
    if case == "auto":
        assert out["events"][0]["auto_rgb_cap"] % 8 == 0


def test_chip_smoke_topk_phase_on_cpu():
    """`chip_smoke.py`'s topk phase at a tiny size on the CPU (plain
    versions): the smoke recipe (``rgb_cap 64``, ``microbatch 4``, its
    fixed capacity cut to 96), the dense staged run and the ``-2`` run
    across a mask event, the picked capacity, the PSNR gap, and the masked
    model rendered densely with ``mask_stride`` 1 and 4."""
    import chip_smoke

    small = ("--plane_res", "32", "--alpha_grid_res", "16", "--nSamples", "96",
             "--batch_size", "256", "--open_sample_cap", "96", "--n_iters", "8",
             "--update_AlphaMask_list", "4", "--density_shift", "0",
             "--rm_weight_mask_thre", "1e-3", "--eval_chunk", "256")
    out = chip_smoke.topk_phase(torch.device("cpu"), views=2, wh=16, extra=small,
                                smoke_extra=small + ("--sample_cap", "96"))
    assert out["auto_rgb_caps"][0] > 0 and out["psnr_gap_db"] <= chip_smoke.TOPK_PSNR_GAP_DB
    assert out["smoke"]["args"].rgb_cap == 64 and out["smoke"]["event"]["capg"] == 12
    assert sorted(out["stride"]) == ["stride 1", "stride 4"]
    assert all(np.isfinite(r["psnr"]) for r in out["stride"].values())
