"""bfloat16 training of the port against the JAX package on the CPU.

- The plain versions of K2 and K2c (``grid_sample_2d_backward_plain``,
  ``grid_sample_planes_backward_coords_plain``, reached through the fetch's
  ``dtype``) on bfloat16 plane values and cotangents against ``jax.vjp`` of
  `ngf_tpu`'s bfloat16 fetch (`ngf_tpu/fields/triplane.py:196-206`: the
  float32 plane cast to bfloat16, then ``grid_sample_2d``): 1 to 3 planes
  of their own shapes, split and unsplit, texel edges and points outside.
  Both are also held against a float64 gradient of the same bfloat16
  values, cotangents and float32 coordinates: the port sums in float32 with
  float32 weights, the JAX package multiplies by bfloat16 weights and
  scatter-adds in bfloat16, so the port's error must be no larger than the
  JAX package's, and within 1e-5 of the largest (float32 weights and
  sums). Port and JAX agree to 2^-5 of the largest gradient, the JAX
  package's own bfloat16 error with room.
- K2's lane choice for a bfloat16 cotangent (4 channels an 8-byte load,
  alignment in 2-byte elements).
- ``apply_linear`` with bfloat16 weights against the JAX layer
  (`ngf_tpu/fields/decoders.py:63-70`), forward and ``jax.vjp``: both keep
  the product in float32 and round once, so they agree to one bfloat16
  unit in the last place (2^-7 of the value) where their float32 sums
  round to neighbours.
- The fused fetch's plane gradients in bfloat16 (InfoInv and the gauge
  preset) against ``jax.vjp``: 2^-5 of the largest, as above.
- Six staged InfoInv steps in bfloat16 with a first mask event and a later
  one (``update_AlphaMask_list [2, 4]``) against the JAX trainer, from
  identical weights on the same batches and jitter, as
  `tests/test_torch_staged_parity.py` runs them. A bfloat16 density near
  ``alpha_mask_thre`` could put a voxel on the other side in one package
  (the two round the fetch's weights apart); at this seed and size no
  voxel does, so the mask volumes are held equal voxel for voxel at both
  events, and with them the boxes, kept rays, sampler ids, capacities and
  the L1 switch. Losses to rtol 2e-2: bfloat16 features and decoder layers,
  rounded at other places in the fetch.
- ``float32_accumulation`` sets the float32-sum switches only while it
  runs, as a context and as the trainer's decorator.
- Both bfloat16 configs through `main_torch.py` at a tiny size
  (``configs/synthetic_infoinv_tpu30k.txt`` with three mask events and
  ``configs/synthetic_triplane_tpu_bf16.txt`` with its gauge, shrink and
  upsample), whose ``model.npz`` `ngf_tpu` reads back in float32.

The kernels themselves are tested on the card by `tests/test_torch_cuda.py`.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from test_torch_staged_parity import _step_jitter  # noqa: E402
from test_torch_triplane import _jax_proj, _setup, _torch_proj  # noqa: E402

from ngf_tpu.config import config_parser as j_config_parser  # noqa: E402
from ngf_tpu.data import registry as j_registry  # noqa: E402
from ngf_tpu.fields import decoders as jd  # noqa: E402
from ngf_tpu.fields import triplane as jt  # noqa: E402
from ngf_tpu.ops import grid_sample as j_gs  # noqa: E402
from ngf_tpu.train.loop import TriPlaneTrainer as JTrainer  # noqa: E402
from ngf_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint  # noqa: E402
from ngf_tpu_torch import convert  # noqa: E402
from ngf_tpu_torch.config import config_parser as t_config_parser  # noqa: E402
from ngf_tpu_torch.data import load_dataset  # noqa: E402
from ngf_tpu_torch.fields import decoders as td  # noqa: E402
from ngf_tpu_torch.fields import triplane as tt  # noqa: E402
from ngf_tpu_torch.ops import cuda_kernels  # noqa: E402
from ngf_tpu_torch.ops import grid_sample as t_gs  # noqa: E402
from ngf_tpu_torch.render import volume as tv  # noqa: E402
from ngf_tpu_torch.train.loop import TriPlaneTrainer, model_config_from_args  # noqa: E402

BF16 = torch.bfloat16
# Port against the JAX package's bfloat16 gradients, of the largest: the
# JAX package's own error against float64 (bfloat16 weights and adds, up to
# about 1e-2) with room.
GRAD_TOL = 2.0 ** -5
ULP = 2.0 ** -7
PLANES = ("plane_xy", "plane_yz", "plane_xz")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bfloat16, as float32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF16).float().numpy()


def _float64_grads(plane, coords, g):
    """The plane and coordinate gradients of a bilinear fetch in float64:
    ``plane`` (H, W, C) and ``g`` (N, C) bfloat16 values, ``coords`` (N, 2)
    float32, the stencil and weights of `grid_sample_2d` computed in
    float64."""
    H, W, C = plane.shape
    c = torch.from_numpy(coords).double()
    gg = torch.from_numpy(g).double()
    flat = torch.from_numpy(plane).double().reshape(H * W, C)
    x, y = t_gs._unnormalize(c[:, 0], W), t_gs._unnormalize(c[:, 1], H)
    xs, wx0, wx1 = t_gs._axis_patch_weights(x, W)
    ys, wy0, wy1 = t_gs._axis_patch_weights(y, H)
    dwx0, dwx1 = (d.double() for d in t_gs._axis_weight_grads(x, W))
    dwy0, dwy1 = (d.double() for d in t_gs._axis_weight_grads(y, H))
    idx = ys * W + xs
    taps = ((0, wy0 * wx0, wy0 * dwx0, dwy0 * wx0), (1, wy0 * wx1, wy0 * dwx1, dwy0 * wx1),
            (W, wy1 * wx0, wy1 * dwx0, dwy1 * wx0), (W + 1, wy1 * wx1, wy1 * dwx1, dwy1 * wx1))
    dplane = torch.zeros((H * W, C), dtype=torch.float64)
    gx = torch.zeros(c.shape[0], dtype=torch.float64)
    gy = torch.zeros_like(gx)
    for off, w, kx, ky in taps:
        dplane.index_add_(0, idx + off, gg * w[:, None])
        t = (flat[idx + off] * gg).sum(-1)
        gx += t * kx * (0.5 * (W - 1))
        gy += t * ky * (0.5 * (H - 1))
    return dplane.reshape(H, W, C).numpy(), torch.stack([gx, gy], -1).numpy()


def _rel_err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", ["one_plane", "three_shapes_split", "two_planes_unsplit",
                                  "edges", "outside"])
def test_plain_k2_k2c_bf16_match_jax_vjp_and_float64(case):
    """The fetch of float32 planes in bfloat16 (``dtype``) on the CPU, its
    plane gradients through the plain K2 (coordinates without a gradient)
    and both gradients through the plain K2c, against ``jax.vjp`` of the
    JAX package's bfloat16 fetch per plane and against float64."""
    rng = np.random.default_rng({"one_plane": 1, "three_shapes_split": 2,
                                 "two_planes_unsplit": 3, "edges": 4, "outside": 5}[case])
    shapes = {"one_plane": [(9, 13)], "two_planes_unsplit": [(9, 13), (17, 9)]}.get(
        case, [(9, 13), (17, 9), (17, 13)])
    channels, split = {"one_plane": (slice(0, 24), 8), "two_planes_unsplit": (slice(4, 20), None),
                       "outside": (slice(3, 13), 5)}.get(case, (slice(None), 16))
    n = 200
    planes = [rng.normal(size=(h, w, 24)).astype(np.float32) for h, w in shapes]
    if case == "edges":  # texel centres and edges of the 17 x 9 and 9 x 13 lattices
        xyz = (-1 + rng.integers(0, 33, (n, 3)) / 16).astype(np.float32)
    else:
        lim = 1.6 if case == "outside" else 1.05
        xyz = rng.uniform(-lim, lim, (n, 3)).astype(np.float32)
    coords = [xyz[:, 0:2], xyz[:, 1:3], xyz[:, 0::2]][:len(shapes)]
    C = len(range(24)[channels])
    g = _bf16(rng.normal(size=(n, len(shapes), C)))
    g_a, g_b = (g, None) if split is None else (g[..., :split], g[..., split:])

    got = {}
    for coord_grad in (False, True):
        ps = [torch.from_numpy(p).requires_grad_(True) for p in planes]
        cs = [torch.from_numpy(c).requires_grad_(coord_grad) for c in coords]
        out_a, out_b = t_gs.grid_sample_planes(ps, cs, channels, split, dtype=BF16)
        assert out_a.dtype == BF16 and (out_b is None or out_b.dtype == BF16)
        outs = [out_a] + ([] if out_b is None else [out_b])
        cots = [torch.from_numpy(g_a).to(BF16)] + ([] if g_b is None else [
            torch.from_numpy(g_b).to(BF16)])
        torch.autograd.backward(outs, cots)
        got[coord_grad] = ([p.grad.numpy() for p in ps],
                           [c.grad.numpy() for c in cs] if coord_grad else None)
    for a, b in zip(got[False][0], got[True][0]):  # K2 and K2c: one plane gradient
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * np.abs(b).max())

    for i, (plane, c) in enumerate(zip(planes, coords)):
        def fetch(p, cc):
            return j_gs.grid_sample_2d(p[..., channels].astype(jnp.bfloat16), cc)

        _, vjp = jax.vjp(fetch, jnp.asarray(plane), jnp.asarray(c))
        j_plane, j_coords = (np.asarray(t, np.float32) for t in vjp(jnp.asarray(g[:, i], jnp.bfloat16)))
        full_plane64 = np.zeros(plane.shape)
        d64, c64 = _float64_grads(_bf16(plane[..., channels]), c, g[:, i])
        full_plane64[..., channels] = d64
        port_plane, port_coords = got[True][0][i], got[True][1][i]
        assert port_plane.dtype == np.float32 and port_coords.dtype == np.float32
        for port, jax_g, ref in ((port_plane, j_plane, full_plane64),
                                 (port_coords, j_coords, c64)):
            assert _rel_err(port, ref) <= _rel_err(jax_g, ref)
            assert _rel_err(port, ref) <= 1e-5
            assert _rel_err(port, jax_g) <= GRAD_TOL
        if case == "outside":
            far = (np.abs(c) > 1 + 2.0 / (min(plane.shape[:2]) - 1)).any(-1)
            assert far.any() and not port_coords[far].any()


_ALIGNED = 1 << 20


@pytest.mark.parametrize(
    "C,offset,texel_stride,g_stride,g_ptr,lanes",
    [
        (72, 24, 96, 216, _ALIGNED + 2 * 72, 4),  # appearance of plane 1 of (N, 3, 72)
        (24, 0, 96, 72, _ALIGNED + 2 * 48, 4),  # density of plane 2 of (N, 3, 24)
        (72, 24, 96, 104, _ALIGNED + 8, 4),  # strided g, 8 bytes in
        (72, 24, 96, 104, _ALIGNED + 2, 1),  # strided g, 2 bytes in
        (72, 24, 96, 102, _ALIGNED, 1),  # row stride not a multiple of 4
        (18, 0, 96, 20, _ALIGNED, 1),  # C not a multiple of 4
        (72, 24, 96, 216, _ALIGNED + 4, 1),  # base pointer 4 bytes in
        (16, 2, 96, 16, _ALIGNED, 1),  # channel offset not a multiple of 4 floats
    ],
)
def test_backward_lanes_bf16(C, offset, texel_stride, g_stride, g_ptr, lanes):
    """K2 on a bfloat16 cotangent: 4 channels an 8-byte load, its alignment
    reckoned in 2-byte elements, and float4 atomics into the float32
    gradient at the fetch's channel offset; scalar lanes where a load is not
    8-byte aligned or an atomic not 16-byte aligned."""
    dst = _ALIGNED + 4 * offset
    assert cuda_kernels.backward_lanes(C, offset, texel_stride, g_stride, g_ptr, dst,
                                       BF16) == lanes


@pytest.mark.parametrize("bias", [True, False])
def test_apply_linear_bf16_matches_jax_layer(bias):
    """Forward and ``jax.vjp`` of a bfloat16 layer: the port's float32
    product, bias and one rounding against the JAX layer's, to one bfloat16
    unit in the last place; the cotangent's products and the bias's sum
    likewise, in bfloat16 as JAX returns them."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(96, 72)).astype(np.float32)
    w = _bf16(rng.normal(size=(72, 40)) / 8)
    b = _bf16(rng.normal(size=(40,)))
    gy = _bf16(rng.normal(size=(96, 40)))
    jp = {"w": jnp.asarray(w, jnp.bfloat16)}
    tp = {"w": torch.from_numpy(w).to(BF16).requires_grad_(True)}
    if bias:
        jp["b"] = jnp.asarray(b, jnp.bfloat16)
        tp["b"] = torch.from_numpy(b).to(BF16).requires_grad_(True)
    j_y, vjp = jax.vjp(jd.apply_linear, jp, jnp.asarray(x))
    j_dp, j_dx = vjp(jnp.asarray(gy, jnp.bfloat16))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = td.apply_linear(tp, xt)
    assert y.dtype == BF16 and j_y.dtype == jnp.bfloat16
    y.backward(torch.from_numpy(gy).to(BF16))
    pairs = [(y, j_y), (xt.grad, j_dx), (tp["w"].grad, j_dp["w"])]
    if bias:
        pairs.append((tp["b"].grad, j_dp["b"]))
    for got, want in pairs:
        got = got.detach().float().numpy()
        want = np.asarray(want, np.float32)
        assert np.all(np.abs(got - want) <= ULP * np.abs(want) + 1e-30)
    # Exactly equal for the most part: only float32 sums on a rounding
    # boundary differ.
    assert np.mean(y.detach().float().numpy() == np.asarray(j_y, np.float32)) > 0.95


@pytest.mark.parametrize("name", ["infoinv", "gauge"])
def test_fused_fetch_bf16_plane_gradients_match_jax_vjp(name):
    """Plane gradients of the bfloat16 fused pair (the float32 planes cast
    inside the fetch, the plain K2 or, for the gauge's deformed coordinates,
    K2c) against ``jax.vjp`` of `ngf_tpu`'s bfloat16 pair, for the same
    cotangents: float32, to 2^-5 of the largest."""
    jcfg, params, tcfg, tparams, xyz, _ = _setup(name, seed=6, compute_dtype="bfloat16")
    rng = np.random.default_rng(7)
    g_sigma = rng.normal(size=xyz.shape[:-1]).astype(np.float32)
    g_feat = _bf16(rng.normal(size=(*xyz.shape[:-1], 3 * jcfg.rgb_dim)))

    def jax_fn(planes):
        p = {**params, **dict(zip(PLANES, planes))}
        return jt.triplane_density_and_rgbfeat(p, jcfg, *_jax_proj(p, jcfg, xyz))

    (_, j_feat), vjp = jax.vjp(jax_fn, [jnp.asarray(params[n]) for n in PLANES])
    want = vjp((jnp.asarray(g_sigma), jnp.asarray(g_feat, j_feat.dtype)))[0]

    for n in PLANES:
        tparams[n].requires_grad_(True)
    sigma, feat = tt.triplane_density_and_rgbfeat(tparams, tcfg, *_torch_proj(tparams, tcfg, xyz))
    assert feat.dtype == (torch.float32 if jcfg.infoinv else BF16)
    torch.autograd.backward([sigma, feat], [torch.from_numpy(g_sigma),
                                            torch.from_numpy(g_feat).to(feat.dtype)])
    scale = max(float(np.abs(w).max()) for w in want)
    assert scale > 0.1
    for n, w in zip(PLANES, want):
        assert tparams[n].grad.dtype == torch.float32
        np.testing.assert_allclose(tparams[n].grad.numpy(), np.asarray(w, np.float32),
                                   atol=GRAD_TOL * scale, rtol=0, err_msg=n)


DATADIR = "synthetic:views=2,wh=16,test_views=1"
N_ITERS, EVENTS = 6, (2, 4)
ARGV = [
    "--config", os.path.join(REPO, "configs", "synthetic_infoinv_tpu30k.txt"), "--datadir",
    DATADIR, "--plane_res", "32", "--nSamples", "96", "--batch_size", "64",
    "--open_sample_cap", "32", "--masked_sample_cap", "16", "--alpha_grid_res", "12",
    "--n_iters", str(N_ITERS), "--update_AlphaMask_list", "2", "--update_AlphaMask_list", "4",
    "--prewarm_events", "0", "--eval_chunk", "64",
]


def test_staged_bf16_run_with_a_later_event_matches_jax_trainer(monkeypatch):
    """Six bfloat16 steps of the 30k schedule's staged trainer, cut small,
    with a first mask event and a later one, against the JAX trainer on
    identical weights, batches and jitter: the occupancy grid equal voxel
    for voxel at both events (no voxel of this seed's grid lies near the
    threshold in either dtype's rounding), and with it the box, the kept
    rays, the sampler's ids and the measured capacity exact; the losses to
    rtol 2e-2 (bfloat16 decoders, float32 sums in both)."""
    jargs = j_config_parser(ARGV)
    targs = t_config_parser(ARGV + ["--device", "cpu"])
    assert targs.compute_dtype == jargs.compute_dtype == "bfloat16"
    events = [e for e in targs.update_AlphaMask_list if e <= N_ITERS]
    assert events == list(EVENTS) and targs.masked_sample_cap == 16
    jds = j_registry.load_dataset("synthetic", DATADIR, split="train", is_stack=False)
    tds = load_dataset("synthetic", DATADIR, split="train", is_stack=False)

    cfg = jt.TriPlaneConfig(**dataclasses.asdict(model_config_from_args(targs)))
    params = jax.device_get(jt.init_triplane(jax.random.PRNGKey(3), cfg))
    for name in PLANES:
        params[name] = params[name] * np.float32(300.0)
    params["density_decoder"]["mlp"]["layers"][-1]["b"] = np.full((1,), 0.0, np.float32)

    ours = TriPlaneTrainer(targs, tds, init_params=convert.params_from_numpy(params, "cpu"),
                           device="cpu")
    with jax.disable_jit():
        theirs = JTrainer(jargs, jds, init_params=jax.tree.map(jnp.asarray, params))
    gen = torch.Generator()
    losses_j, losses_t, records = [], [], []
    for _ in range(N_ITERS):
        jitter = _step_jitter(theirs)
        monkeypatch.setattr(tv, "_ray_jitter", lambda g, n, device: torch.from_numpy(jitter))
        losses_j.append(float(theirs.train_block(1)[0]))
        losses_t.append(float(ours.train_step(*ours.next_batch(), gen)))
        if ours.iteration in EVENTS:
            first = ours.iteration == EVENTS[0]
            with jax.disable_jit():
                theirs._event_update_alpha_mask(first=first)
            rec = ours._event_update_alpha_mask(first=first)
            records.append(rec)
            vol_t, vol_j = ours.alpha.volume.numpy(), np.asarray(theirs.alpha.volume)
            differ = int((vol_t != vol_j).sum())
            assert differ == 0, f"{differ} of {vol_j.size} voxels differ"
            assert 0 < rec["voxels"] < vol_j.size
            np.testing.assert_array_equal(ours.alpha.aabb.numpy(), np.asarray(theirs.alpha.aabb))
            np.testing.assert_array_equal(ours.all_rays.numpy(), theirs.all_rays)
            assert ours._auto_cap == theirs._auto_cap
            assert rec["sample_cap"] == 16 and rec["capg"] == 2
            assert ours._effective_sample_cap() == theirs._effective_sample_cap() == 16
            assert ours.l1_weight == theirs.l1_weight == targs.L1_weight_rest
            assert rec["first"] == first and rec["refiltered"] == first
            if first:
                np.testing.assert_array_equal(ours.sampler.nextids().numpy(),
                                              theirs.sampler.nextids())
                ours.sampler._curr -= ours.sampler.batch
                theirs.sampler._curr -= theirs.sampler.batch
    assert [r["iteration"] for r in records] == list(EVENTS)
    assert records[1]["rays_kept"] == records[0]["rays_kept"]
    np.testing.assert_allclose(losses_t, losses_j, rtol=2e-2, atol=2e-4)
    assert all(np.isfinite(losses_t))
    for name, leaf in convert.named_leaves(ours.params):
        assert leaf.dtype == torch.float32, name


@pytest.mark.parametrize("config,extra,events", [
    ("synthetic_infoinv_tpu30k.txt",
     ["--alpha_grid_res", "16", "--nSamples", "48", "--open_sample_cap", "32",
      "--masked_sample_cap", "16", "--n_iters", "8", "--update_AlphaMask_list", "2",
      "--update_AlphaMask_list", "4", "--update_AlphaMask_list", "6", "--density_shift", "0"],
     [("mask", 2), ("mask", 4), ("mask", 6)]),
    ("synthetic_triplane_tpu_bf16.txt",
     ["--gauge_res", "16", "--alpha_grid_res", "16", "--nSamples", "48",
      "--open_sample_cap", "32", "--n_iters", "12", "--gauge_start", "3",
      "--update_AlphaMask_list", "6", "--upsamp_list", "8", "--N_voxel_init", "4096",
      "--density_shift", "0"],
     [("mask", 6), ("upsample", 8)]),
], ids=["infoinv_30k", "gauge_bf16"])
def test_cli_bf16_configs_train_and_jax_reads(tmp_path, config, extra, events):
    """Both bfloat16 configs through `main_torch.py` at a tiny size: their
    events run, losses stay finite, and ``model.npz`` holds float32
    parameters (with the mask and, for the gauge, planes of the upsampled
    shapes) that `ngf_tpu`'s ``load_checkpoint`` reads back."""
    import main_torch

    argv = ["--config", os.path.join(REPO, "configs", config), "--device", "cpu",
            "--plane_res", "32", "--batch_size", "256",
            "--datadir", "synthetic:views=2,wh=16,test_views=1", "--render_test", "1",
            "--basedir", str(tmp_path), "--expname", "run", *extra]
    out = main_torch.main(argv)
    assert [(e["kind"], e["iteration"]) for e in out["events"]] == events
    assert np.isfinite(out["train_mses"]).all() and len(out["test_psnrs"]) == 1
    ckpt = tmp_path / "run" / "model.npz"
    params, meta, alpha = j_load_checkpoint(str(ckpt))[:3]
    assert meta["model_cfg"]["compute_dtype"] == "bfloat16" and alpha is not None
    for name in PLANES:
        assert np.asarray(params[name]).dtype == np.float32
    if events[-1][0] == "upsample":
        rx, ry, rz = out["events"][-1]["grid_size"]
        assert [list(np.asarray(params[n]).shape) for n in PLANES] == [
            [ry, rx, 64], [rz, ry, 64], [rz, rx, 64]]


def test_float32_accumulation_is_scoped():
    """The switches are off inside and back to their earlier values after:
    as a context, nested, and as a decorator (the trainer's steps, its run
    and its evaluation renderer)."""
    from ngf_tpu_torch.utils.precision import float32_accumulation

    matmul = torch.backends.cuda.matmul

    def flags():
        return (matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                matmul.allow_bf16_reduced_precision_reduction)

    before = flags()
    try:
        for outside in ((True, True, True), (False, True, False)):
            matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = outside[:2]
            matmul.allow_bf16_reduced_precision_reduction = outside[2]
            with float32_accumulation():
                assert flags() == (False, False, False)
                with float32_accumulation():
                    assert flags() == (False, False, False)
                assert flags() == (False, False, False)
            assert flags() == outside
            assert float32_accumulation()(flags)() == (False, False, False)
            assert flags() == outside
    finally:
        matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before[:2]
        matmul.allow_bf16_reduced_precision_reduction = before[2]
