"""The UV-Mapping (NeuTex) components of the port against `ngf_tpu`, on the
same numpy inputs: the DTU datasets (synthetic and on disk), the cube ray
generation with injected jitter, K5's plain version and its
``autograd.Function`` (the CPU path) against ``ray_march``,
``alpha_ray_march`` and ``jax.vjp``, the border sampler, the cubemap
functions, the NeuTex parameters, one full-width ``neutex_forward``, the
losses, the texture exports, the mesh export and the five edit modes.

Tolerances: datasets and mesh indices exactly; K5 forward 1e-6 of the
largest value and its gradients 1e-5 of the largest (float32 sums in
another order); the border sampler 1e-6; the full-width forward atol 1e-5
(products of 256-wide float32 layers summed in another order).
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
import torch  # noqa: E402

from ngf_tpu.data import dtu as jdtu  # noqa: E402
from ngf_tpu.fields import neutex as jn  # noqa: E402
from ngf_tpu.ops import compositing as jcomp  # noqa: E402
from ngf_tpu.ops import grid_sample as jgs  # noqa: E402
from ngf_tpu.ops import rays as jrays  # noqa: E402
from ngf_tpu.utils import cubemap as jcube  # noqa: E402
from ngf_tpu_torch.convert import named_leaves, params_from_numpy  # noqa: E402
from ngf_tpu_torch.data import dtu as tdtu  # noqa: E402
from ngf_tpu_torch.fields import neutex as tn  # noqa: E402
from ngf_tpu_torch.ops import compositing as tcomp  # noqa: E402
from ngf_tpu_torch.ops import grid_sample as tgs  # noqa: E402
from ngf_tpu_torch.ops import rays as trays  # noqa: E402
from ngf_tpu_torch.utils import cubemap as tcube  # noqa: E402


def _t(x):
    return torch.as_tensor(np.array(x))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _tcfg(jcfg):
    return tn.NeuTexConfig(**dataclasses.asdict(jcfg))


# ----------------------------------------------------------------- datasets


@pytest.mark.parametrize("mode", ["no_crop", "random", "balanced", "patch"])
def test_synthetic_dataset_batches_equal_jax(mode):
    kw = dict(n_views=4, wh=(16, 12), random_sample=mode, random_sample_size=4, seed=3)
    jd, td = jdtu.SyntheticDtuDataset(**kw), tdtu.SyntheticDtuDataset(**kw)
    for name in ("campos", "focal", "princpt", "extrinsics", "gt_image", "gt_mask"):
        np.testing.assert_array_equal(getattr(td, name), getattr(jd, name))
    for _ in range(3):
        a, b = jd.sample(), td.sample()
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    test_j = jdtu.SyntheticDtuDataset(n_views=8, use_test_data=True, seed=3)
    test_t = tdtu.SyntheticDtuDataset(n_views=8, use_test_data=True, seed=3)
    assert test_t.indexes == test_j.indexes
    np.testing.assert_array_equal(test_t.campos, test_j.campos)


def test_dtu_dataset_on_disk_equal_jax(tmp_path, monkeypatch):
    """`DtuDataset` reads a `write_dtu_scene` fixture as the JAX one does:
    the views held out by test_views.txt and exclude.txt, the hdf5 images
    and masks, the balanced batches."""
    src = jdtu.SyntheticDtuDataset(n_views=6, wh=(16, 16), seed=1)
    scene = jdtu.write_dtu_scene(str(tmp_path / "scan"), src, test_views="1,4",
                                 exclude_views="2")
    for use_test in (False, True):
        kw = dict(random_sample="balanced", random_sample_size=4, use_test_data=use_test, seed=5)
        jd, td = jdtu.DtuDataset(scene, **kw), tdtu.DtuDataset(scene, **kw)
        assert td.indexes == jd.indexes == ([1, 4] if use_test else [0, 3, 5])
        np.testing.assert_array_equal(td.gt_image, jd.gt_image)
        np.testing.assert_array_equal(td.gt_mask, jd.gt_mask)
        for _ in range(2):
            a, b = jd.sample(), td.sample()
            for k in a:
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="synthetic_dtu"):
        tdtu.DtuDataset(scene)


# --------------------------------------------------------------------- rays


@pytest.mark.parametrize("jitter", [0.0, 0.05])
def test_cube_ray_generation_with_injected_jitter(jitter):
    rng = np.random.default_rng(0)
    campos = np.array([[0.3, 0.2, -2.5], [2.4, 0.9, 0.1]], np.float32)
    d = rng.normal(size=(2, 7, 3)).astype(np.float32) * 0.3
    d[0] += [0, 0, 1]
    d[1] += [-1, -0.3, 0]
    d[1, 0] = [-0.2, 3.0, 0.0]  # misses the cube
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    key = jax.random.PRNGKey(4)
    want = jrays.cube_ray_generation(key, jnp.asarray(campos), jnp.asarray(d), 12, 1.0, jitter)
    u = np.asarray(jax.random.uniform(key, (2, 7, 12), dtype=jnp.float32))
    got = trays.cube_ray_generation(_t(campos), _t(d), 12, 1.0, jitter, _t(u) if jitter else None)
    for a, b, name in zip(got, want, ("raypos", "segment_length", "valid", "mid_ts")):
        if name == "valid":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6, err_msg=name)
    assert not np.asarray(want[2])[1, 0].any() and np.asarray(want[2]).any()


# ----------------------------------------------------------------------- K5


def _march_case(case, B=2, R=6, S=16, seed=0):
    rng = np.random.default_rng(seed)
    dens = rng.uniform(0.0, 4.0, (B, R, S)).astype(np.float32)
    dist = rng.uniform(0.05, 0.2, (B, R, S)).astype(np.float32)
    valid = rng.uniform(size=(B, R, S)) > 0.25
    rgb = rng.uniform(0.0, 1.0, (B, R, S, 3)).astype(np.float32)
    bg = rng.uniform(0.0, 1.0, (B, 3)).astype(np.float32)
    if case == "alpha_one":
        dens[0, :3, 5] = 1e4  # sigma dist ~ 1e3: alpha rounds to 1, f = 1e-10
        dens[1, 2, :] = 300.0
        valid[0, :3, 5] = True
    if case == "clip":
        rgb = rgb * 4.0  # most colours tone-map above 1 and clip
        bg = bg * 3.0
    return dens, dist, valid, rgb, bg


def _jax_march(dist, valid, bg, with_color=True):
    def f(d, c):
        feats = jnp.concatenate([d[..., None], c], -1)
        if not with_color:
            _, _, w, t = jcomp.alpha_ray_march(jnp.asarray(dist), jnp.asarray(valid), feats)
            return w, t
        col, _, _, w, t = jcomp.ray_march(jnp.asarray(dist), jnp.asarray(valid), feats)
        col = col + jnp.asarray(bg)[:, None, :] * t[:, :, None]
        return jcomp.simple_tone_map(col), w, t
    return f


@pytest.mark.parametrize("case", ["invalid", "alpha_one", "clip"])
def test_ray_march_plain_matches_jax(case):
    """K5's plain forward against JAX's ``ray_march`` with the background
    and ``simple_tone_map``, and without colour against
    ``alpha_ray_march``; the tone map over [0, 3] on rays of no density
    (colour = background)."""
    dens, dist, valid, rgb, bg = _march_case(case)
    flat = lambda a: _t(a).reshape(12, *a.shape[2:])  # noqa: E731
    want = _jax_march(dist, valid, bg)(jnp.asarray(dens), jnp.asarray(rgb))
    got = tcomp.ray_march_plain(flat(dens), flat(valid), flat(dist), flat(rgb), _t(bg))
    for a, b in zip(got, want):
        assert _rel(a.numpy(), np.asarray(b).reshape(a.shape)) <= 1e-6
    want_a = _jax_march(dist, valid, None, with_color=False)(
        jnp.asarray(dens), jnp.zeros(dens.shape + (0,), jnp.float32))
    got_a = tcomp.ray_march_plain(flat(dens), flat(valid), flat(dist))
    assert got_a[0] is None
    for a, b in zip(got_a[1:], want_a):
        assert _rel(a.numpy(), np.asarray(b).reshape(a.shape)) <= 1e-6
    x = np.linspace(0.0, 3.0, 303).astype(np.float32).reshape(101, 3)
    col, _, t = tcomp.ray_march_plain(torch.zeros(101, 4), torch.ones(101, 4, dtype=torch.bool),
                                      torch.full((101, 4), 0.1), torch.zeros(101, 4, 3), _t(x))
    assert (t == 1.0).all()
    assert _rel(col.numpy(), jcomp.simple_tone_map(jnp.asarray(x))) <= 1e-6


@pytest.mark.parametrize("cotangent", ["all", "colour", "weights", "transmittance"])
@pytest.mark.parametrize("case", ["invalid", "alpha_one", "clip"])
def test_march_rays_function_matches_jax_vjp(case, cotangent):
    """``march_rays`` on CPU tensors (the plain forward, then the reverse
    scan of ``ray_march_backward_plain``) against ``jax.vjp`` of the NeuTex
    composite, each cotangent alone and all three."""
    dens, dist, valid, rgb, bg = _march_case(case, seed=1)
    rng = np.random.default_rng(2)
    cots = [rng.normal(size=s).astype(np.float32) for s in ((2, 6, 3), (2, 6, 16), (2, 6))]
    keep = {"all": (0, 1, 2), "colour": (0,), "weights": (1,), "transmittance": (2,)}[cotangent]
    cots = [c if i in keep else np.zeros_like(c) for i, c in enumerate(cots)]
    out, vjp = jax.vjp(_jax_march(dist, valid, bg), jnp.asarray(dens), jnp.asarray(rgb))
    want_d, want_c = vjp(tuple(jnp.asarray(c) for c in cots))
    d, c = _t(dens).requires_grad_(True), _t(rgb).requires_grad_(True)
    got = tcomp.march_rays(d, _t(valid), _t(dist), c, _t(bg))
    for a, b in zip(got, out):
        assert _rel(a.detach().numpy(), b) <= 1e-6
    torch.autograd.backward([g for g, i in zip(got, range(3)) if i in keep],
                            [_t(cots[i]) for i in keep])
    assert np.isfinite(d.grad.numpy()).all()
    assert _rel(d.grad.numpy(), want_d) <= 1e-5
    if 0 in keep:
        assert _rel(c.grad.numpy(), want_c) <= 1e-5
    if case == "clip" and 0 in keep:
        # the clipped colours pass no gradient to their samples
        assert (np.asarray(out[0]) >= 1.0).any()


def test_march_rays_without_colour_matches_alpha_ray_march_vjp():
    dens, dist, valid, _, _ = _march_case("alpha_one", seed=3)
    rng = np.random.default_rng(4)
    gw, gt = rng.normal(size=(2, 6, 16)).astype(np.float32), rng.normal(size=(2, 6)).astype(np.float32)
    out, vjp = jax.vjp(lambda x: _jax_march(dist, valid, None, with_color=False)(
        x, jnp.zeros(x.shape + (0,), x.dtype)), jnp.asarray(dens))
    (want_d,) = vjp((jnp.asarray(gw), jnp.asarray(gt)))
    d = _t(dens).requires_grad_(True)
    color, w, t = tcomp.march_rays(d, _t(valid), _t(dist))
    assert color is None
    assert _rel(w.detach().numpy(), out[0]) <= 1e-6 and _rel(t.detach().numpy(), out[1]) <= 1e-6
    torch.autograd.backward([w, t], [_t(gw), _t(gt)])
    assert _rel(d.grad.numpy(), want_d) <= 1e-5


# ------------------------------------------------------------ grid / cubemap


def test_grid_sample_2d_border_matches_jax():
    rng = np.random.default_rng(0)
    plane = rng.uniform(size=(7, 9, 4)).astype(np.float32)  # a texture's values
    coords = rng.uniform(-1.4, 1.4, (3, 50, 2)).astype(np.float32)
    coords[0, :4] = [[-1, -1], [1, 1], [-1, 1], [1.0, -1.0]]
    want = jgs.grid_sample_2d_border(jnp.asarray(plane), jnp.asarray(coords))
    got = tgs.grid_sample_2d_border(_t(plane), _t(coords))
    assert got.shape == (3, 50, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_cubemap_functions_match_jax(tmp_path):
    from PIL import Image

    np.testing.assert_array_equal(tcube.generate_grid(2, 5), jcube.generate_grid(2, 5))
    grid = jcube.generate_grid(2, 6).astype(np.float32)
    for face in range(6):
        np.testing.assert_allclose(tcube.convert_cube_uv_to_xyz(face, _t(grid)).numpy(),
                                   np.asarray(jcube.convert_cube_uv_to_xyz(face, jnp.asarray(grid))),
                                   rtol=0, atol=1e-7)
    rng = np.random.default_rng(1)
    cube = rng.uniform(size=(6, 8, 8, 3)).astype(np.float32)
    xyz = rng.normal(size=(200, 3)).astype(np.float32)
    xyz[:3] = [[1, 1, 0.5], [0, -1, -1], [0.3, 0.3, 0.3]]  # axis ties
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    np.testing.assert_allclose(tcube.sample_cubemap(_t(cube), _t(xyz)).numpy(),
                               np.asarray(jcube.sample_cubemap(jnp.asarray(cube), jnp.asarray(xyz))),
                               rtol=0, atol=1e-6)
    uv = rng.uniform(-1.2, 1.2, (40, 2)).astype(np.float32)
    np.testing.assert_allclose(tcube.sample_square(_t(cube[0]), _t(uv)).numpy(),
                               np.asarray(jcube.sample_square(jnp.asarray(cube[0]), jnp.asarray(uv))),
                               rtol=0, atol=1e-6)
    for flip in (True, False):
        for rotate in (True, False):
            np.testing.assert_array_equal(tcube.merge_cube_to_single_texture(cube, flip, rotate),
                                          jcube.merge_cube_to_single_texture(cube, flip, rotate))
    img = (rng.uniform(size=(96, 128, 3)) * 255).astype(np.uint8)
    path = str(tmp_path / "tex.png")
    Image.fromarray(img).save(path)
    np.testing.assert_array_equal(tcube.load_square(path), jcube.load_square(path))
    for rotate in (True, False):
        np.testing.assert_array_equal(tcube.load_cube_from_single_texture(path, rotate),
                                      jcube.load_cube_from_single_texture(path, rotate))
    for sub in (0, 2):
        for a, b in zip(tcube.icosphere_mesh(sub), jcube.icosphere_mesh(sub)):
            np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------------- model


def _small_cfg(primitive, **kw):
    return jn.NeuTexConfig(primitive_type=primitive, sample_num=8, points_per_primitive=16,
                           geo_hidden=32, geo_layers=2, tex_width=32, tex_layers1=2,
                           tex_layers2=1, gauge_hidden=32, inverse_hidden=32, **kw)


@pytest.mark.parametrize("primitive", ["square", "sphere"])
def test_params_names_and_shapes_equal_init_neutex(primitive):
    jcfg = jn.NeuTexConfig(primitive_type=primitive)
    want = {k: np.shape(v) for k, v in named_leaves(jax.device_get(
        jn.init_neutex(jax.random.PRNGKey(0), jcfg)))}
    params = tn.init_neutex(_tcfg(jcfg), torch.Generator().manual_seed(0))
    got = {k: tuple(v.shape) for k, v in named_leaves(params)}
    assert got == want
    assert all(v.dtype == torch.float32 for _, v in named_leaves(params))
    # zero biases, xavier bounds with the ReLU gain on the geometry MLP
    w0 = params["net_geometry_decoder"]["layers"][0]["w"]
    bound = np.sqrt(2.0) * np.sqrt(6.0 / sum(w0.shape))
    assert 0.9 * bound < w0.abs().max().item() <= bound
    assert all(v.abs().max().item() == 0 for k, v in named_leaves(params) if k.endswith("/b"))


def _rays(n=8, seed=2):
    rng = np.random.default_rng(seed)
    campos = np.array([[0.4, 0.3, -2.5]], np.float32)
    d = rng.normal(size=(1, n, 3)).astype(np.float32) * 0.2 + np.array([0, 0, 1], np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return campos, d


@pytest.mark.parametrize("jittered", [False, True], ids=["render", "train"])
@pytest.mark.parametrize("primitive", ["square", "sphere"])
def test_full_width_forward_matches_jax(primitive, jittered):
    """`neutex_forward` at the `NeuTexConfig` defaults (8 rays x 64 samples,
    2500 template points), JAX weights carried across, the JAX draws
    injected. Unjittered (the render path) every output to atol 1e-5.

    Jittered, the sample positions come from a cumsum of the jittered
    segments, which XLA sums as an associative scan and torch in order:
    they differ by a float32 rounding (<= 5e-7, asserted to 1e-6), and PE(10)
    multiplies that by up to 2^9 before the gauge and texture MLPs, so uv
    and colour differ by up to ~2.4e-4 (each package's float32 forward is as
    far from a float64 one: 1.4e-4 on the sphere's uv, JAX's included).
    There uv and colour are held to 2.5e-4; every other output to 1e-5."""
    jcfg = jn.NeuTexConfig(primitive_type=primitive)
    params = jax.device_get(jn.init_neutex(jax.random.PRNGKey(7), jcfg))
    params["net_geometry_decoder"]["layers"][-1]["b"] = params["net_geometry_decoder"]["layers"][-1]["b"] + 1.0
    campos, d = _rays()
    bg = np.array([[0.2, 0.5, 0.8]], np.float32)
    key = jax.random.PRNGKey(3)
    want = jn.neutex_forward(params, jcfg, key, jnp.asarray(campos), jnp.asarray(d), jnp.asarray(bg),
                             jitter=None if jittered else 0.0)
    k_ray, k_tmpl = jax.random.split(key)
    u = _t(jax.random.uniform(k_ray, (1, 8, 64), dtype=jnp.float32)) if jittered else None
    tmpl = np.asarray(jn.template_random_points(k_tmpl, jcfg, 2500))
    got = tn.neutex_forward(params_from_numpy(params, "cpu"), _tcfg(jcfg), _t(campos), _t(d),
                            _t(bg), u=u, template=_t(tmpl))
    assert sorted(got) == sorted(want)
    for k in want:
        atol = 2.5e-4 if jittered and k in ("color", "uv") else 1e-5
        if k == "points_original":
            atol = 1e-6
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=0,
                                   atol=atol, err_msg=k)
    assert 0.05 < float(np.mean(np.asarray(want["transmittance"]))) < 0.95


@pytest.mark.parametrize("primitive", ["square", "sphere"])
def test_losses_exports_and_mesh_match_jax(primitive):
    jcfg = _small_cfg(primitive)
    tcfg = _tcfg(jcfg)
    params = jax.device_get(jn.init_neutex(jax.random.PRNGKey(2), jcfg))
    tparams = params_from_numpy(params, "cpu")
    campos, d = _rays(6)
    key = jax.random.PRNGKey(5)
    out = jn.neutex_forward(params, jcfg, key, jnp.asarray(campos), jnp.asarray(d))
    k_ray, k_tmpl = jax.random.split(key)
    tout = tn.neutex_forward(tparams, tcfg, _t(campos), _t(d),
                             u=_t(jax.random.uniform(k_ray, (1, 6, 8), dtype=jnp.float32)),
                             template=_t(jn.template_random_points(k_tmpl, jcfg, 16)))
    rng = np.random.default_rng(0)
    gt = rng.uniform(size=(1, 6, 3)).astype(np.float32)
    trans = (rng.uniform(size=(1, 6)) > 0.5).astype(np.float32)
    weights = {"color": 1.0, "bg": 0.5, "origin": 2.0, "inverse_mapping": 0.3}
    for tt in (trans, None):
        _, want = jn.neutex_losses(out, jnp.asarray(gt), None if tt is None else jnp.asarray(tt), weights)
        _, got = tn.neutex_losses(tout, _t(gt), None if tt is None else _t(tt), weights)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, atol=1e-7, err_msg=k)

    np.testing.assert_allclose(tn.export_texture(tparams, tcfg, 6).numpy(),
                               np.asarray(jn.export_texture(params, jcfg, 6)), rtol=0, atol=1e-5)
    if primitive == "sphere":
        np.testing.assert_allclose(tn.export_sphere_equirect(tparams, tcfg, 5).numpy(),
                                   np.asarray(jn.export_sphere_equirect(params, jcfg, 5)),
                                   rtol=0, atol=1e-5)
    got = tn.coordinate_deformation(tparams, tcfg, icosphere_division=1, square_subdiv=2)
    want = jn.coordinate_deformation(params, jcfg, icosphere_division=1, square_subdiv=2)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("primitive", ["square", "sphere"])
def test_edit_modes_match_jax(primitive, mode):
    """The edited-texture colour (`apply_texture_mlp` with a square texture
    or a cubemap, modes 0-4) and the composite it renders. The rendered
    colour to 5e-5: the tone map's slope, 0.45 c^-0.55, is 13 at c = 2e-3
    and 250 at c = 1e-5, and mode 2 divides by the texture, so dark pixels
    magnify the float32 roundings of the sampler and the MLPs."""
    jcfg = _small_cfg(primitive)
    params = jax.device_get(jn.init_neutex(jax.random.PRNGKey(9), jcfg))
    rng = np.random.default_rng(mode)
    shape = (6, 8, 8, 3) if primitive == "sphere" else (10, 12, 3)
    tex = rng.uniform(size=shape).astype(np.float32)
    tex[..., 0] = np.where(rng.uniform(size=shape[:-1]) < 0.3, 1.0, tex[..., 0])
    campos, d = _rays(6, seed=mode)
    want = jn.neutex_forward(params, jcfg, jax.random.PRNGKey(0), jnp.asarray(campos),
                             jnp.asarray(d), edit_texture=jnp.asarray(tex), edit_mode=mode,
                             jitter=0.0)
    got = tn.neutex_forward(params_from_numpy(params, "cpu"), _tcfg(jcfg), _t(campos), _t(d),
                            edit_texture=_t(tex), edit_mode=mode, inverse=False)
    for k, atol in (("color", 5e-5), ("transmittance", 1e-5), ("uv", 1e-5)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=atol, err_msg=k)
    uv = np.asarray(want["uv"]).reshape(-1, jcfg.uv_dim)
    view = np.broadcast_to(np.array([0.0, 0.6, 0.8], np.float32), uv.shape[:-1] + (3,))
    wc = jn.apply_texture_mlp(params["net_texture"], jcfg, jnp.asarray(uv), jnp.asarray(view),
                              edit_texture=jnp.asarray(tex), edit_mode=mode)
    gc = tn.apply_texture_mlp(params_from_numpy(params["net_texture"], "cpu"), _tcfg(jcfg), _t(uv),
                              _t(view), edit_texture=_t(tex), edit_mode=mode)
    np.testing.assert_allclose(gc.detach().numpy(), np.asarray(wc), rtol=1e-5, atol=1e-6)


def test_uv_entry_points_default_to_the_card():
    """`UVTrainer`, `uv_train_torch.py` and `uv_test_torch.py` run on
    'cuda' unless asked for the CPU, and raise where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would run on it")
    import uv_test_torch
    import uv_train_torch
    from ngf_tpu_torch.train.uv_loop import UVTrainer

    with pytest.raises(RuntimeError, match="device cpu"):
        UVTrainer(_tcfg(_small_cfg("square")))
    argv = ["--dataset_name", "synthetic_dtu", "--sample_num", "8", "--primitive_type", "square",
            "--points_per_primitive", "16", "--synthetic_views", "4", "--synthetic_wh", "16"]
    assert uv_train_torch.parse_args(argv).device == "cuda"
    for cli in (uv_train_torch, uv_test_torch):
        with pytest.raises(RuntimeError, match="device cpu"):
            cli.main(argv + ["--checkpoints_dir", "/nonexistent-uv-test-dir"])
