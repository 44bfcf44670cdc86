"""The port's render-only slice against the JAX package on the CPU: dense
``render_rays``, checkpoints read across packages, the render-only CLI
(`main_torch.py` vs `main.py`), evaluation and its metrics, the config
parser, and the rule that the port imports neither JAX nor `ngf_tpu`.

Tolerances: rendered rgb, depth and acc agree to RENDER_TOL = 1e-4 (float32
sums over ~50 samples of fields that agree to ~1e-5; the InfoInv rgb PE at
12 frequencies adds last-ulp sin/cos differences); the CLI's test PSNR to
1e-3 dB; SSIM to 1e-6.
"""

import dataclasses
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ngf_tpu.config import config_parser as j_config_parser  # noqa: E402
from ngf_tpu.fields import triplane as jt  # noqa: E402
from ngf_tpu.render import evaluation as j_eval  # noqa: E402
from ngf_tpu.render import volume as jv  # noqa: E402
from ngf_tpu.utils import checkpoint as j_ckpt  # noqa: E402
from ngf_tpu.utils import metrics as j_metrics  # noqa: E402
from ngf_tpu_torch import convert  # noqa: E402
from ngf_tpu_torch.config import config_parser as t_config_parser  # noqa: E402
from ngf_tpu_torch.data import load_dataset  # noqa: E402
from ngf_tpu_torch.data.geometry import (  # noqa: E402
    get_ray_directions_blender,
    get_rays,
    pose_spherical,
)
from ngf_tpu_torch.fields import triplane as tt  # noqa: E402
from ngf_tpu_torch.render import evaluation as t_eval  # noqa: E402
from ngf_tpu_torch.render import volume as tv  # noqa: E402
from ngf_tpu_torch.utils import checkpoint as t_ckpt  # noqa: E402
from ngf_tpu_torch.utils import metrics as t_metrics  # noqa: E402
from ngf_tpu_torch.utils.device import resolve_device  # noqa: E402
from ngf_tpu_torch.utils.image import jet_colormap, write_png  # noqa: E402

RENDER_TOL = 1e-4
PSNR_TOL = 1e-3
AABB = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))
STEP = 0.1  # 52 samples across the lego box


def _model(seed=0, infoinv=True, bias=5.5):
    cfg = dataclasses.replace(jt.TriPlaneConfig.infoinv_preset(infoinv), plane_res=16)
    params = jax.device_get(jt.init_triplane(jax.random.PRNGKey(seed), cfg))
    # Put density where rays see it: softplus(bias - 10) in the box.
    params["density_decoder"]["mlp"]["layers"][-1]["b"] = np.full((1,), bias, np.float32)
    return cfg, params


def _rays(wh=8, theta=30.0, phi=-25.0):
    focal = 0.5 * wh / np.tan(0.5 * 0.6911112070083618)
    dirs = get_ray_directions_blender(wh, wh, [focal, focal])
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    o, d = get_rays(dirs, pose_spherical(theta, phi, 4.0))
    return np.concatenate([o, d], 1)


def _alpha_volume(seed=0):
    return (np.random.default_rng(seed).uniform(size=(6, 7, 8)) > 0.5).astype(np.float32)


ALPHA_AABB = np.array([[-1.2, -1.3, -1.1], [1.4, 1.2, 1.3]], np.float32)


def _render_both(rcfg_kw, with_alpha, seed=0):
    cfg, params = _model(seed)
    jr = jv.RenderConfig(aabb=AABB, n_samples=52, step_size=STEP, **rcfg_kw)
    tr = tv.RenderConfig(aabb=AABB, n_samples=52, step_size=STEP, **rcfg_kw)
    rays = _rays()
    vol = _alpha_volume(seed) if with_alpha else None
    j_kw = dict(alpha_volume=jnp.asarray(vol), alpha_aabb=jnp.asarray(ALPHA_AABB)) if with_alpha else {}
    t_kw = dict(alpha_volume=torch.from_numpy(vol), alpha_aabb=torch.from_numpy(ALPHA_AABB)) if with_alpha else {}
    want = jv.render_rays(params, cfg, jr, jnp.asarray(rays), None, is_train=False, iteration=3, **j_kw)
    tcfg = tt.TriPlaneConfig(**dataclasses.asdict(cfg))
    got = tv.render_rays(convert.params_from_numpy(params, "cpu"), tcfg, tr,
                         torch.from_numpy(rays), iteration=3, **t_kw)
    return got, want


@pytest.mark.parametrize("with_alpha", [False, True])
@pytest.mark.parametrize("rcfg_kw", [{}, {"sample_cap": 24}], ids=["dense", "sample_cap"])
def test_render_rays_matches_jax(rcfg_kw, with_alpha):
    got, want = _render_both(rcfg_kw, with_alpha)
    acc = got["acc_map"].numpy()
    assert 0.02 < acc.mean() < 0.98, acc.mean()  # the scene is neither empty nor opaque
    for k in ("rgb_map", "depth_map", "acc_map"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RENDER_TOL,
                                   atol=RENDER_TOL, err_msg=k)


def test_grouped_path_not_ported():
    cfg, params = _model()
    tr = tv.RenderConfig(aabb=AABB, n_samples=52, step_size=STEP, group_size=8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tv.render_rays(convert.params_from_numpy(params, "cpu"),
                       tt.TriPlaneConfig(**dataclasses.asdict(cfg)), tr,
                       torch.from_numpy(_rays()))


def _meta(cfg):
    return {"model_cfg": dataclasses.asdict(cfg), "aabb": [list(AABB[0]), list(AABB[1])],
            "step_size": STEP, "near_far": [2.0, 6.0]}


def test_jax_checkpoint_loads_in_port(tmp_path):
    cfg, params = _model(seed=4)
    vol = _alpha_volume(4)
    path = str(tmp_path / "model.npz")
    j_ckpt.save_checkpoint(path, params, _meta(cfg), alpha_volume=vol, alpha_aabb=ALPHA_AABB)
    tparams, meta, tvol, taabb = t_ckpt.load_checkpoint(path, "cpu")
    np.testing.assert_array_equal(tvol.numpy(), vol)
    jparams, _, jvol, jaabb = j_ckpt.load_checkpoint(path)
    rays = _rays(wh=6)
    rkw = dict(aabb=AABB, n_samples=52, step_size=STEP)
    want = jv.render_rays(jparams, cfg, jv.RenderConfig(**rkw), jnp.asarray(rays), None,
                          is_train=False, alpha_volume=jnp.asarray(jvol), alpha_aabb=jnp.asarray(jaabb))
    got = tv.render_rays(tparams, tt.TriPlaneConfig(**meta["model_cfg"]), tv.RenderConfig(**rkw),
                         torch.from_numpy(rays), alpha_volume=tvol, alpha_aabb=taabb)
    for k in ("rgb_map", "depth_map", "acc_map"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RENDER_TOL,
                                   atol=RENDER_TOL, err_msg=k)


def test_port_checkpoint_loads_in_jax(tmp_path):
    cfg, params = _model(seed=5)
    tparams = convert.params_from_numpy(params, "cpu")
    path = str(tmp_path / "model.npz")
    vol = _alpha_volume(5)
    t_ckpt.save_checkpoint(path, tparams, _meta(cfg), alpha_volume=torch.from_numpy(vol),
                           alpha_aabb=torch.from_numpy(ALPHA_AABB))
    jparams, meta, jvol, jaabb = j_ckpt.load_checkpoint(path)
    assert meta["model_cfg"] == dataclasses.asdict(cfg)
    np.testing.assert_array_equal(jvol, vol)
    np.testing.assert_array_equal(jaabb, ALPHA_AABB)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                                jax.tree_util.tree_flatten_with_path(jparams)[0]):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


def test_orbax_directory_refused(tmp_path):
    with pytest.raises(NotImplementedError):
        t_ckpt.load_checkpoint(str(tmp_path), "cpu")


def test_render_only_cli_matches_main(tmp_path):
    """`main_torch.py --device cpu` render-only on an `ngf_tpu` checkpoint
    writes the test PSNR that `main.py` writes, to 1e-3 dB."""
    import main as j_main
    import main_torch

    cfg, params = _model(seed=6)
    ckpt = str(tmp_path / "model.npz")
    j_ckpt.save_checkpoint(ckpt, params, _meta(cfg))
    argv = ["--dataset_name", "synthetic", "--datadir", "synthetic:wh=12,test_views=2",
            "--render_only", "1", "--render_test", "1", "--ckpt", ckpt,
            "--eval_chunk", "50", "--compute_extra_metrics", "0"]
    j_main.main(argv + ["--expname", "jax"])
    psnrs = main_torch.main(argv + ["--expname", "port", "--device", "cpu"])
    want = np.loadtxt(tmp_path / "jax" / "imgs_test_all" / "mean.txt")
    got = np.loadtxt(tmp_path / "port" / "imgs_test_all" / "mean.txt")
    assert got.shape == want.shape == ()
    assert abs(float(got) - float(want)) < PSNR_TOL
    assert abs(float(np.mean(psnrs)) - float(got)) < 1e-9
    for name in ("000.png", "001.png", "rgbd/000.png"):
        assert (tmp_path / "port" / "imgs_test_all" / name).is_file(), name


def test_cli_train_mode_not_ported():
    """Training mode raises, naming ROADMAP.md, for what the dense slice
    does not carry: an occupancy event inside ``n_iters``, ``group_size > 0``
    and the learned-gauge subsystem. Each raises before any data is built."""
    import main_torch

    base = ["--dataset_name", "synthetic", "--datadir", "synthetic:views=1,wh=8",
            "--device", "cpu", "--n_iters", "100", "--group_size", "0"]
    cases = {
        "event inside n_iters": ["--update_AlphaMask_list", "50"],
        "group_size": ["--group_size", "8"],
        "gauge subsystem": ["--subsystem", "triplane"],
    }
    for what, extra in cases.items():
        with pytest.raises(NotImplementedError, match="ROADMAP") as info:
            main_torch.main(base + extra)
        assert "not ported" in str(info.value), what


def test_cuda_requested_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")


def test_unported_dataset_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_dataset("blender", "./data/nerf_synthetic/lego", split="test")


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "*.txt"))),
                         ids=os.path.basename)
def test_config_files_parse_alike(path):
    want = dataclasses.asdict(j_config_parser(["--config", path]))
    got = dataclasses.asdict(t_config_parser(["--config", path]))
    assert got.pop("device") == "cuda"
    assert got == want


def test_evaluation_matches_jax(tmp_path):
    """Same render function through both evaluators: PSNR and SSIM agree,
    mean.txt has the same layout, LPIPS is NaN with its marker file."""
    ds = load_dataset("synthetic", "synthetic:wh=16,test_views=2", split="test", is_stack=True)

    def fake(rays):
        rays = np.asarray(rays)
        rgb = 1.0 / (1.0 + np.exp(-3.0 * rays[:, 3:6]))
        return rgb.astype(np.float32), np.abs(rays[:, 5]).astype(np.float32) * 4.0

    j_psnr = j_eval.evaluation(ds, lambda r: fake(r), str(tmp_path / "jax"), n_vis=-1, chunk=100)
    t_psnr = t_eval.evaluation(ds, lambda r: tuple(map(torch.from_numpy, fake(r))),
                               str(tmp_path / "port"), n_vis=-1, chunk=100)
    np.testing.assert_allclose(t_psnr, j_psnr, atol=1e-9)
    want = np.loadtxt(tmp_path / "jax" / "mean.txt")
    got = np.loadtxt(tmp_path / "port" / "mean.txt")
    assert got.shape == want.shape == (4,)
    np.testing.assert_allclose(got[:2], want[:2], atol=1e-6)
    assert np.isnan(got[2:]).all()
    assert (tmp_path / "port" / "lpips_unavailable.txt").is_file()


def test_ssim_and_psnr_match_jax():
    rng = np.random.default_rng(8)
    a = rng.uniform(size=(24, 20, 3))
    b = np.clip(a + 0.05 * rng.normal(size=a.shape), 0, 1)
    assert abs(t_metrics.rgb_ssim(a, b, 1) - j_metrics.rgb_ssim(a, b, 1)) < 1e-6
    assert t_metrics.mse2psnr(0.01) == j_metrics.mse2psnr(0.01)


def test_png_writer_round_trip(tmp_path):
    imageio = pytest.importorskip("imageio.v2")
    rng = np.random.default_rng(9)
    for shape in ((5, 7, 3), (1, 9, 3)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        write_png(str(tmp_path / "x.png"), img)
        np.testing.assert_array_equal(imageio.imread(str(tmp_path / "x.png")), img)


def test_jet_colormap_matches_opencv():
    cv2 = pytest.importorskip("cv2")
    x = np.arange(256, dtype=np.uint8)[:, None]
    diff = jet_colormap(x).astype(int) - cv2.applyColorMap(x, cv2.COLORMAP_JET).astype(int)
    assert np.abs(diff).max() <= 1


def test_port_imports_neither_jax_nor_ngf_tpu():
    """Import every module of the port, `main_torch` and `chip_smoke` in a
    fresh interpreter: neither `jax` nor any `ngf_tpu.*` module is loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ngf_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(ngf_tpu_torch.__path__, 'ngf_tpu_torch.')]\n"
        "for m in mods + ['main_torch', 'chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ngf_tpu'))\n"
        "assert len(mods) >= 30, mods\n"
        "assert {'ngf_tpu_torch.train.loop', 'ngf_tpu_torch.train.state',\n"
        "        'ngf_tpu_torch.ops.gather', 'ngf_tpu_torch.data.sampler'} <= set(mods), mods\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_render_phase_on_cpu():
    """`chip_smoke.py`'s render phase at a tiny size on the CPU (plain
    sampler): the CLI run, the re-rendered chunk and its checks."""
    import chip_smoke

    out = chip_smoke.render_phase(torch.device("cpu"), wh=16, plane_res=16, chunk=128)
    assert out["chunks"] == 2
    assert np.isfinite(out["psnr"])
    assert all(err == 0.0 for err in out["render_err"].values())
    assert 0.05 < out["mean_acc"] < 0.95
