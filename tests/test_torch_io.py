"""The port's I/O modules against `ngf_tpu`'s on the CPU, on the same numpy
inputs:

- `utils/viz.py`: the PLY (with and without colours and faces), OBJ and PCD
  writers byte for byte, ``depth_to_pointcloud`` exactly, the
  ``Visualizer``'s dumps (the PCD byte for byte, the PNGs pixel for pixel,
  the loss log's averages);
- `utils/pfm.py`: files written by either package read by the other;
- `utils/marching_cubes.py`: ``marching_cubes`` exactly (vertices, faces,
  their order) on a sphere SDF, a random volume, and the empty, full and
  thinner-than-2 volumes; ``convert_density_to_ply`` the same file;
- ``TriPlaneTrainer.export_mesh`` at grid_size 32 against the JAX trainer's
  on the same weights (InfoInv, and the learned-gauge recipe, whose gauge
  the export fetches at iteration -1 and multiplies by 0, as JAX's): the
  alpha grids to 1e-6, then the mesh of one shared grid byte for byte, so
  that a value at the level cannot flip a cube; ``main_torch.py
  --export_mesh 1`` writes ``mesh.ply``;
- `utils/lpips.py`: alex and vgg on random weights that the test writes,
  against ``ngf_tpu.utils.lpips.rgb_lpips`` at rtol 1e-5; the port's
  random weights are `tests/test_lpips.py`'s; NaN and the warning without
  weights; ``evaluation`` with weights fills ``mean.txt`` and writes no
  marker;
- the videos of ``evaluation`` and ``evaluation_path`` (frames counted back
  through ``cv2``), and the skip line without ``cv2`` or with a writer that
  does not open;
- `utils/profiling.py`: ``trace`` writing a Chrome trace that names an
  ``annotate`` region, and ``ngf_spans.json`` beside it (the spans
  themselves: `tests/test_torch_tracing.py`); `utils/__init__.py`
  exporting ``ngf_tpu.utils``'s names but ``StepTimer``.
"""

import dataclasses
import importlib
import json
import os
import sys
import warnings

import numpy as np
import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import ngf_tpu.utils as j_utils  # noqa: E402
from ngf_tpu.config import config_parser as j_config_parser  # noqa: E402
from ngf_tpu.data import registry as j_registry  # noqa: E402
from ngf_tpu.fields import triplane as jt  # noqa: E402
from ngf_tpu.render import evaluation as j_eval  # noqa: E402
from ngf_tpu.train.loop import TriPlaneTrainer as JTrainer  # noqa: E402
from ngf_tpu.utils import lpips as j_lpips  # noqa: E402
from ngf_tpu.utils import pfm as j_pfm  # noqa: E402
from ngf_tpu.utils import viz as j_viz  # noqa: E402
import ngf_tpu_torch.utils as t_utils  # noqa: E402
from ngf_tpu_torch import convert  # noqa: E402
from ngf_tpu_torch.config import config_parser as t_config_parser  # noqa: E402
from ngf_tpu_torch.data import load_dataset  # noqa: E402
from ngf_tpu_torch.render import evaluation as t_eval  # noqa: E402
from ngf_tpu_torch.train import loop as t_loop  # noqa: E402
from ngf_tpu_torch.train.loop import TriPlaneTrainer, model_config_from_args  # noqa: E402
from ngf_tpu_torch.utils import lpips as t_lpips  # noqa: E402
from ngf_tpu_torch.utils import pfm as t_pfm  # noqa: E402
from ngf_tpu_torch.utils import profiling as t_prof  # noqa: E402
from ngf_tpu_torch.utils import viz as t_viz  # noqa: E402

# The modules (the packages export the function under the module's name).
j_mc = importlib.import_module("ngf_tpu.utils.marching_cubes")
t_mc = importlib.import_module("ngf_tpu_torch.utils.marching_cubes")

cv2 = pytest.importorskip("cv2")
imageio = pytest.importorskip("imageio.v2")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# ----------------------------------------------------------------------- viz


@pytest.mark.parametrize("colors", ["none", "float", "uint8"])
@pytest.mark.parametrize("faces", [False, True])
def test_save_ply_byte_equal(tmp_path, colors, faces):
    rng = np.random.default_rng(0)
    v = np.concatenate([rng.normal(0, 1, (40, 3)), rng.normal(0, 1e-6, (5, 3)),
                        [[0.0, -0.0, 1e20]]]).astype(np.float32)
    col = {"none": None, "float": rng.uniform(-0.2, 1.2, (46, 3)),
           "uint8": rng.integers(0, 256, (46, 3), dtype=np.uint8)}[colors]
    f = rng.integers(0, 46, (30, 3)) if faces else None
    j_viz.save_ply(str(tmp_path / "j.ply"), v, f, col)
    t_viz.save_ply(str(tmp_path / "t.ply"), v, f, col)
    assert _bytes(tmp_path / "t.ply") == _bytes(tmp_path / "j.ply")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_save_obj_and_pcd_byte_equal(tmp_path, dtype):
    rng = np.random.default_rng(1)
    v = rng.normal(0, 2, (25, 3)).astype(dtype)
    f = rng.integers(0, 25, (12, 3))
    j_viz.save_obj(str(tmp_path / "j.obj"), v, f)
    t_viz.save_obj(str(tmp_path / "t.obj"), v, f)
    assert _bytes(tmp_path / "t.obj") == _bytes(tmp_path / "j.obj")
    j_viz.save_pointcloud_pcd(v, str(tmp_path / "j.pcd"))
    t_viz.save_pointcloud_pcd(v, str(tmp_path / "t.pcd"))
    assert _bytes(tmp_path / "t.pcd") == _bytes(tmp_path / "j.pcd")


def test_depth_to_pointcloud_and_visualizer(tmp_path, capsys):
    rng = np.random.default_rng(2)
    depth = rng.uniform(0, 3, (6, 5)).astype(np.float32)
    depth[0, :2] = 0.0
    cam = rng.normal(0, 1, 3).astype(np.float32)
    dirs = rng.normal(0, 1, (6, 5, 3)).astype(np.float32)
    for mask in (None, depth.reshape(-1) > 0):
        np.testing.assert_array_equal(t_viz.depth_to_pointcloud(depth, cam, dirs, mask),
                                      j_viz.depth_to_pointcloud(depth, cam, dirs, mask))
    visuals = {"rgb": rng.uniform(0, 1, (6, 5, 3)), "depth": depth,
               "mask8": rng.integers(0, 256, (6, 5, 3), dtype=np.uint8)}
    out = {}
    for tag, mod in (("j", j_viz), ("t", t_viz)):
        vis = mod.Visualizer(str(tmp_path / tag))
        vis.display_current_results(visuals, 7, cam, dirs)
        for losses in ({"color": 0.5, "bg": 0.25}, {"color": 0.25, "bg": 0.75}):
            vis.accumulate_losses(losses)
        out[tag] = vis.print_losses(7)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    pcd = "step-00000007-depth.pcd"
    assert _bytes(tmp_path / "t" / pcd) == _bytes(tmp_path / "j" / pcd)
    for name in ("rgb", "mask8", "depth"):
        got = imageio.imread(str(tmp_path / "t" / f"00000007-{name}.png"))
        want = imageio.imread(str(tmp_path / "j" / f"00000007-{name}.png"))
        if want.ndim == 2:  # the JAX package's grey PNG; the port's three equal channels
            want = np.repeat(want[..., None], 3, axis=-1)
        np.testing.assert_array_equal(got, want)
    tail = lambda s: s.split("[Average Loss] ")[1]  # noqa: E731
    assert tail(out["t"]) == tail(out["j"]) == "color: 0.3750000000   bg: 0.5000000000"


# ----------------------------------------------------------------------- pfm


@pytest.mark.parametrize("shape", [(7, 5), (4, 6, 3)])
def test_pfm_crosses_both_ways(tmp_path, shape):
    data = np.random.default_rng(3).normal(0, 10, shape).astype(np.float32)
    for write, read in ((t_pfm.write_pfm, j_pfm.read_pfm), (j_pfm.write_pfm, t_pfm.read_pfm)):
        path = str(tmp_path / "x.pfm")
        write(path, data, scale=2.5)
        got, scale = read(path)
        np.testing.assert_array_equal(got, data)
        assert scale == 2.5
    t_pfm.write_pfm(str(tmp_path / "t.pfm"), data)
    j_pfm.write_pfm(str(tmp_path / "j.pfm"), data)
    assert _bytes(tmp_path / "t.pfm") == _bytes(tmp_path / "j.pfm")
    with pytest.raises(ValueError, match="PFM data"):
        t_pfm.write_pfm(path, np.zeros((2, 2, 2)))
    with open(path, "wb") as f:
        f.write(b"P6\n1 1\n1\n")
    with pytest.raises(ValueError, match="Not a PFM"):
        t_pfm.read_pfm(path)


# ------------------------------------------------------------ marching cubes


def _volumes():
    rng = np.random.default_rng(4)
    x, y, z = np.meshgrid(*(np.linspace(-1, 1, n) for n in (17, 19, 15)), indexing="ij")
    return {
        "sphere_sdf": (0.6 - np.sqrt(x ** 2 + y ** 2 + z ** 2), 0.0),
        "random": (rng.uniform(0, 1, (9, 8, 7)), 0.5),
        "random_f32_ties": (np.round(rng.uniform(0, 1, (8, 9, 10)), 1).astype(np.float32), 0.5),
        "empty": (np.zeros((6, 6, 6)), 0.5),
        "full": (np.ones((6, 6, 6)), 0.5),
        "thin": (rng.uniform(0, 1, (1, 6, 6)), 0.5),
    }


@pytest.mark.parametrize("case", list(_volumes()))
def test_marching_cubes_exactly_ngf_tpus(case):
    vol, level = _volumes()[case]
    spacing = (0.5, 0.25, 2.0)
    got_v, got_f = t_mc.marching_cubes(vol, level, spacing)
    want_v, want_f = j_mc.marching_cubes(vol, level, spacing)
    assert got_v.dtype == want_v.dtype and got_f.dtype == want_f.dtype
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_f, want_f)
    if case in ("sphere_sdf", "random"):
        assert len(got_f) > 20
    if case in ("empty", "full", "thin"):
        assert got_v.shape == (0, 3) and got_f.shape == (0, 3)


def test_convert_density_to_ply_same_file(tmp_path):
    vol, _ = _volumes()["sphere_sdf"]
    bbox = [[-1.5, -1.0, -0.5], [1.5, 2.0, 0.5]]
    j_mc.convert_density_to_ply(vol, str(tmp_path / "j.ply"), bbox, level=0.1)
    rec = t_mc.convert_density_to_ply(vol, str(tmp_path / "t.ply"), bbox, level=0.1)
    assert _bytes(tmp_path / "t.ply") == _bytes(tmp_path / "j.ply")
    assert rec["faces"] > 0 and rec["vertices"] == 3 * rec["faces"]


# --------------------------------------------------------------- mesh export

DATADIR = "synthetic:views=2,wh=16,test_views=1"
EXPORT_ARGV = {
    "infoinv": ["--config", os.path.join(REPO, "configs", "synthetic_infoinv_tpu.txt"),
                "--plane_res", "32", "--nSamples", "64", "--batch_size", "64",
                "--open_sample_cap", "32", "--alpha_grid_res", "12", "--prewarm_events", "0"],
    "gauge": ["--config", os.path.join(REPO, "configs", "synthetic_triplane_tpu.txt"),
              "--plane_res", "32", "--gauge_res", "16", "--nSamples", "64", "--batch_size", "64",
              "--open_sample_cap", "32", "--alpha_grid_res", "12", "--prewarm_events", "0",
              "--N_voxel_init", "4096"],
}
PLANES = ("plane_xy", "plane_yz", "plane_xz")


def _read_ply(path):
    with open(path) as f:
        lines = f.read().splitlines()
    end = lines.index("end_header")
    nv = int(next(ln for ln in lines if ln.startswith("element vertex")).split()[-1])
    nf = int(next(ln for ln in lines if ln.startswith("element face")).split()[-1])
    verts = np.array([[float(x) for x in ln.split()] for ln in lines[end + 1:end + 1 + nv]])
    faces = np.array([[int(x) for x in ln.split()] for ln in lines[end + 1 + nv:]])
    assert faces.shape[0] == nf
    return verts.reshape(-1, 3), faces.reshape(-1, 4)


@pytest.mark.parametrize("recipe", ["infoinv", "gauge"])
def test_export_mesh_matches_jax_trainer(tmp_path, monkeypatch, recipe):
    argv = EXPORT_ARGV[recipe] + ["--datadir", DATADIR]
    jargs, targs = j_config_parser(argv), t_config_parser(argv + ["--device", "cpu"])
    jds = j_registry.load_dataset("synthetic", DATADIR, split="train", is_stack=False)
    tds = load_dataset("synthetic", DATADIR, split="train", is_stack=False)
    cfg = jt.TriPlaneConfig(**dataclasses.asdict(model_config_from_args(targs)))
    params = jax.device_get(jt.init_triplane(jax.random.PRNGKey(5), cfg))
    # Planes scaled so that part of the grid lies above the level. The gauge
    # recipe's density is one 48-wide product whose float32 rounding order
    # moves alpha by up to 5e-6 at planes x300; at x30 its grid crosses
    # the level too.
    scale = {"infoinv": 300.0, "gauge": 30.0}[recipe]
    for name in PLANES:
        params[name] = params[name] * np.float32(scale)
    dec = params["density_decoder"]
    (dec["mlp"]["layers"][-1] if "mlp" in dec else dec)["b"] = np.full((1,), 0.0, np.float32)
    theirs = JTrainer(jargs, jds, init_params=jax.tree.map(jnp.asarray, params))
    ours = TriPlaneTrainer(targs, tds, init_params=convert.params_from_numpy(params, "cpu"),
                           device="cpu")
    grids = {}
    monkeypatch.setattr(j_mc, "convert_density_to_ply",
                        lambda vol, path, bbox, level: grids.update(j=(vol, bbox, level)))
    theirs.export_mesh(str(tmp_path / "j.ply"), grid_size=32)
    monkeypatch.undo()
    real = t_loop.convert_density_to_ply

    def keep(vol, path, bbox, level):
        grids["t"] = (vol, bbox, level)
        return real(vol, path, bbox, level)

    monkeypatch.setattr(t_loop, "convert_density_to_ply", keep)
    rec = ours.export_mesh(str(tmp_path / "t.ply"), grid_size=32)
    (jv, jb, jl), (tv, tb, tl) = grids["j"], grids["t"]
    assert tv.shape == jv.shape == (32, 32, 32) and tl == jl == 0.005
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6)
    assert 0 < (jv > jl).mean() < 1, "the grid crosses the level"
    # The mesh of one shared grid, byte for byte.
    j_mc.convert_density_to_ply(jv, str(tmp_path / "jj.ply"), jb, level=jl)
    t_mc.convert_density_to_ply(jv, str(tmp_path / "tj.ply"), jb, level=jl)
    assert _bytes(tmp_path / "tj.ply") == _bytes(tmp_path / "jj.ply")
    verts, faces = _read_ply(str(tmp_path / "t.ply"))
    assert rec["faces"] == len(faces) > 0 and rec["vertices"] == len(verts)
    assert set(rec) >= {"grid_s", "marching_cubes_s", "write_s"}
    assert (verts >= ours.aabb[0] - 1e-5).all() and (verts <= ours.aabb[1] + 1e-5).all()


def test_main_cli_export_mesh_writes_mesh_ply(tmp_path, monkeypatch):
    """``--export_mesh 1`` through ``main_torch.main``, the grid cut from 256
    to 32 for the CPU, on initial weights with denser planes (as above) so
    that the mesh is not empty."""
    import main_torch

    export, init = TriPlaneTrainer.export_mesh, t_loop.init_triplane
    monkeypatch.setattr(TriPlaneTrainer, "export_mesh",
                        lambda self, path: export(self, path, grid_size=32))

    def dense_init(cfg, gen, device):
        p = init(cfg, gen, device)
        for name in PLANES:
            p[name] = p[name] * 300.0
        return p

    monkeypatch.setattr(t_loop, "init_triplane", dense_init)
    stats = main_torch.main(EXPORT_ARGV["infoinv"] + [
        "--datadir", DATADIR, "--device", "cpu", "--n_iters", "6", "--render_test", "0",
        "--N_vis", "0", "--export_mesh", "1", "--basedir", str(tmp_path), "--expname", "m",
        "--density_shift", "0"])
    path = tmp_path / "m" / "mesh.ply"
    assert path.is_file() and stats["export"]["vertices"] == 3 * stats["export"]["faces"] > 0
    verts, faces = _read_ply(str(path))
    assert len(verts) == stats["export"]["vertices"] and len(faces) == stats["export"]["faces"]


# --------------------------------------------------------------------- LPIPS


@pytest.fixture
def lpips_dir(tmp_path, monkeypatch):
    """Random alex and vgg weights (the port's generator, which must be
    `tests/test_lpips.py`'s) in a weights directory both packages read."""
    import test_lpips

    for net, make, seed in (("alex", test_lpips._rand_alex_weights, 0),
                            ("vgg", test_lpips._rand_vgg_weights, 1)):
        data = t_lpips.random_weights(net, np.random.default_rng(seed))
        want = make(np.random.default_rng(seed))
        assert list(data) == list(want)
        for k in want:
            np.testing.assert_array_equal(data[k], want[k])
        np.savez(tmp_path / f"lpips_{net}.npz", **data)
    monkeypatch.setenv("NGF_LPIPS_WEIGHTS_DIR", str(tmp_path))
    j_lpips._models.clear()
    yield tmp_path
    j_lpips._models.clear()
    t_lpips._models.clear()


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_matches_ngf_tpu(lpips_dir, net):
    rng = np.random.default_rng(6)
    a = rng.uniform(0, 1, (64, 72, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    assert t_lpips.lpips_available(net)
    got = t_lpips.rgb_lpips(a, b, net, device="cpu")
    want = j_lpips.rgb_lpips(a, b, net)
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert abs(t_lpips.rgb_lpips(a, a.copy(), net, device="cpu")) < 1e-6
    from ngf_tpu_torch.utils import metrics

    assert metrics.rgb_lpips(a, b, net, device="cpu") == got


def test_lpips_without_weights_is_nan(tmp_path, monkeypatch):
    monkeypatch.setenv("NGF_LPIPS_WEIGHTS_DIR", str(tmp_path / "empty"))
    t_lpips._warned.clear()
    assert not t_lpips.lpips_available("vgg")
    with pytest.warns(UserWarning, match="lpips_unavailable"):
        out = t_lpips.rgb_lpips(np.zeros((8, 8, 3)), np.zeros((8, 8, 3)), "vgg")
    assert np.isnan(out)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # once only
        assert np.isnan(t_lpips.rgb_lpips(np.zeros((8, 8, 3)), np.zeros((8, 8, 3)), "vgg"))
    assert t_lpips.weights_path("vgg") == j_lpips.weights_path("vgg")


def _fake_render(rays):
    rays = np.asarray(rays)
    rgb = 1.0 / (1.0 + np.exp(-3.0 * rays[:, 3:6]))
    return (torch.from_numpy(rgb.astype(np.float32)),
            torch.from_numpy(np.abs(rays[:, 5]).astype(np.float32) * 4.0))


def test_evaluation_with_weights_fills_mean_txt(lpips_dir, tmp_path):
    ds = load_dataset("synthetic", "synthetic:wh=40,test_views=2", split="test", is_stack=True)
    out = tmp_path / "eval"
    t_eval.evaluation(ds, _fake_render, str(out), n_vis=-1, chunk=500)
    stats = np.loadtxt(out / "mean.txt")
    assert stats.shape == (4,) and np.isfinite(stats).all() and (stats[2:] > 0).all()
    assert not (out / "lpips_unavailable.txt").exists()
    gt = np.asarray(ds.all_rgbs[0]).reshape(40, 40, 3)
    rgb = np.clip(render_view(ds, 0), 0, 1)
    want = np.mean([j_lpips.rgb_lpips(np.asarray(ds.all_rgbs[i]).reshape(40, 40, 3),
                                      np.clip(render_view(ds, i), 0, 1), "alex")
                    for i in range(2)])
    np.testing.assert_allclose(stats[2], want, rtol=1e-5)
    assert gt.shape == rgb.shape


def render_view(ds, i):
    w, h = ds.img_wh
    rgb, _ = _fake_render(np.asarray(ds.all_rays[i]).reshape(-1, 6))
    return rgb.numpy().reshape(h, w, 3)


# -------------------------------------------------------------------- videos


def _frames(path) -> int:
    cap = cv2.VideoCapture(str(path))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def test_evaluation_and_path_write_videos(tmp_path):
    ds = load_dataset("synthetic", "synthetic:wh=16,test_views=3", split="test", is_stack=True)
    t_eval.evaluation(ds, _fake_render, str(tmp_path / "e"), n_vis=-1, chunk=100,
                      compute_extra_metrics=False, prtx="x_")
    for name in ("x_video.mp4", "x_depthvideo.mp4"):
        assert _frames(tmp_path / "e" / name) == 3, name
    c2ws = np.stack([np.eye(4, dtype=np.float32)[:3]] * 4)
    c2ws[:, 2, 3] = np.linspace(3.0, 4.0, 4)
    t_eval.evaluation_path(ds, _fake_render, c2ws, str(tmp_path / "p"), chunk=100)
    for name in ("video.mp4", "depthvideo.mp4"):
        assert _frames(tmp_path / "p" / name) == 4, name
    assert sorted(f for f in os.listdir(tmp_path / "p") if f.endswith(".png")) == [
        f"{i:03d}.png" for i in range(4)]
    # The first frame is the first view, as RGB (mp4v is lossy: to a few levels).
    cap = cv2.VideoCapture(str(tmp_path / "e" / "x_video.mp4"))
    frame = cap.read()[1][..., ::-1].astype(int)
    cap.release()
    png = imageio.imread(str(tmp_path / "e" / "x_000.png")).astype(int)
    assert np.abs(frame - png).mean() < 8
    t_eval.evaluation(ds, _fake_render, str(tmp_path / "n"), n_vis=-1, chunk=100,
                      compute_extra_metrics=False, write_video=False)
    assert not any(f.endswith(".mp4") for f in os.listdir(tmp_path / "n"))


def test_video_skip_lines(tmp_path, monkeypatch, capsys):
    ds = load_dataset("synthetic", "synthetic:wh=16,test_views=1", split="test", is_stack=True)

    class Closed:
        def __init__(self, *a):
            pass

        def isOpened(self):
            return False

    monkeypatch.setattr(cv2, "VideoWriter", Closed)
    t_eval.evaluation(ds, _fake_render, str(tmp_path / "a"), n_vis=-1, chunk=100,
                      compute_extra_metrics=False)
    assert "[evaluation] video write skipped: cv2.VideoWriter could not open" in capsys.readouterr().out
    monkeypatch.setitem(sys.modules, "cv2", None)
    t_eval.evaluation_path(ds, _fake_render, np.eye(4, dtype=np.float32)[None, :3],
                           str(tmp_path / "b"), chunk=100)
    assert "[evaluation_path] video write skipped: " in capsys.readouterr().out
    assert (tmp_path / "b" / "000.png").is_file()
    assert not any(f.endswith(".mp4") for d in ("a", "b") for f in os.listdir(tmp_path / d))


# ----------------------------------------------------------------- profiling


def test_trace_writes_a_chrome_trace(tmp_path):
    with t_prof.trace(str(tmp_path / "tb")):
        with t_prof.annotate("ngf_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "tb")
    chrome = [f for f in files if f.endswith(".pt.trace.json")]
    assert len(files) == 2 and "ngf_spans.json" in files and len(chrome) == 1
    with open(tmp_path / "tb" / chrome[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "ngf_region" for e in events)
    with open(tmp_path / "tb" / "ngf_spans.json") as f:
        assert json.load(f)["spans"]["ngf_region"]["count"] == 1


def test_utils_exports_ngf_tpus_names():
    # The port leaves out the JAX package's StepTimer: its host clock without
    # a synchronise timed the enqueue; the spans of `utils/profiling.py`
    # time each step on the device.
    assert sorted(t_utils.__all__) == sorted(set(j_utils.__all__) - {"StepTimer"})
    for name in t_utils.__all__:
        assert callable(getattr(t_utils, name)), name
    assert t_utils.marching_cubes is t_mc.marching_cubes
