"""The port's loaders and NDC helpers against the JAX package on the CPU.

- ``data/llff.py``, ``data/nsvf.py``, ``data/tankstemple.py`` and
  ``data/own_data.py`` against `ngf_tpu`'s on the scenes that
  `tests/test_loaders.py`'s fixtures write (random pixels, LLFF's
  ``poses_bounds.npy`` with ``images_4/``, NSVF's ``0_/1_/2_`` splits) and on
  the analytic scene exported by `tools/reference_ab.py` in each format:
  rays, colours, poses, the render path, ``near_far``, the box, the
  background, the image size, the directions, the intrinsics and
  ``ndc_params``.
- ``data/geometry.py``'s pose and path functions against
  `ngf_tpu/data/geometry.py` on the inputs of
  `tests/test_data_utils.py::TestCameraPaths`.
- ``ops/rays.py``'s ``depth2dist``, ``ndc2dist``, ``ndc_bbox`` and
  ``ndc_rays_blender`` against `ngf_tpu/ops/rays.py:274-333`.
- ``evaluation_path`` on an LLFF scene: the path's rays projected to NDC as
  `ngf_tpu/render/evaluation.py:165-173` projects them, and its frames.
- The registry serves every name of `ngf_tpu`'s, and `main_torch.py
  --dataset_name llff` trains in NDC and renders the spiral path.

Tolerances: the loaders' arrays to 1e-6 (both run the same numpy on the
same files; the splits, sizes and ``ndc_params`` exactly); the torch NDC
helpers to 1e-6 of the numpy ones.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402, F401  (the conftest's CPU platform)
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from test_loaders import llff_dir, nsvf_dir, write_png  # noqa: E402, F401
from test_torch_render import REPO  # noqa: E402

from ngf_tpu.data import dataset_dict as j_datasets  # noqa: E402
from ngf_tpu.data import geometry as jg  # noqa: E402
from ngf_tpu.ops import rays as j_rays  # noqa: E402
from ngf_tpu.render import evaluation as j_eval  # noqa: E402
from ngf_tpu_torch.data import geometry as tg  # noqa: E402
from ngf_tpu_torch.data import load_dataset  # noqa: E402
from ngf_tpu_torch.data.registry import dataset_dict as t_datasets  # noqa: E402
from ngf_tpu_torch.ops import rays as t_rays  # noqa: E402
from ngf_tpu_torch.render import evaluation as t_eval  # noqa: E402

sys.path.insert(0, REPO)
from tools.reference_ab import export_scene_llff, export_scene_nsvf, export_scene_own  # noqa: E402

@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARRAYS = ("all_rays", "all_rgbs", "poses", "render_path", "scene_bbox", "directions",
          "intrinsics")
EXACT = ("img_wh", "near_far", "white_bg", "is_stack", "ndc_params", "n_images", "focal")


def _same(name, datadir, split, **kw):
    theirs = j_datasets[name](datadir, split=split, **kw)
    ours = t_datasets[name](datadir, split=split, **kw)
    for k in ARRAYS:
        a, b = getattr(ours, k, None), getattr(theirs, k, None)
        assert (a is None) == (b is None), k
        if a is not None:
            assert np.shape(a) == np.shape(b), k
            np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                       rtol=0, atol=1e-6, err_msg=k)
    for k in EXACT:
        assert getattr(ours, k, None) == getattr(theirs, k, None), k
    assert ours.all_rays.dtype == ours.all_rgbs.dtype == np.float32
    return ours


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The analytic scene in the LLFF, NSVF, Tanks-and-Temples and own-data
    layouts."""
    root = tmp_path_factory.mktemp("exported")
    export_scene_llff(str(root / "llff"), 9, 16)
    export_scene_nsvf(str(root / "nsvf"), 3, 1, 16)
    export_scene_nsvf(str(root / "tankstemple"), 2, 1, 36, fmt="tankstemple")
    export_scene_own(str(root / "own_data"), 3, 1, 16)
    return root


@pytest.mark.parametrize("split", ["train", "test"])
def test_llff_matches_jax(llff_dir, exported, split):  # noqa: F811
    ours = _same("llff", llff_dir, split, downsample=1.0)
    assert ours.n_images == (7 if split == "train" else 2)  # hold-every-8 of 9
    assert ours.render_path.shape == (120, 4, 4)
    h, w, focal, near = ours.ndc_params
    assert (w, h) == ours.img_wh and near == 1.0
    # The analytic scene, at the loaders' --downsample 4 of its 4x header.
    ours = _same("llff", str(exported / "llff"), split, downsample=4.0)
    assert ours.img_wh == (16, 16)
    assert np.isfinite(ours.all_rays).all()


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_nsvf_matches_jax(nsvf_dir, exported, split):  # noqa: F811
    ours = _same("nsvf", nsvf_dir, split, downsample=100.0, wh=(800, 800))
    assert ours.all_rays.shape[0] == (2 * 64 if split == "train" else 1)
    if split != "val":
        _same("nsvf", str(exported / "nsvf"), split, downsample=800.0 / 16)


@pytest.mark.parametrize("split", ["train", "test"])
def test_tankstemple_matches_jax(exported, split):
    ours = _same("tankstemple", str(exported / "tankstemple"), split, downsample=30.0)
    assert ours.img_wh == (64, 36) and ours.render_path.shape == (200, 4, 4)


@pytest.mark.parametrize("split", ["train", "test"])
def test_own_data_matches_jax(exported, tmp_path, split):
    _same("own_data", str(exported / "own_data"), split, downsample=1.0)
    # A non-square frame with its own principal point, downsampled (the
    # JAX package scales cx, cy with the image).
    rng = np.random.default_rng(3)
    os.makedirs(tmp_path / split)
    frames = []
    for i in range(2):
        c2w = np.eye(4)
        c2w[:3, 3] = [0.1 * i, 0, 3]
        frames.append({"file_path": f"./{split}/f_{i}", "transform_matrix": c2w.tolist()})
        write_png(tmp_path / split / f"f_{i}.png", rng.integers(0, 255, (12, 10, 3), dtype=np.uint8))
    meta = {"w": 10, "h": 12, "cx": 4.5, "cy": 6.5, "camera_angle_x": 0.7,
            "camera_angle_y": 0.8, "frames": frames}
    import json

    with open(tmp_path / f"transforms_{split}.json", "w") as f:
        json.dump(meta, f)
    ours = _same("own_data", str(tmp_path), split, downsample=2.0)
    assert ours.img_wh == (5, 6)


def test_registry_serves_every_loader(tmp_path):
    assert sorted(t_datasets) == sorted(j_datasets)
    for name in t_datasets:
        assert t_datasets[name].__module__.startswith("ngf_tpu_torch."), name
    with pytest.raises(ValueError, match="unknown dataset"):
        load_dataset("colmap", str(tmp_path))


def test_camera_paths_match_jax():
    """`tests/test_data_utils.py::TestCameraPaths`'s inputs, and the LLFF
    pose chain, through both packages' geometry."""
    np.testing.assert_array_equal(tg.spherical_path(40, phi=-30.0, radius=4.0),
                                  jg.spherical_path(40, phi=-30.0, radius=4.0))
    for kw in ({"radius": 3.0, "h": 0.5, "frames": 20},
               {"radius": 2.0, "h": -0.3, "axis": "z", "up": (0, 0, 1), "frames": 7},
               {"radius": 2.5, "h": 0.4, "axis": "x", "frames": 5}):
        np.testing.assert_array_equal(tg.circle_path(**kw), jg.circle_path(**kw))
    poses = np.stack([np.concatenate([np.eye(3), [[0.2 * i], [0.05 * i * i], [0.5]]], 1)
                      for i in range(5)])
    nf = np.tile([[1.0, 5.0]], (5, 1))
    np.testing.assert_array_equal(tg.get_spiral(poses, nf, n_views=120),
                                  jg.get_spiral(poses, nf, n_views=120))
    np.testing.assert_array_equal(tg.average_poses(poses), jg.average_poses(poses))
    for a, b in zip(tg.center_poses(poses, np.eye(4)), jg.center_poses(poses, np.eye(4))):
        np.testing.assert_array_equal(a, b)
    c2w = jg.average_poses(poses)
    up = np.array([0.0, 1.0, 0.1])
    np.testing.assert_array_equal(tg.render_path_spiral(c2w, up, [0.3, 0.2, 0.1], 2.0, n=9),
                                  jg.render_path_spiral(c2w, up, [0.3, 0.2, 0.1], 2.0, n=9))
    np.testing.assert_array_equal(tg.viewmatrix(np.array([0.1, 0.2, 1.0]), up, np.ones(3)),
                                  jg.viewmatrix(np.array([0.1, 0.2, 1.0]), up, np.ones(3)))
    np.testing.assert_array_equal(tg.look_at_rotation(np.array([1.0, 2.0, 3.0])),
                                  jg.look_at_rotation(np.array([1.0, 2.0, 3.0])))
    for fn in ("get_ray_directions", "get_ray_directions_blender"):
        np.testing.assert_array_equal(getattr(tg, fn)(4, 6, [10.0, 11.0], center=(2.5, 2.0)),
                                      getattr(jg, fn)(4, 6, [10.0, 11.0], center=(2.5, 2.0)))
    o = np.array([[0.0, 0.0, -0.5], [0.3, -0.2, 0.4]], np.float32)
    d = np.array([[0.0, 0.0, -1.0], [0.1, 0.2, -0.9]], np.float32)
    for a, b in zip(tg.ndc_rays_blender(8, 8, 10.0, 1.0, o, d),
                    jg.ndc_rays_blender(8, 8, 10.0, 1.0, o, d)):
        np.testing.assert_array_equal(a, b)


def test_ndc_ray_helpers_match_jax():
    rng = np.random.default_rng(4)
    o = rng.uniform(-0.5, 0.5, (64, 3)).astype(np.float32)
    d = np.concatenate([rng.uniform(-0.3, 0.3, (64, 2)), -rng.uniform(0.5, 1.0, (64, 1))],
                       1).astype(np.float32)
    for a, b in zip(t_rays.ndc_rays_blender(12, 10, 9.5, 1.0, torch.from_numpy(o),
                                            torch.from_numpy(d)),
                    j_rays.ndc_rays_blender(12, 10, 9.5, 1.0, jnp.asarray(o), jnp.asarray(d))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    z = np.sort(rng.uniform(0.0, 1.0, (64, 20)), -1).astype(np.float32)
    cos = rng.uniform(0.5, 1.0, 64).astype(np.float32)
    np.testing.assert_allclose(
        t_rays.depth2dist(torch.from_numpy(z), torch.from_numpy(cos)).numpy(),
        np.asarray(j_rays.depth2dist(jnp.asarray(z), jnp.asarray(cos))), rtol=1e-6)
    pts = rng.normal(size=(64, 20, 3)).astype(np.float32)
    np.testing.assert_allclose(
        t_rays.ndc2dist(torch.from_numpy(pts), torch.from_numpy(cos)).numpy(),
        np.asarray(j_rays.ndc2dist(jnp.asarray(pts), jnp.asarray(cos))), rtol=1e-6)
    rays = np.concatenate([o, d], 1).reshape(4, 16, 6)
    np.testing.assert_allclose(t_rays.ndc_bbox(torch.from_numpy(rays)).numpy(),
                               np.asarray(j_rays.ndc_bbox(jnp.asarray(rays))), rtol=1e-6)


def test_evaluation_path_projects_llff_rays_to_ndc(exported, tmp_path):
    """Both packages' ``evaluation_path`` hand the renderer the same NDC
    rays of the spiral's views, and the port writes their frames."""
    seen = {"ours": [], "theirs": []}

    def recorder(key, to_numpy, back):
        def render(rays):
            r = to_numpy(rays)
            seen[key].append(r)
            return back(r[:, 3:6] * 0.5 + 0.5), back(r[:, 2])
        return render

    ds = load_dataset("llff", str(exported / "llff"), split="test", downsample=4.0, is_stack=True)
    jds = j_datasets["llff"](str(exported / "llff"), split="test", downsample=4.0, is_stack=True)
    path = ds.render_path[:2]
    t_eval.evaluation_path(ds, recorder("ours", lambda r: r.numpy(), torch.from_numpy), path,
                           str(tmp_path / "ours"), chunk=128)
    j_eval.evaluation_path(jds, recorder("theirs", np.asarray, jnp.asarray), path,
                           str(tmp_path / "theirs"), chunk=128)
    ours, theirs = np.concatenate(seen["ours"]), np.concatenate(seen["theirs"])
    assert ours.shape == theirs.shape == (2 * 16 * 16, 6)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)
    # NDC: origins on the near plane z = -1, directions' z in (0, 2].
    np.testing.assert_allclose(ours[:, 2], -1.0, atol=1e-5)
    assert (ours[:, 5] > 0).all() and (ours[:, 5] <= 2.0 + 1e-6).all()
    for name in ("000.png", "001.png", "rgbd/000.png"):
        assert (tmp_path / "ours" / name).is_file(), name


def test_cli_trains_llff_in_ndc_and_renders_the_spiral(exported, tmp_path):
    import main_torch

    argv = ["--dataset_name", "llff", "--datadir", str(exported / "llff"), "--device", "cpu",
            "--downsample_train", "4", "--downsample_test", "4", "--plane_res", "32",
            "--alpha_grid_res", "16", "--nSamples", "48", "--batch_size", "256",
            "--n_iters", "6", "--update_AlphaMask_list", "4", "--render_test", "1",
            "--render_path", "1", "--compute_extra_metrics", "0", "--basedir", str(tmp_path),
            "--expname", "llff", "--ndc_ray", "1"]
    out = main_torch.main(argv)
    assert out["iterations"] == 6 and np.isfinite(out["train_mses"]).all()
    assert len(out["test_psnrs"]) == 2 and np.isfinite(out["test_psnrs"]).all()
    frames = sorted(os.listdir(tmp_path / "llff" / "imgs_path_all"))
    assert "000.png" in frames and "119.png" in frames


def test_chip_smoke_llff_phase_on_cpu():
    """`chip_smoke.py`'s llff phase at a tiny size on the CPU (plain
    versions): the forward-facing scene written from the analytic scene and
    read back, trained in NDC across a mask event with falling losses, and
    two views of the spiral rendered."""
    import chip_smoke

    out = chip_smoke.llff_phase(
        torch.device("cpu"), views=9, wh=16, iters=40, path_views=2,
        extra=("--plane_res", "32", "--alpha_grid_res", "16", "--nSamples", "48",
               "--batch_size", "256", "--open_sample_cap", "32", "--eval_chunk", "256",
               "--update_AlphaMask_list", "20"))
    assert out["frames"] == 2 and out["mses"][1] < out["mses"][0]
    assert [e["iteration"] for e in out["events"]] == [20] and len(out["test_psnrs"]) == 2
