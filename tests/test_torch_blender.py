"""The port's Blender loader (`ngf_tpu_torch/data/blender.py`) against
`ngf_tpu`'s on a scene the test writes (as `tests/test_loaders.py` does):
train and stacked test splits, ``downsample`` (with a resize), RGBA
composited on white, ``n_vis``, poses, focal, directions and
``render_path``, to 1e-6; ``load_image`` on uint16, LA and palette images;
and the lego recipe `configs/lego_infoinv_tpu.txt` training a few steps on
the scene through `main_torch.py --device cpu`, with a ``model.npz`` that
`ngf_tpu` loads."""

import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)

import torch  # noqa: E402
from PIL import Image  # noqa: E402

from ngf_tpu.data import dataset_dict as j_datasets  # noqa: E402
from ngf_tpu.data.geometry import get_ray_directions as j_get_ray_directions  # noqa: E402
from ngf_tpu.data.image_io import load_image as j_load_image  # noqa: E402
from ngf_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint  # noqa: E402
from ngf_tpu_torch.data import load_dataset  # noqa: E402
from ngf_tpu_torch.data.blender import BlenderDataset  # noqa: E402
from ngf_tpu_torch.data.geometry import get_ray_directions  # noqa: E402
from ngf_tpu_torch.data.image_io import load_image  # noqa: E402

ATTRS = ("all_rays", "all_rgbs", "poses", "directions", "intrinsics", "render_path", "scene_bbox")


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """One thread here and in the subprocesses: the test runner starts a
    worker per core, and bfloat16 CPU kernels slow down by orders of
    magnitude when their threads outnumber the cores."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def blender_dir(tmp_path):
    """Three RGBA frames of 16 x 16 a split, some pixels transparent."""
    rng = np.random.default_rng(0)
    for split in ("train", "test"):
        frames = []
        os.makedirs(tmp_path / split)
        for i in range(3):
            theta = i * 2.0
            c2w = np.eye(4)
            c2w[:3, 3] = [np.sin(theta) * 4, 0.5, np.cos(theta) * 4]
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w.tolist()})
            img = rng.integers(0, 255, (16, 16, 4), dtype=np.uint8)
            img[:4, :4, 3] = 0
            Image.fromarray(img, "RGBA").save(tmp_path / split / f"r_{i}.png")
        with open(tmp_path / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.6911112070083618, "frames": frames}, f)
    return str(tmp_path)


@pytest.mark.parametrize("split,downsample,n_vis", [
    ("train", 50.0, -1), ("test", 50.0, -1), ("train", 100.0, -1), ("test", 50.0, 1),
], ids=["train", "test_stacked", "resized", "n_vis"])
def test_blender_matches_jax_loader(blender_dir, split, downsample, n_vis):
    ours = load_dataset("blender", blender_dir, split=split, downsample=downsample, n_vis=n_vis)
    theirs = j_datasets["blender"](blender_dir, split=split, downsample=downsample, n_vis=n_vis)
    assert isinstance(ours, BlenderDataset)
    assert ours.img_wh == theirs.img_wh == (int(800 / downsample),) * 2
    assert (ours.is_stack, ours.white_bg, ours.near_far) == (
        theirs.is_stack, theirs.white_bg, theirs.near_far) == (split != "train", True, (2.0, 6.0))
    assert ours.focal == pytest.approx(theirs.focal, rel=1e-12)
    for name in ATTRS:
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=name)
    assert ours.n_images == (3 if n_vis < 0 else 1)
    assert ours.render_path.shape == (40, 4, 4)
    np.testing.assert_allclose(np.linalg.norm(ours.all_rays.reshape(-1, 6)[:, 3:], axis=-1),
                               1.0, atol=1e-5)


def test_transparent_pixels_are_white(blender_dir):
    """Alpha composited onto white (`blender.py:80`): the fully transparent
    corner of every frame is exactly 1."""
    ds = load_dataset("blender", blender_dir, split="test", downsample=50.0)
    np.testing.assert_array_equal(ds.all_rgbs[:, :4, :4], 1.0)


def test_ray_directions_match_jax():
    for h, w, focal, center in ((4, 6, (5.0, 7.0), None), (8, 8, (3.0, 3.0), (2.5, 4.0))):
        np.testing.assert_array_equal(get_ray_directions(h, w, focal, center),
                                      j_get_ray_directions(h, w, focal, center))


@pytest.mark.parametrize("mode", ["uint16", "LA", "P", "RGBA_resized"])
def test_load_image_matches_jax(tmp_path, mode):
    rng = np.random.default_rng(1)
    path = str(tmp_path / "img.png")
    if mode == "uint16":
        Image.fromarray(rng.integers(0, 65535, (6, 5), dtype=np.uint16)).save(path)
        want_c = 3
    elif mode == "LA":
        Image.fromarray(rng.integers(0, 255, (6, 5, 2), dtype=np.uint8), "LA").save(path)
        want_c = 4
    elif mode == "P":
        img = Image.fromarray(rng.integers(0, 255, (6, 5, 3), dtype=np.uint8), "RGB")
        img.convert("P", palette=Image.ADAPTIVE, colors=8).save(path)
        want_c = 3
    else:
        Image.fromarray(rng.integers(0, 255, (12, 10, 4), dtype=np.uint8), "RGBA").save(path)
        want_c = 4
    wh = (4, 3) if mode == "RGBA_resized" else None
    ours, theirs = load_image(path, wh), j_load_image(path, wh)
    assert ours.dtype == np.float32 and ours.shape[-1] == want_c
    assert ours.shape[:2] == ((3, 4) if wh else (6, 5))
    assert 0.0 <= ours.min() and ours.max() <= 1.0
    np.testing.assert_array_equal(ours, theirs)


def test_lego_recipe_trains_on_blender_scene(blender_dir, tmp_path):
    """`configs/lego_infoinv_tpu.txt` as it is but for its size (bfloat16,
    grouped, measured capacity, mask_stride 4), on the written scene."""
    import main_torch

    argv = ["--config", os.path.join(REPO, "configs", "lego_infoinv_tpu.txt"),
            "--datadir", blender_dir, "--downsample_train", "50", "--downsample_test", "50",
            "--device", "cpu", "--plane_res", "32", "--alpha_grid_res", "16", "--nSamples", "48",
            "--batch_size", "256", "--open_sample_cap", "32", "--n_iters", "6",
            "--update_AlphaMask_list", "3", "--density_shift", "0",
            "--basedir", str(tmp_path / "log"), "--expname", "lego"]
    out = main_torch.main(argv)
    assert out["iterations"] == 6 and np.isfinite(out["train_mses"]).all()
    assert [(e["kind"], e["iteration"]) for e in out["events"]] == [("mask", 3)]
    assert len(out["test_psnrs"]) == 3 and np.isfinite(out["test_psnrs"]).all()
    params, meta, alpha, _ = j_load_checkpoint(str(tmp_path / "log" / "lego" / "model.npz"))
    assert meta["iteration"] == 6 and meta["model_cfg"]["compute_dtype"] == "bfloat16"
    assert alpha is not None and "resume" in meta
    assert np.asarray(params["plane_xy"]).dtype == np.float32


def test_chip_smoke_lego_phase_on_cpu():
    """`chip_smoke.py`'s lego phase at a tiny size on the CPU (plain
    versions): the Blender scene written from the synthetic views and read
    back, the recipe's run SIGTERMed in a subprocess once ``log.txt`` passes
    step 6, its resume to 40 across two later mask events, the
    uninterrupted run and the PSNR gap, the restored trainer against the
    saving one, and the checkpoint's cost."""
    import chip_smoke

    out = chip_smoke.lego_phase(
        torch.device("cpu"), views=2, wh=16, iters=40, save_every=4, sigterm_after=6,
        downsample=50.0, reps=1,
        extra=("--plane_res", "32", "--alpha_grid_res", "16", "--nSamples", "48",
               "--batch_size", "256", "--open_sample_cap", "32", "--density_shift", "0",
               "--update_AlphaMask_list", "3", "--update_AlphaMask_list", "20",
               "--update_AlphaMask_list", "30", "--vis_every", "25",
               "--progress_refresh_rate", "1"))
    stopped = out["sigterm"]["stopped"]
    assert 6 < stopped < 20 and [s for s, _ in out["sigterm"]["blocked_s"]] == list(
        range(4, stopped + 1, 4))
    assert [e["iteration"] for e in out["resumed"]["events"]] == [20, 30]
    assert [(e["iteration"], e["first"]) for e in out["events"]] == [(3, True), (20, False),
                                                                     (30, False)]
    assert out["psnr_gap_db"] <= chip_smoke.LEGO_PSNR_GAP_DB and np.isfinite(out["test_psnr"])
    assert all(out["restored_equal"].values())
    cost = out["checkpoint"]
    assert cost["file_bytes"] > cost["state_bytes"] > 0
    assert len(cost["sync_blocked_s"]) == len(cost["from_checkpoint_s"]) == 1
