"""NSVF-format loader: a copy of `ngf_tpu/data/nsvf.py`
(`InfoInv/dataLoader/nsvf.py`).

Format: ``bbox.txt`` (6 floats + voxel size), ``intrinsics.txt`` (focal
first token; principal point assumed at the image center 400,400 of the
nominal 800x800 frame), ``pose/*.txt`` 4x4 c2w, ``rgb/*.png``. Splits by
filename prefix: 0_=train, 1_=val, 2_=test (test falls back to 1_ when
no 2_ files exist, `nsvf.py:78-85`).
"""

from __future__ import annotations

import os

import numpy as np

from .blender import BLENDER2OPENCV
from .dataset import RayDataset
from .geometry import get_ray_directions, get_rays, spherical_path
from .image_io import load_image


def _split_files(names: list[str], split: str) -> list[str]:
    if split == "train":
        return [x for x in names if x.startswith("0_")]
    if split == "val":
        return [x for x in names if x.startswith("1_")]
    test = [x for x in names if x.startswith("2_")]
    return test if test else [x for x in names if x.startswith("1_")]


class NSVFDataset(RayDataset):
    def __init__(self, datadir, split="train", downsample=1.0,
                 wh=(800, 800), is_stack=None):
        self.root_dir = datadir
        self.split = split
        self.is_stack = (split != "train") if is_stack is None else bool(is_stack)
        self.img_wh = (int(wh[0] / downsample), int(wh[1] / downsample))
        self.white_bg = True
        self.near_far = (0.5, 6.0)
        self.scene_bbox = (
            np.loadtxt(os.path.join(datadir, "bbox.txt"))
            .flatten()[:6]
            .reshape(2, 3)
            .astype(np.float32)
        )

        with open(os.path.join(datadir, "intrinsics.txt")) as f:
            focal = float(f.readline().split()[0])
        intr = np.array([[focal, 0, 400.0], [0, focal, 400.0], [0, 0, 1]])
        intr[:2] *= (np.asarray(self.img_wh) / np.asarray(wh, float)).reshape(2, 1)
        self.intrinsics = intr

        pose_files = _split_files(
            sorted(os.listdir(os.path.join(datadir, "pose"))), split
        )
        img_files = _split_files(
            sorted(os.listdir(os.path.join(datadir, "rgb"))), split
        )
        assert len(pose_files) == len(img_files)

        w, h = self.img_wh
        dirs = get_ray_directions(
            h, w, [intr[0, 0], intr[1, 1]], center=intr[:2, 2]
        )
        self.directions = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)

        poses, rays_list, rgbs_list = [], [], []
        for img_f, pose_f in zip(img_files, pose_files):
            img = load_image(os.path.join(datadir, "rgb", img_f), self.img_wh)
            if img.shape[-1] == 4:
                img = img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])
            rgbs_list.append(img.reshape(-1, 3))
            c2w = np.loadtxt(os.path.join(datadir, "pose", pose_f)).astype(np.float32)
            poses.append(c2w)
            o, d = get_rays(self.directions, c2w)
            rays_list.append(np.concatenate([o, d], 1))

        self.poses = np.stack(poses)
        self._finalize(rays_list, rgbs_list)
        # directions here are OpenCV-convention; convert the Blender-style
        # orbit poses accordingly (same as blender.py does for its frames).
        self.render_path = np.asarray(
            spherical_path(40, phi=-30.0, radius=4.0) @ BLENDER2OPENCV, np.float32
        )
