"""Tanks&Temples (NSVF export) loader: a copy of
`ngf_tpu/data/tankstemple.py` (`InfoInv/dataLoader/tankstemple.py`).

Same on-disk layout as NSVF (bbox.txt / pose/ / rgb/ with 0_/1_/2_ split
prefixes) but with a full intrinsics matrix in ``intrinsics.txt``, a 1.2x
padded bbox, near/far (0.01, 6.0), and a 200-frame circular look-at
render path around the scene center (`tankstemple.py:165-172`).
"""

from __future__ import annotations

import os

import numpy as np

from .dataset import RayDataset
from .geometry import circle_path, get_ray_directions, get_rays
from .image_io import load_image
from .nsvf import _split_files


class TanksTempleDataset(RayDataset):
    def __init__(self, datadir, split="train", downsample=1.0,
                 wh=(1920, 1080), is_stack=None):
        self.root_dir = datadir
        self.split = split
        self.is_stack = (split != "train") if is_stack is None else bool(is_stack)
        self.img_wh = (int(wh[0] / downsample), int(wh[1] / downsample))
        self.white_bg = True
        self.near_far = (0.01, 6.0)
        self.scene_bbox = (
            np.loadtxt(os.path.join(datadir, "bbox.txt"))
            .flatten()[:6]
            .reshape(2, 3)
            .astype(np.float32)
            * 1.2
        )

        intr = np.loadtxt(os.path.join(datadir, "intrinsics.txt")).astype(np.float64)
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

        # circular look-at path around the scene center (`tankstemple.py:
        # 165-172`): radius from the padded bbox, up from the mean camera y.
        center = self.scene_bbox.mean(0)
        radius = float(np.linalg.norm(self.scene_bbox[1] - center)) * 1.2
        up = self.poses[:, :3, 1].mean(0)
        path = circle_path(
            radius=radius, h=-0.2 * float(up[1]), axis="y",
            up=up.tolist(), frames=200,
        )
        path[:, :3, 3] += center
        self.render_path = path
