"""Synthetic-NeRF (Blender) loader: a copy of `ngf_tpu/data/blender.py`
(`InfoInv/dataLoader/blender.py`).

Format: ``transforms_{split}.json`` with ``camera_angle_x`` and a 4x4
``transform_matrix`` a frame (OpenGL convention), and RGBA PNGs. Alpha is
composited onto white (`blender.py:80`), directions are normalised once on
the grid (`blender.py:52`), and poses are converted to the OpenCV
convention.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .dataset import RayDataset
from .geometry import get_ray_directions, get_rays, spherical_path
from .image_io import load_image

BLENDER2OPENCV = np.array(
    [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]], np.float32
)


class BlenderDataset(RayDataset):
    def __init__(self, datadir, split="train", downsample=1.0, is_stack=None, n_vis=-1):
        self.root_dir = datadir
        self.split = split
        self.is_stack = (split != "train") if is_stack is None else bool(is_stack)
        s = int(800 / downsample)
        self.img_wh = (s, s)
        self.white_bg = True
        self.near_far = (2.0, 6.0)
        self.scene_bbox = np.array([[-1.5] * 3, [1.5] * 3], np.float32)

        with open(os.path.join(datadir, f"transforms_{split}.json")) as f:
            meta = json.load(f)
        w, h = self.img_wh
        focal = 0.5 * 800 / np.tan(0.5 * meta["camera_angle_x"]) * (w / 800)
        self.focal = focal
        dirs = get_ray_directions(h, w, [focal, focal])
        self.directions = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
        self.intrinsics = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32)

        frames = meta["frames"]
        interval = 1 if n_vis < 0 else max(len(frames) // n_vis, 1)
        poses, rays_list, rgbs_list = [], [], []
        for frame in frames[::interval]:
            c2w = np.asarray(frame["transform_matrix"], np.float32) @ BLENDER2OPENCV
            poses.append(c2w)
            img = load_image(os.path.join(datadir, f"{frame['file_path']}.png"), self.img_wh)
            if img.shape[-1] == 4:  # composite alpha onto white
                img = img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])
            rgbs_list.append(img.reshape(-1, 3))
            o, d = get_rays(self.directions, c2w)
            rays_list.append(np.concatenate([o, d], 1))

        self.poses = np.stack(poses)
        self._finalize(rays_list, rgbs_list)
        self.render_path = np.asarray(
            spherical_path(40, phi=-30.0, radius=4.0) @ BLENDER2OPENCV, np.float32
        )
