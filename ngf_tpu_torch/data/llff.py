"""LLFF forward-facing loader: a copy of `ngf_tpu/data/llff.py`
(`InfoInv/dataLoader/llff.py`).

Format: ``poses_bounds.npy`` (N, 17) = 3x5 pose+hwf | near/far, images in
``images_4/``. Pipeline: "down right back" -> "right up back" axis swap
(`llff.py:170`), centering on the average pose, scale so min depth is
1/0.75, NDC-projected rays (near plane 1.0), hold-every-8 test split,
120-frame spiral render path.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from .dataset import RayDataset
from .geometry import (
    center_poses,
    get_ray_directions_blender,
    get_rays,
    get_spiral,
    ndc_rays_blender,
)
from .image_io import load_image


class LLFFDataset(RayDataset):
    def __init__(self, datadir, split="train", downsample=4.0,
                 is_stack=None, hold_every=8):
        self.root_dir = datadir
        self.split = split
        self.is_stack = (split != "train") if is_stack is None else bool(is_stack)
        self.white_bg = False
        self.near_far = (0.0, 1.0)
        self.scene_bbox = np.array(
            [[-1.5, -1.67, -1.0], [1.5, 1.67, 1.0]], np.float32
        )

        pb = np.load(os.path.join(datadir, "poses_bounds.npy"))
        image_paths = sorted(glob.glob(os.path.join(datadir, "images_4/*")))
        assert len(pb) == len(image_paths), (
            "Mismatch between number of images and number of poses!"
        )
        poses = pb[:, :15].reshape(-1, 3, 5)
        near_fars = pb[:, -2:]

        H, W, focal = poses[0, :, -1]
        self.img_wh = (int(W / downsample), int(H / downsample))
        w, h = self.img_wh
        self.focal = [focal * w / W, focal * h / H]

        # axis-convention swap + centering
        poses = np.concatenate(
            [poses[..., 1:2], -poses[..., :1], poses[..., 2:4]], -1
        )
        self.poses, self.pose_avg = center_poses(poses, np.eye(4))

        # rescale so the nearest depth sits at 1/0.75
        scale = near_fars.min() * 0.75
        near_fars = near_fars / scale
        self.poses[..., 3] /= scale

        self.render_path = get_spiral(self.poses, near_fars, n_views=120)
        self.directions = get_ray_directions_blender(h, w, self.focal)
        # all_rays are NDC-projected below; novel-path rays must be too
        # (consumed by render/evaluation.py:evaluation_path).
        self.ndc_params = (h, w, float(self.focal[0]), 1.0)

        i_test = np.arange(0, self.poses.shape[0], hold_every)
        if split == "train":
            img_list = sorted(set(range(len(self.poses))) - set(i_test.tolist()))
        else:
            img_list = i_test.tolist()
        self._n_images = len(img_list)

        rays_list, rgbs_list = [], []
        for i in img_list:
            img = load_image(image_paths[i], self.img_wh)[..., :3]
            rgbs_list.append(img.reshape(-1, 3))
            o, d = get_rays(self.directions, self.poses[i])
            o, d = ndc_rays_blender(h, w, self.focal[0], 1.0, o, d)
            rays_list.append(np.concatenate([o, d], 1))
        self._finalize(rays_list, rgbs_list)

    @property
    def n_images(self) -> int:
        return self._n_images
