"""Self-captured (instant-ngp style) loader: a copy of
`ngf_tpu/data/own_data.py` (`InfoInv/dataLoader/your_own_data.py`).

Format: ``transforms_{split}.json`` with explicit ``w``/``h``/``cx``/``cy``
and both camera angles (typically produced by ``tools/colmap2nerf.py``).
Near/far (0.1, 100.0), white background, bbox [-1.5, 1.5]^3.

Deliberate fix vs the reference: `your_own_data.py:48` keeps cx/cy at
full resolution while w/h are downsampled (a latent bug for any
downsample != 1); here the principal point is scaled with the image.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .dataset import RayDataset
from .blender import BLENDER2OPENCV
from .geometry import get_ray_directions, get_rays
from .image_io import load_image


class OwnDataDataset(RayDataset):
    def __init__(self, datadir, split="train", downsample=1.0,
                 is_stack=None, n_vis=-1):
        self.root_dir = datadir
        self.split = split
        self.is_stack = (split != "train") if is_stack is None else bool(is_stack)
        self.white_bg = True
        self.near_far = (0.1, 100.0)
        self.scene_bbox = np.array([[-1.5] * 3, [1.5] * 3], np.float32)

        with open(os.path.join(datadir, f"transforms_{split}.json")) as f:
            meta = json.load(f)
        w = int(meta["w"] / downsample)
        h = int(meta["h"] / downsample)
        self.img_wh = (w, h)
        fx = 0.5 * w / np.tan(0.5 * meta["camera_angle_x"])
        fy = 0.5 * h / np.tan(0.5 * meta["camera_angle_y"])
        cx, cy = meta["cx"] / downsample, meta["cy"] / downsample
        dirs = get_ray_directions(h, w, [fx, fy], center=[cx, cy])
        self.directions = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
        self.intrinsics = np.array(
            [[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32
        )

        frames = meta["frames"]
        interval = 1 if n_vis < 0 else max(len(frames) // n_vis, 1)
        idxs = list(range(0, len(frames), interval))

        poses, rays_list, rgbs_list = [], [], []
        for i in idxs:
            frame = frames[i]
            c2w = np.asarray(frame["transform_matrix"], np.float32) @ BLENDER2OPENCV
            poses.append(c2w)
            img = load_image(
                os.path.join(datadir, f"{frame['file_path']}.png"), self.img_wh
            )
            if img.shape[-1] == 4:
                img = img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])
            rgbs_list.append(img[..., :3].reshape(-1, 3))
            o, d = get_rays(self.directions, c2w)
            rays_list.append(np.concatenate([o, d], 1))

        self.poses = np.stack(poses)
        self._finalize(rays_list, rgbs_list)
        self.render_path = None
