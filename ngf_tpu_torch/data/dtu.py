"""DTU multi-view dataset for the UV-Mapping (NeuTex) subsystem: a copy of
`ngf_tpu/data/dtu.py` (reference `UV-Mapping/data/dtu.py:27-236`), numpy
only, so the same seed gives the same batches in both packages.

Two implementations share the sampling logic:

- :class:`DtuDataset` — the on-disk format: ``trainData/`` camera npys
  (in_camOrgs/Ats/Focal/Princpt/Extrinsics) + ``data.hdf5`` with images
  and masks, test-view holdout via test_views/exclude files or the CLI.
- :class:`SyntheticDtuDataset` — an analytic textured sphere with the
  same camera/batch contract (the public mirror ships no ``data.hdf5``,
  so tests, benchmarks and dry runs use this stand-in).

The JAX package's fixture writer ``write_dtu_scene`` is not copied: the
tests write their on-disk scenes with it.

Four pixel-sampling modes (`dtu.py:144-166`): ``patch`` (random square
crop), ``random``, ``balanced`` (2/3 foreground + 1/3 background with
transmittance targets 0/1, `dtu.py:184-225`), ``no_crop`` (full image).
Items carry a leading batch dim of 1, matching the reference's
``get_item`` (`dtu.py:227-236`).
"""

from __future__ import annotations

import os

import numpy as np


def get_rays_dir(pixelcoords: np.ndarray, focal, rot: np.ndarray,
                 princpt) -> np.ndarray:
    """Pixel coords -> unit world ray directions (`dtu.py:27-37`).

    ``rot`` is the world-to-camera rotation block of the extrinsics; the
    reference contracts ``sum(rot[None,None] * dirs[..., None], -2)``,
    i.e. applies rot^T (camera-to-world).
    """
    focal = np.atleast_1d(np.asarray(focal, np.float64))
    fx, fy = float(focal[0]), float(focal[-1])
    x = (pixelcoords[..., 0] - princpt[0]) / fx
    y = (pixelcoords[..., 1] - princpt[1]) / fy
    dirs = np.stack([x, y, np.ones_like(x)], -1)
    dirs = dirs @ np.asarray(rot, np.float64)  # rot^T applied to rows
    return (dirs / (np.linalg.norm(dirs, axis=-1, keepdims=True) + 1e-5)).astype(
        np.float32
    )


class _DtuSamplingBase:
    """get_item/sample over (gt_image float [0,1], gt_mask float {0,1})."""

    # subclasses set: campos, camat, focal, princpt, extrinsics, height,
    # width, indexes, gt_image (N,H,W,3), gt_mask (N,H,W), _rng,
    # random_sample, random_sample_size; then call _build_pixel_lists()

    def __len__(self) -> int:
        return len(self.indexes)

    def _pixel_batch(self, view: int):
        s = self.random_sample_size
        h, w = self.height, self.width
        mode = self.random_sample
        trans = None
        if mode == "patch":
            ix = self._rng.integers(0, w - s + 1)
            iy = self._rng.integers(0, h - s + 1)
            px, py = np.meshgrid(
                np.arange(ix, ix + s, dtype=np.float32),
                np.arange(iy, iy + s, dtype=np.float32),
            )
        elif mode == "random":
            px = self._rng.integers(0, w, size=(s, s)).astype(np.float32)
            py = self._rng.integers(0, h, size=(s, s)).astype(np.float32)
        elif mode == "balanced":
            px, py, trans = self._proportional_select(view)
        else:  # no_crop
            px, py = np.meshgrid(
                np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32)
            )
        return px, py, trans

    def _build_pixel_lists(self) -> None:
        """For the balanced mode, each view's foreground and background
        pixels as flat indices ``y * width + x``, in the order ``np.where``
        gives them, built once at load: at DTU's 1600 x 1200 a scan of the
        mask costs more host time than a step."""
        self._lists: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        if self.random_sample == "balanced":
            for view in self.indexes:
                flat = self.gt_mask[view].reshape(-1)
                self._lists[view] = (np.flatnonzero(flat > 0).astype(np.int32),
                                     np.flatnonzero(flat == 0).astype(np.int32))

    def _proportional_select(self, view: int):
        """2/3 foreground (transmittance target 0) then 1/3 background
        (target 1) (`dtu.py:184-225`): the draws of a scan of the mask, on
        the view's cached pixel lists."""
        s = self.random_sample_size
        fg, bg = self._lists[view]
        n_fg = min(int(s * s * 2.0 / 3.0), fg.shape[0])
        n_bg = s * s - n_fg
        fi = self._rng.integers(0, fg.shape[0], n_fg)
        trans = np.zeros(n_fg + n_bg, np.float32)
        if bg.shape[0] == 0:
            # No background in this view: fill the bg slots with more
            # foreground pixels and give them the FOREGROUND target (a
            # transmittance-1 target on a real object ray would fight the
            # color loss every time the view is sampled).
            bg = fg
            bi = self._rng.integers(0, fg.shape[0], n_bg)
        else:
            bi = self._rng.integers(0, bg.shape[0], n_bg)
            trans[n_fg:] = 1.0
        yx = np.concatenate([fg[fi], bg[bi]])
        w = self.width
        return (yx % w).astype(np.float32), (yx // w).astype(np.float32), trans

    def get_item(self, idx: int) -> dict:
        """One view's sampled pixel batch, leading batch dim 1."""
        view = self.indexes[idx]
        px, py, trans = self._pixel_batch(view)
        pix = np.stack([px, py], -1).astype(np.float32)
        raydir = get_rays_dir(
            pix, self.focal[view], self.extrinsics[view][0:3, 0:3],
            self.princpt[view],
        ).reshape(-1, 3)
        gt = self.gt_image[view][py.astype(np.int32).reshape(-1),
                                 px.astype(np.int32).reshape(-1), :]
        item = {
            "campos": self.campos[view].astype(np.float32)[None],
            "raydir": raydir[None],
            "gt_image": gt.reshape(-1, 3).astype(np.float32)[None],
            "background_color": np.zeros(3, np.float32)[None],
        }
        if trans is not None:
            item["transmittance"] = trans.reshape(-1)[None]
        return item

    def sample(self) -> dict:
        """Random training view's batch (the DataLoader-shuffle analog)."""
        return self.get_item(int(self._rng.integers(len(self.indexes))))


class DtuDataset(_DtuSamplingBase):
    """On-disk DTU scan (`dtu.py:40-115`). ``point_cloud`` is not loaded:
    no loss in this framework consumes it (the reference stores it on the
    item but only ever uses template points for the origin loss)."""

    def __init__(self, data_root: str, random_sample: str = "no_crop",
                 random_sample_size: int = 64, use_test_data: bool = False,
                 test_views: str = "6,13,35,30", seed: int = 0):
        self.random_sample = random_sample
        self.random_sample_size = int(random_sample_size)
        self._rng = np.random.default_rng(seed)

        d = os.path.join(data_root, "trainData")
        self.campos = np.load(os.path.join(d, "in_camOrgs.npy"))
        self.camat = np.load(os.path.join(d, "in_camAts.npy"))
        self.focal = np.load(os.path.join(d, "in_camFocal.npy"))
        self.princpt = np.load(os.path.join(d, "in_camPrincpt.npy"))
        self.extrinsics = np.load(os.path.join(d, "in_camExtrinsics.npy"))
        self.total = self.campos.shape[0]

        def _view_list(text: str) -> list[int]:
            return [int(x) for x in text.strip().split(",") if x.strip()]

        exclude = []
        if os.path.isfile(os.path.join(d, "exclude.txt")):
            with open(os.path.join(d, "exclude.txt")) as f:
                exclude = _view_list(f.readline())
        if os.path.isfile(os.path.join(d, "test_views.txt")):
            with open(os.path.join(d, "test_views.txt")) as f:
                tviews = _view_list(f.readline())
        else:
            tviews = _view_list(str(test_views))

        if use_test_data:
            self.indexes = tviews
        else:
            self.indexes = [
                i for i in range(self.total)
                if i not in tviews and i not in exclude
            ]
        if not self.indexes:
            raise ValueError(f"{data_root}: empty view set")

        try:
            import h5py
        except ImportError as e:
            raise ImportError(
                "DtuDataset reads data.hdf5 with h5py, which is not installed; "
                "--dataset_name synthetic_dtu needs no h5py"
            ) from e

        with h5py.File(os.path.join(d, "data.hdf5"), "r") as f:
            self.gt_image = np.asarray(f["in"][0 : self.total], np.float32) / 255.0
            if "in_masks" in f:
                self.gt_mask = (
                    np.asarray(f["in_masks"][0 : self.total], np.float32) / 255.0
                )
            else:
                self.gt_mask = np.ones(self.gt_image.shape[:3], np.float32)
        self.height = int(self.gt_image.shape[1])
        self.width = int(self.gt_image.shape[2])
        self.center_cam_pos = self.campos[min(33, self.total - 1)]
        self._build_pixel_lists()


def _sphere_texture(n: np.ndarray) -> np.ndarray:
    """Smooth view-independent color over the unit sphere."""
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    return np.clip(
        np.stack(
            [
                0.5 + 0.45 * np.sin(5.0 * x + 2.0 * y),
                0.5 + 0.45 * np.sin(4.0 * y + 3.0 * z + 1.0),
                0.5 + 0.45 * np.sin(6.0 * z + 2.0 * x + 3.0),
            ],
            -1,
        ),
        0.0,
        1.0,
    ).astype(np.float32)


class SyntheticDtuDataset(_DtuSamplingBase):
    """Analytic stand-in: textured sphere (radius 0.6) at the origin,
    cameras on a ring at distance 2.5 (inside the reference's near/far =
    |campos| +- 1 convention and outside NeuTex's [-1, 1]^3 cube)."""

    SPHERE_RADIUS = 0.6
    CAM_DIST = 2.5

    def __init__(self, n_views: int = 8, wh: tuple = (64, 64),
                 random_sample: str = "no_crop", random_sample_size: int = 64,
                 use_test_data: bool = False, seed: int = 0):
        self.random_sample = random_sample
        self.random_sample_size = int(random_sample_size)
        self._rng = np.random.default_rng(seed)
        self.width, self.height = int(wh[0]), int(wh[1])
        self.total = int(n_views)

        # ring of cameras looking at the origin
        azim = np.linspace(0, 2 * np.pi, self.total, endpoint=False)
        if use_test_data:  # offset half a step: held-out novel views
            azim = azim + (np.pi / self.total)
        elev = np.deg2rad(20.0)
        self.campos = (
            self.CAM_DIST
            * np.stack(
                [
                    np.cos(azim) * np.cos(elev),
                    np.full_like(azim, np.sin(elev)),
                    np.sin(azim) * np.cos(elev),
                ],
                -1,
            )
        ).astype(np.float32)
        self.camat = np.zeros_like(self.campos)
        f = 1.5 * self.width
        self.focal = np.tile(np.array([[f, f]], np.float32), (self.total, 1))
        self.princpt = np.tile(
            np.array([[self.width / 2, self.height / 2]], np.float32),
            (self.total, 1),
        )

        self.extrinsics = np.zeros((self.total, 4, 4), np.float32)
        up = np.array([0.0, -1.0, 0.0])
        for i in range(self.total):
            z = -self.campos[i] / np.linalg.norm(self.campos[i])
            x = np.cross(up, z)
            x = x / np.linalg.norm(x)
            y = np.cross(z, x)
            r_c2w = np.stack([x, y, z], 1)  # columns = camera axes
            self.extrinsics[i, :3, :3] = r_c2w.T
            self.extrinsics[i, :3, 3] = -r_c2w.T @ self.campos[i]
            self.extrinsics[i, 3, 3] = 1.0

        self.indexes = list(range(self.total))
        if use_test_data:
            self.indexes = self.indexes[: max(1, self.total // 4)]

        self.gt_image = np.zeros((self.total, self.height, self.width, 3), np.float32)
        self.gt_mask = np.zeros((self.total, self.height, self.width), np.float32)
        px, py = np.meshgrid(
            np.arange(self.width, dtype=np.float32),
            np.arange(self.height, dtype=np.float32),
        )
        pix = np.stack([px, py], -1)
        for i in range(self.total):
            d = get_rays_dir(
                pix, self.focal[i], self.extrinsics[i, :3, :3], self.princpt[i]
            ).reshape(-1, 3)
            c = self.campos[i]
            b = d @ c
            disc = b * b - (c @ c - self.SPHERE_RADIUS ** 2)
            hit = disc > 0
            t = -b - np.sqrt(np.where(hit, disc, 0.0))
            hit &= t > 0
            p = c[None] + d * t[:, None]
            n = p / self.SPHERE_RADIUS
            color = np.where(hit[:, None], _sphere_texture(n), 0.0)
            self.gt_image[i] = color.reshape(self.height, self.width, 3)
            self.gt_mask[i] = hit.reshape(self.height, self.width).astype(np.float32)
        self._build_pixel_lists()
