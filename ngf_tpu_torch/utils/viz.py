"""Visualization and I/O: image dumps, depth point clouds, PLY/PCD/OBJ writers.

Port of `ngf_tpu/utils/viz.py` (reference `UV-Mapping/util.py:35-126`,
`InfoInv/utils.py:179-239`): per-step PNG dumps named
``{step:08d}-{name}.png``, depth -> binary PCD point clouds, and the mesh
writers, without plyfile or trimesh. The PLY, OBJ and PCD files are byte for
byte the JAX package's; PNGs go through the port's own writer
(`utils/image.py`), since the card's host has no ``imageio``.
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict

import numpy as np

from .image import write_png

# How an f-string prints a float32 numpy scalar, as the JAX writers print
# each coordinate: numpy 2 prints the float64 repr of its value, numpy 1 the
# shortest float32 repr. Whole columns are formatted at once, the same way.
_F32_AS_FLOAT64 = f"{np.float32(0.1)}" != "0.1"


def _strings(a: np.ndarray) -> np.ndarray:
    """Each entry of ``a`` as ``f"{a[i]}"`` prints it, as an array of str."""
    if a.dtype == np.float32 and not _F32_AS_FLOAT64:
        return a.astype(str)
    if a.dtype.kind in "fiu":
        return np.array([str(x) for x in a.reshape(-1).tolist()], dtype=object).reshape(a.shape)
    return np.array([f"{x}" for x in a.reshape(-1)], dtype=object).reshape(a.shape)


def _rows(a: np.ndarray, prefix: str = "") -> str:
    """(n, k) -> ``prefix`` and the k entries joined by spaces, a line each."""
    return "".join(prefix + " ".join(r) + "\n" for r in _strings(a).tolist())


def save_image(img: np.ndarray, path: str) -> None:
    """An image as an 8-bit RGB PNG: floats clipped to [0, 1] and scaled, an
    (H, W) image repeated into three channels (the same pixels as the JAX
    package's grey PNG)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    write_png(path, img)


def depth_to_pointcloud(
    depth: np.ndarray,
    camera_position: np.ndarray,
    ray_directions: np.ndarray,
    mask: np.ndarray | None = None,
) -> np.ndarray:
    """Depth along rays -> 3D points (`ngf_tpu/utils/viz.py:26-38`)."""
    depth = depth.reshape(-1)
    dirs = ray_directions.reshape(-1, 3)
    pts = camera_position.reshape(1, 3) + dirs * depth[:, None]
    if mask is not None:
        pts = pts[mask.reshape(-1)]
    return pts.astype(np.float32)


def save_pointcloud_pcd(points: np.ndarray, path: str) -> None:
    """Binary PCD writer (`ngf_tpu/utils/viz.py:41-59`)."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        "FIELDS x y z\n"
        "SIZE 4 4 4\n"
        "TYPE F F F\n"
        "COUNT 1 1 1\n"
        f"WIDTH {len(points)}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {len(points)}\n"
        "DATA binary\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(points.tobytes())


def save_ply(
    path: str,
    vertices: np.ndarray,
    faces: np.ndarray | None = None,
    colors: np.ndarray | None = None,
) -> None:
    """ASCII PLY writer (`ngf_tpu/utils/viz.py:62-92`): float32 vertices,
    optional uint8 colours (floats clipped to [0, 1] and scaled) and
    triangle faces."""
    vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
    lines = ["ply", "format ascii 1.0", f"element vertex {len(vertices)}"]
    lines += ["property float x", "property float y", "property float z"]
    body = _strings(vertices)
    if colors is not None:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
        lines += ["property uchar red", "property uchar green", "property uchar blue"]
        body = np.concatenate([body, _strings(colors.reshape(-1, 3)[: len(vertices)])], axis=1)
    if faces is not None:
        faces = np.asarray(faces, np.int64).reshape(-1, 3)
        lines += [f"element face {len(faces)}", "property list uchar int vertex_indices"]
    lines += ["end_header"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
        f.write("".join(" ".join(r) + "\n" for r in body.tolist()))
        if faces is not None:
            f.write(_rows(faces, "3 "))


def save_obj(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """Wavefront OBJ writer, 1-based faces (`ngf_tpu/utils/viz.py:95-100`)."""
    with open(path, "w") as f:
        f.write(_rows(np.asarray(vertices).reshape(-1, 3), "v "))
        f.write(_rows(np.asarray(faces).reshape(-1, 3) + 1, "f "))


class Visualizer:
    """Training visual dumps and loss accumulation (`ngf_tpu/utils/viz.py:103-160`)."""

    def __init__(self, log_dir: str, image_dir: str | None = None):
        self.log_dir = log_dir
        self.image_dir = image_dir or log_dir
        os.makedirs(self.image_dir, exist_ok=True)
        self.reset()

    def display_current_results(
        self, visuals: dict, total_steps: int, camera_position=None, ray_directions=None
    ) -> None:
        for name, img in visuals.items():
            save_image(np.asarray(img), os.path.join(self.image_dir, f"{total_steps:08d}-{name}.png"))

        if camera_position is not None and ray_directions is not None:
            for name, img in visuals.items():
                img = np.asarray(img)
                if img.ndim == 2 and "depth" in name:
                    depth = img.reshape(-1)
                    pcd = depth_to_pointcloud(
                        depth, np.asarray(camera_position), np.asarray(ray_directions),
                        depth != 0,
                    )
                    save_pointcloud_pcd(
                        pcd, os.path.join(self.image_dir, f"step-{total_steps:08d}-{name}.pcd"))

    def reset(self) -> None:
        self.start_time = time.time()
        self.acc_iterations = 0
        self.acc_losses: OrderedDict = OrderedDict()

    def accumulate_losses(self, losses: dict) -> None:
        self.acc_iterations += 1
        for k, v in losses.items():
            self.acc_losses[k] = self.acc_losses.get(k, 0.0) + float(v)

    def print_losses(self, total_steps: int) -> str:
        msg = (
            f"End of iteration {total_steps} \t Number of batches "
            f"{self.acc_iterations} \t Time taken: {time.time() - self.start_time:.2f}s\n"
            "[Average Loss] "
            + "   ".join(
                f"{k}: {v / max(self.acc_iterations, 1):.10f}"
                for k, v in self.acc_losses.items()
            )
        )
        with open(os.path.join(self.log_dir, "log.txt"), "a") as f:
            f.write(msg + "\n")
        print(msg)
        return msg
