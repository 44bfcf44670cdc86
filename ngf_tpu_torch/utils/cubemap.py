"""Cubemap / square-texture math for the UV-Mapping subsystem.

Port of `ngf_tpu/utils/cubemap.py` (reference `UV-Mapping/util.py:128-312`):
cube-face UV <-> XYZ and the dense-masked cubemap sampling on tensors; the
texture loaders (PIL), the cube -> cross merge and the icosphere (which
replaces trimesh for the sphere template's regular points,
`UV-Mapping/model/gauge_fields.py:158-165`) in numpy, as there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.grid_sample import grid_sample_2d_border


def generate_grid(dim: int, resolution: int) -> np.ndarray:
    """Texel-center grid in [-1, 1]^dim (`InfoInv/utils.py:12-15`)."""
    grid = np.stack(
        np.meshgrid(*([np.arange(resolution)] * dim), indexing="ij"), axis=-1
    )
    return (2 * grid + 1) / resolution - 1


def convert_cube_uv_to_xyz(index: int, uvc: torch.Tensor) -> torch.Tensor:
    """Face-local (v, u) -> unit direction (`UV-Mapping/util.py:128-158`)."""
    vc, uc = uvc[..., 0], uvc[..., 1]
    one = torch.ones_like(uc)
    if index == 0:
        xyz = (one, vc, -uc)
    elif index == 1:
        xyz = (-one, vc, uc)
    elif index == 2:
        xyz = (uc, one, -vc)
    elif index == 3:
        xyz = (uc, -one, vc)
    elif index == 4:
        xyz = (uc, vc, one)
    elif index == 5:
        xyz = (-uc, vc, -one)
    else:
        raise ValueError(f"invalid cube face {index}")
    v = torch.stack(xyz, dim=-1)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def sample_cubemap(cubemap: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Sample a (6, R, R, C) cubemap at unit directions (..., 3).

    Dense-masked version of `UV-Mapping/util.py:166-232`: all six faces are
    sampled for every point and the per-point dominant-axis mask selects one
    (in place of the reference's boolean scatter).
    """
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    eps = 1e-12

    masks = [
        (x > 0) & (ax >= ay) & (ax >= az),
        (x <= 0) & (ax >= ay) & (ax >= az),
        (y > 0) & (ay >= ax) & (ay >= az),
        (y <= 0) & (ay >= ax) & (ay >= az),
        (z > 0) & (az >= ax) & (az >= ay),
        (z <= 0) & (az >= ax) & (az >= ay),
    ]
    uvs = [
        torch.stack([-z / (ax + eps), y / (ax + eps)], -1),
        torch.stack([z / (ax + eps), y / (ax + eps)], -1),
        torch.stack([x / (ay + eps), -z / (ay + eps)], -1),
        torch.stack([x / (ay + eps), z / (ay + eps)], -1),
        torch.stack([x / (az + eps), y / (az + eps)], -1),
        torch.stack([-x / (az + eps), y / (az + eps)], -1),
    ]
    # Priority ordering mirrors the reference's sequential masked writes:
    # later faces overwrite earlier ones where masks overlap (axis ties).
    out = xyz.new_zeros(xyz.shape[:-1] + (cubemap.shape[-1],))
    for face in range(6):
        tap = grid_sample_2d_border(cubemap[face], uvs[face])
        out = torch.where(masks[face][..., None], tap, out)
    return out


def load_square(filename: str) -> np.ndarray:
    """Square edit texture, vertically flipped (`UV-Mapping/util.py:270-274`)."""
    from PIL import Image

    return np.asarray(Image.open(filename))[::-1] / 255.0


def sample_square(square: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """(`UV-Mapping/util.py:277-281`)."""
    return grid_sample_2d_border(square, uv)


def load_cubemap(filenames: list[str]) -> np.ndarray:
    """Six face files -> (6, R, R, C) (`UV-Mapping/util.py:160-163`)."""
    from PIL import Image

    assert len(filenames) == 6
    return np.array([np.asarray(Image.open(f))[::-1] / 255.0 for f in filenames])


def load_cube_from_single_texture(filename: str, rotate: bool = True) -> np.ndarray:
    """Cross-layout image -> 6 faces (`UV-Mapping/util.py:236-262`)."""
    from PIL import Image

    img = Image.open(filename)
    img = img.resize((2048, 1536))
    img = np.asarray(img) / 255.0
    assert img.shape[0] * 4 == img.shape[1] * 3
    res = img.shape[0] // 3
    if rotate:
        cube = [
            img[res : 2 * res, :res][::-1],
            img[res : 2 * res, 2 * res : 3 * res][::-1],
            img[:res, res : 2 * res][:, ::-1],
            img[2 * res : 3 * res, res : 2 * res][:, ::-1],
            img[res : 2 * res, 3 * res :][::-1],
            img[res : 2 * res, res : 2 * res][::-1],
        ]
    else:
        cube = [
            img[res : 2 * res, 2 * res : 3 * res][::-1],
            img[res : 2 * res, :res][::-1],
            img[:res, res : 2 * res][::-1],
            img[2 * res : 3 * res, res : 2 * res][::-1],
            img[res : 2 * res, res : 2 * res][::-1],
            img[res : 2 * res, 3 * res :][::-1],
        ]
    return np.array(cube)


def merge_cube_to_single_texture(
    cube: np.ndarray, flip: bool = True, rotate: bool = True
) -> np.ndarray:
    """(6, R, R, C) faces -> (3R, 4R, C) cross image
    (`UV-Mapping/util.py:286-312`)."""
    assert cube.shape[0] == 6 and cube.shape[1] == cube.shape[2]
    res = cube.shape[1]
    out = np.ones((3 * res, 4 * res, cube.shape[-1]), dtype=cube.dtype)
    if flip:
        cube = cube[:, ::-1]
    if rotate:
        out[res : 2 * res, :res] = cube[0]
        out[res : 2 * res, res : 2 * res] = cube[5]
        out[res : 2 * res, 2 * res : 3 * res] = cube[1]
        out[res : 2 * res, 3 * res :] = cube[4]
        out[:res, res : 2 * res] = cube[2][::-1, ::-1]
        out[2 * res : 3 * res, res : 2 * res] = cube[3][::-1, ::-1]
    else:
        out[res : 2 * res, :res] = cube[1]
        out[res : 2 * res, res : 2 * res] = cube[4]
        out[res : 2 * res, 2 * res : 3 * res] = cube[0]
        out[res : 2 * res, 3 * res :] = cube[5]
        out[:res, res : 2 * res] = cube[2]
        out[2 * res : 3 * res, res : 2 * res] = cube[3]
    return out


def icosphere(subdivisions: int = 2) -> np.ndarray:
    """Unit icosphere vertices (replaces trimesh.creation.icosphere for the
    sphere template's regular points; `gauge_fields.py:158-165`)."""
    return icosphere_mesh(subdivisions)[0]


def icosphere_mesh(subdivisions: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """Icosphere vertices AND faces (for mesh export)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ]
    )
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    for _ in range(subdivisions):
        edge_mid: dict[tuple[int, int], int] = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = verts_list[a] + verts_list[b]
                m /= np.linalg.norm(m)
                edge_mid[key] = len(verts_list)
                verts_list.append(m)
            return edge_mid[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces)
    return verts.astype(np.float32), faces.astype(np.int32)
