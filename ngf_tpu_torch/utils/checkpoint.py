"""Self-describing ``.npz`` checkpoints with a packed occupancy bitmap.

Port of `ngf_tpu/utils/checkpoint.py:23-138,189-232`: the parameter tree
flattened to ``param/<path>`` arrays, a JSON ``meta`` blob (model and render
configuration, training state), the alpha volume bit-packed with
``np.packbits`` under ``alphaMask/``, and training-resume state (optimizer
moments, counts, the generator's state) as ``extra/<name>`` arrays. Files
written by either package load in the other. A save writes a temporary file
and renames it over the old one, so a kill mid-write leaves the old file
whole. The JAX package's Orbax directory form is not read here.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from ..convert import params_from_numpy, params_to_numpy


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(_flatten(v, f"{prefix}{i}/"))
    else:
        flat[prefix[:-1]] = np.asarray(tree)
    return flat


def _unflatten(flat: dict[str, np.ndarray]) -> Any:
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_checkpoint(
    path: str,
    params: Any,
    meta: dict | None = None,
    alpha_volume: torch.Tensor | np.ndarray | None = None,
    alpha_aabb: torch.Tensor | np.ndarray | None = None,
    extra_arrays: dict[str, Any] | None = None,
) -> None:
    """Write the parameter tree (+ optional binary occupancy volume and
    ``extra/`` arrays) to one ``.npz`` at ``path``
    (`ngf_tpu/utils/checkpoint.py:56-67,82-137`)."""
    arrays = {f"param/{k}": v for k, v in _flatten(params_to_numpy(params)).items()}
    blob = dict(meta or {})
    if alpha_volume is not None:
        vol = np.asarray(torch.as_tensor(alpha_volume).cpu()) > 0.5
        arrays["alphaMask/mask"] = np.packbits(vol.reshape(-1))
        arrays["alphaMask/aabb"] = np.asarray(torch.as_tensor(alpha_aabb).cpu(), np.float32)
        blob["alphaMask.shape"] = list(vol.shape)
    for k, v in (extra_arrays or {}).items():
        arrays[f"extra/{k}"] = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
    arrays["meta"] = np.frombuffer(json.dumps(blob).encode(), dtype=np.uint8)
    tmp = f"{path}.tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_checkpoint(path: str, device: torch.device | str):
    """Returns (params, meta, alpha_volume | None, alpha_aabb | None), the
    tensors on ``device`` (`ngf_tpu/utils/checkpoint.py:189-215`)."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is an Orbax checkpoint directory; the port reads .npz checkpoints only"
        )
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays.pop("meta")).decode())
    alpha_volume = alpha_aabb = None
    if "alphaMask/mask" in arrays:
        shape = meta["alphaMask.shape"]
        n = int(np.prod(shape))
        bits = np.unpackbits(arrays.pop("alphaMask/mask"))[:n]
        alpha_volume = torch.as_tensor(bits.reshape(shape).astype(np.float32), device=device)
        alpha_aabb = torch.as_tensor(arrays.pop("alphaMask/aabb"), device=device)
    params = _unflatten(
        {k[len("param/"):]: v for k, v in arrays.items() if k.startswith("param/")}
    )
    return params_from_numpy(params, device), meta, alpha_volume, alpha_aabb


def load_extra_arrays(path: str) -> dict[str, np.ndarray]:
    """The ``extra/`` arrays (training-resume state) of an ``.npz``
    checkpoint, without the prefix; empty where it has none
    (`ngf_tpu/utils/checkpoint.py:218-232`)."""
    with np.load(path) as z:
        return {k[len("extra/"):]: z[k] for k in z.files if k.startswith("extra/")}
