"""Self-describing ``.npz`` checkpoints with a packed occupancy bitmap.

Port of `ngf_tpu/utils/checkpoint.py:23-232`: the parameter tree
flattened to ``param/<path>`` arrays, a JSON ``meta`` blob (model and render
configuration, training state), the alpha volume bit-packed with
``np.packbits`` under ``alphaMask/``, and training-resume state (optimizer
moments, counts, the generator's state) as ``extra/<name>`` arrays. Files
written by either package load in the other. A save is a host snapshot
(:func:`pack_checkpoint`) and a write to a temporary file renamed over the
old one (:func:`write_arrays_atomic`), so a kill mid-write leaves the old
file whole; :class:`AsyncCheckpointWriter` runs the write on a thread. The
JAX package's Orbax directory form is not read here: it needs orbax and
tensorstore, JAX-ecosystem code; the refusal names the way across.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any

import numpy as np
import torch

from ..convert import named_leaves, params_from_numpy


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


def _host(v: Any) -> np.ndarray:
    """A host copy of a tensor, so that later in-place updates of the
    training state do not reach the snapshot; an array as it is."""
    if torch.is_tensor(v):
        return v.detach().to("cpu", copy=True).numpy()
    return np.asarray(v)


def pack_checkpoint(
    params: Any,
    meta: dict | None = None,
    alpha_volume: torch.Tensor | np.ndarray | None = None,
    alpha_aabb: torch.Tensor | np.ndarray | None = None,
    extra_arrays: dict[str, Any] | None = None,
) -> dict[str, np.ndarray]:
    """The checkpoint's arrays on the host: the blocking part of a save
    (`ngf_tpu/utils/checkpoint.py:56-80`). Pair with
    :func:`write_arrays_atomic` or :class:`AsyncCheckpointWriter`."""
    arrays = {f"param/{k}": _host(v) for k, v in named_leaves(params)}
    blob = dict(meta or {})
    if alpha_volume is not None:
        vol = _host(alpha_volume) > 0.5
        arrays["alphaMask/mask"] = np.packbits(vol.reshape(-1))
        arrays["alphaMask/aabb"] = _host(alpha_aabb).astype(np.float32)
        blob["alphaMask.shape"] = list(vol.shape)
    for k, v in (extra_arrays or {}).items():
        arrays[f"extra/{k}"] = _host(v)
    arrays["meta"] = np.frombuffer(json.dumps(blob).encode(), dtype=np.uint8)
    return arrays


def write_arrays_atomic(path: str, arrays: dict[str, np.ndarray]) -> None:
    """``np.savez`` of ``arrays`` to ``<path>.tmp``, flushed and synced,
    then renamed over ``path`` (`ngf_tpu/utils/checkpoint.py:119-137`): a
    crash mid-write leaves the old file whole and no ``.tmp`` behind."""
    tmp = f"{path}.tmp"
    try:
        with open(tmp, "wb") as f:
            # A file object: np.savez would append ".npz" to a name.
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class AsyncCheckpointWriter:
    """One background thread writing :func:`pack_checkpoint`'s arrays
    (`ngf_tpu/utils/checkpoint.py:140-186`).

    The training thread pays only for the host snapshot; ``np.savez`` and
    the atomic rename run on a worker. One write is in flight at a time:
    ``submit`` first joins the previous write and re-raises its error, so a
    failed write is loud at the next save or :meth:`wait`. Call
    :meth:`wait` before a synchronous save of the same file and before the
    process exits."""

    def __init__(self) -> None:
        self._thread: threading.Thread | None = None
        self._exc: BaseException | None = None

    def wait(self) -> None:
        """Block until the write in flight finishes; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def submit(self, path: str, arrays: dict[str, np.ndarray]) -> None:
        self.wait()

        def run() -> None:
            try:
                write_arrays_atomic(path, arrays)
            except BaseException as e:  # noqa: BLE001 - re-raised by the next wait or submit
                self._exc = e

        self._thread = threading.Thread(target=run, name="ckpt-writer", daemon=True)
        self._thread.start()


def save_checkpoint(
    path: str,
    params: Any,
    meta: dict | None = None,
    alpha_volume: torch.Tensor | np.ndarray | None = None,
    alpha_aabb: torch.Tensor | np.ndarray | None = None,
    extra_arrays: dict[str, Any] | None = None,
) -> None:
    """Write the parameter tree (+ optional binary occupancy volume and
    ``extra/`` arrays) to one ``.npz`` at ``path``, synchronously
    (`ngf_tpu/utils/checkpoint.py:82-116`)."""
    write_arrays_atomic(path, pack_checkpoint(params, meta, alpha_volume, alpha_aabb, extra_arrays))


def load_checkpoint(path: str, device: torch.device | str):
    """Returns (params, meta, alpha_volume | None, alpha_aabb | None), the
    tensors on ``device`` (`ngf_tpu/utils/checkpoint.py:189-215`)."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is an Orbax checkpoint directory; the port reads .npz checkpoints only "
            "(Orbax needs tensorstore, JAX-ecosystem code). To carry it across, load it with "
            "ngf_tpu.utils.checkpoint.load_checkpoint and write it again with that package's "
            'save_checkpoint(..., backend="npz").'
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
