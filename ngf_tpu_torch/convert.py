"""Parameter trees between numpy (the JAX package's form) and torch.

The JAX package's parameters, fetched to the host (for example
``jax.device_get(init_triplane(...))``), are nested dicts and lists of numpy
arrays with (in, out) weights and (H, W, C) planes. The port keeps the same
names and layout, so the conversion is leaf by leaf.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def params_from_numpy(tree: Any, device: torch.device | str, dtype: torch.dtype | None = None) -> Any:
    """Nested dicts/lists of arrays -> the same tree of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device, dtype) for v in tree]
    # np.array copies: the tensors never alias (possibly read-only) inputs.
    return torch.as_tensor(np.array(tree), device=device, dtype=dtype)


def params_to_numpy(tree: Any) -> Any:
    """Inverse of :func:`params_from_numpy`: tensors -> host numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()
