"""Parameter trees between numpy (the JAX package's form) and torch.

The JAX package's parameters, fetched to the host (for example
``jax.device_get(init_triplane(...))``), are nested dicts and lists of numpy
arrays with (in, out) weights and (H, W, C) planes. The port keeps the same
names and layout, so the conversion is leaf by leaf. The JAX optimizer's
Adam moments are trees of the same form, so they carry across too.
"""

from __future__ import annotations

from collections.abc import Iterator
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

if TYPE_CHECKING:
    from .train.state import TriPlaneOptimizer


def named_leaves(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(``a/b/0/w``, leaf) pairs of a nested dict/list tree, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


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


def load_optimizer_state(
    opt: "TriPlaneOptimizer", mu: Any, nu: Any, count: Any, schedule_count: Any
) -> None:
    """Set ``opt`` to the JAX optimizer's state, so the next step in the port
    equals the next JAX step.

    ``mu``, ``nu`` and ``count`` are optax ``scale_by_adam``'s first and
    second moments (trees shaped like the parameters) and update count;
    ``schedule_count`` is the count of the learning-rate schedule
    (`ngf_tpu/train/state.py:_scale_by_leaf_lr`). All as numpy. Of
    ``make_optimizer(...).init(params)`` that is ``state[0].mu``,
    ``state[0].nu``, ``state[0].count`` and ``state[1]["count"]``.
    """
    mu_l, nu_l = dict(named_leaves(mu)), dict(named_leaves(nu))
    leaves = dict(named_leaves(opt.params))
    if set(mu_l) != set(leaves) or set(nu_l) != set(leaves):
        raise ValueError(
            f"optimizer state names {sorted(set(mu_l) ^ set(leaves))} differ from the parameters'"
        )
    for name, p in leaves.items():
        opt.adam.state[p] = {
            "step": torch.tensor(float(np.asarray(count)), dtype=torch.float32),
            "exp_avg": torch.as_tensor(np.array(mu_l[name]), dtype=p.dtype, device=p.device),
            "exp_avg_sq": torch.as_tensor(np.array(nu_l[name]), dtype=p.dtype, device=p.device),
        }
    opt.count = int(np.asarray(schedule_count))
