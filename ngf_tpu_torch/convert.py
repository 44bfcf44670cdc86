"""Parameter trees between numpy (the JAX package's form) and torch.

The JAX package's parameters, fetched to the host (for example
``jax.device_get(init_triplane(...))``), are nested dicts and lists of numpy
arrays with (in, out) weights and (H, W, C) planes. The port keeps the same
names and layout, so the conversion is leaf by leaf. The JAX optimizer's
Adam moments are trees of the same form, so they carry across too: as trees
for the tri-plane trainer (:func:`load_optimizer_state`), and for the UV
trainer as the flat list of optax state leaves that its checkpoints keep
under ``extra/opt/<i>`` (:func:`adam_to_optax_leaves`,
:func:`adam_from_optax_leaves`).
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


def sorted_named_leaves(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) pairs in ``jax.tree.leaves`` order: dict keys sorted,
    lists in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from sorted_named_leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from sorted_named_leaves(v, f"{prefix}{i}/")
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


def adam_to_optax_leaves(
    adam: torch.optim.Adam, params: list[torch.Tensor], schedule_count: int
) -> list[np.ndarray]:
    """The state of ``adam`` over ``params`` (the trainable leaves in
    :func:`sorted_named_leaves` order) as the leaves of the UV trainer's
    optax state (`ngf_tpu/train/uv_loop.py:113-121`): ``scale_by_adam``'s
    count (int32), every first moment, every second moment, then
    ``scale_by_schedule``'s count. Frozen subnetworks (``set_to_zero``) have
    none. Before the first step the moments are zeros and the counts 0."""
    states = [adam.state.get(p, {}) for p in params]
    count = int(states[0]["step"]) if params and "step" in states[0] else 0
    mu = [s["exp_avg"] if "exp_avg" in s else torch.zeros_like(p) for s, p in zip(states, params)]
    nu = [s["exp_avg_sq"] if "exp_avg_sq" in s else torch.zeros_like(p) for s, p in zip(states, params)]
    return (
        [np.asarray(count, np.int32)]
        # Host copies: a snapshot that later in-place steps do not reach.
        + [t.detach().to("cpu", torch.float32, copy=True).numpy() for t in mu + nu]
        + [np.asarray(schedule_count, np.int32)]
    )


def adam_from_optax_leaves(
    adam: torch.optim.Adam, params: list[torch.Tensor], leaves: list[np.ndarray]
) -> int:
    """Set ``adam``'s state over ``params`` from the optax leaves of
    :func:`adam_to_optax_leaves`; returns the schedule's count. Raises
    ValueError where the leaves do not fit the parameters."""
    n = len(params)
    if len(leaves) != 2 * n + 2:
        raise ValueError(f"{len(leaves)} optimizer leaves for {n} trainable parameters "
                         f"(want {2 * n + 2})")
    for i, p in enumerate(params):
        for leaf in (leaves[1 + i], leaves[1 + n + i]):
            if tuple(np.shape(leaf)) != tuple(p.shape):
                raise ValueError(f"optimizer leaf of shape {np.shape(leaf)} for a parameter "
                                 f"of shape {tuple(p.shape)}")
    count = float(np.asarray(leaves[0]))
    # A fused or capturable Adam keeps its step counts on the parameters' device.
    on_device = adam.defaults.get("fused") or adam.defaults.get("capturable")
    for i, p in enumerate(params):
        adam.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32, device=p.device if on_device else None),
            "exp_avg": torch.as_tensor(np.array(leaves[1 + i]), dtype=p.dtype, device=p.device),
            "exp_avg_sq": torch.as_tensor(np.array(leaves[1 + n + i]), dtype=p.dtype, device=p.device),
        }
    return int(np.asarray(leaves[-1]))
