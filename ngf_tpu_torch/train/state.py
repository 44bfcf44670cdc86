"""Optimizer with per-group learning rates and exponential decay.

Port of `ngf_tpu/train/state.py` (reference `InfoInv/main.py:235-243,
298-299`, `InfoInv/models/Field.py:27-37`): Adam with betas (0.9, 0.99) and
eps 1e-8; planes (``plane_*``) at ``lr_init``, gauge grids (``gauge_*``) at
``lr_basis * 0.1``, everything else at ``lr_basis``; before update t
(counted from 0) every group's rate is ``base * ratio ** (t / decay_iters)``.
Its state converts to and from the JAX optimizer's optax leaves, the form
both packages' checkpoints keep.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..convert import adam_from_optax_leaves, adam_to_optax_leaves, named_leaves, sorted_named_leaves


def group_lr(name: str, lr_init: float, lr_basis: float) -> float:
    """Base learning rate of the top-level parameter ``name``
    (`ngf_tpu/train/state.py:32-45`)."""
    if name.startswith("plane_"):
        return lr_init
    if name.startswith("gauge_"):
        return lr_basis * 0.1
    return lr_basis


class TriPlaneOptimizer:
    """``torch.optim.Adam`` over a parameter tree, one group per base rate,
    with the decay of `ngf_tpu/train/state.py:23-29` applied before each step.

    ``count`` is the schedule's count of updates taken (optax's
    ``_scale_by_leaf_lr`` state); Adam keeps its own ``step`` per parameter.
    Both start from 0 with each new optimizer, as the JAX trainer's
    ``_make_optimizer(reset=True)`` restarts both of its counts.
    """

    def __init__(
        self,
        params: Any,
        lr_init: float,
        lr_basis: float,
        target_ratio: float = 0.1,
        decay_iters: int = 30000,
        betas: tuple[float, float] = (0.9, 0.99),
        eps: float = 1e-8,
    ):
        self.params = params
        groups: dict[float, list[torch.Tensor]] = {}
        for name, sub in params.items():
            lr = group_lr(name, lr_init, lr_basis)
            groups.setdefault(lr, []).extend(t for _, t in named_leaves(sub))
        self.adam = torch.optim.Adam(
            [{"params": ts, "lr": lr, "base_lr": lr} for lr, ts in groups.items()],
            betas=betas, eps=eps,
        )
        self.target_ratio = float(target_ratio)
        self.decay_iters = int(decay_iters)
        self.count = 0

    def lr_scale(self) -> float:
        return self.target_ratio ** (self.count / self.decay_iters)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        scale = self.lr_scale()
        for g in self.adam.param_groups:
            g["lr"] = g["base_lr"] * scale
        self.adam.step()
        self.count += 1

    def _sorted_leaves(self) -> list[torch.Tensor]:
        return [t for _, t in sorted_named_leaves(self.params)]

    def to_optax_leaves(self) -> list[np.ndarray]:
        """The state as the leaves of the JAX trainer's ``optax.chain(
        scale_by_adam, _scale_by_leaf_lr, scale)`` (`ngf_tpu/train/state.py:62-75`):
        Adam's count, the first moments, the second moments (parameters in
        sorted leaf order), then the schedule's count."""
        return adam_to_optax_leaves(self.adam, self._sorted_leaves(), self.count)

    def load_optax_leaves(self, leaves: list[np.ndarray]) -> None:
        """Set the state from :meth:`to_optax_leaves`' form, written by
        either package. Moments map to parameters by name, so the order of
        Adam's groups does not matter; a leaf that does not fit raises
        ValueError."""
        self.count = adam_from_optax_leaves(self.adam, self._sorted_leaves(), leaves)
