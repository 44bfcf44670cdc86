"""Epoch-permutation ray batch sampler: a copy of `ngf_tpu/data/sampler.py`
(`InfoInv/utils.py` SimpleSampler). It is numpy, so one seed gives the same
ids in both packages. :class:`DeviceSampler` hands the same ids out as
slices of a device tensor."""

from __future__ import annotations

import numpy as np
import torch


class SimpleSampler:
    """Yields ``batch`` ray ids per call, re-permuting each epoch.

    Matches the reference's semantics (shuffle the full id range, walk it
    in batch-size strides, reshuffle when fewer than ``batch`` ids remain)
    with a seeded generator so full training runs are reproducible.
    """

    def __init__(self, total: int, batch: int, seed: int = 0):
        self.total = int(total)
        self.batch = int(batch)
        self._rng = np.random.default_rng(seed)
        self._ids: np.ndarray | None = None
        self._curr = self.total

    def _draw(self) -> bool:
        """Move the stream past one batch, drawing a new permutation when
        fewer than ``batch`` ids remain; returns whether it drew one."""
        new = self._ids is None or self._curr + self.batch > self.total
        if new:
            self._ids = self._rng.permutation(self.total)
            self._curr = 0
        self._curr += self.batch
        return new

    def nextids(self) -> np.ndarray:
        self._draw()
        out = self._ids[self._curr - self.batch : self._curr]
        if out.shape[0] < self.batch:  # dataset smaller than one batch
            reps = int(np.ceil(self.batch / max(out.shape[0], 1)))
            out = np.tile(out, reps)[: self.batch]
        return out

    def skip(self, n: int) -> None:
        """Advance the stream as ``n`` calls of :meth:`nextids` would,
        without building their ids: a resumed trainer's position
        (`ngf_tpu/train/loop.py:201-207`)."""
        for _ in range(n):
            self._draw()


class DeviceSampler(SimpleSampler):
    """:class:`SimpleSampler`'s ids, from the same numpy draws, as int64
    tensors on ``device``.

    Each epoch's permutation is copied to the device once (pinned and
    asynchronous on a card), when its first batch is asked for; a batch is
    then a slice of it there, so a step copies nothing from the host, and
    :meth:`skip` copies only the permutation it stops in. A set smaller
    than one batch is tiled on the host first, as :class:`SimpleSampler`
    tiles it, and then every call is an epoch. ``uploads`` counts the
    copies.
    """

    def __init__(self, total: int, batch: int, seed: int = 0, device: torch.device | str = "cpu"):
        super().__init__(total, batch, seed)
        self.device = torch.device(device)
        self._device_ids: torch.Tensor | None = None
        self._uploaded: np.ndarray | None = None  # the permutation _device_ids holds
        self.uploads = 0

    def nextids(self) -> torch.Tensor:
        self._draw()
        if self._uploaded is not self._ids:
            ids = torch.from_numpy(self._ids)
            if self.total < self.batch:
                ids = ids.repeat(-(-self.batch // max(self.total, 1)))[: self.batch]
            if self.device.type == "cuda":
                ids = ids.pin_memory()
            self._device_ids = ids.to(self.device, non_blocking=True)
            self._uploaded = self._ids
            self.uploads += 1
        return self._device_ids[self._curr - self.batch : self._curr]
