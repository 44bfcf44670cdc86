"""Epoch-permutation ray batch sampler: a copy of `ngf_tpu/data/sampler.py`
(`InfoInv/utils.py` SimpleSampler). It is numpy, so one seed gives the same
ids in both packages."""

from __future__ import annotations

import numpy as np


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

    def nextids(self) -> np.ndarray:
        if self._ids is None or self._curr + self.batch > self.total:
            self._ids = self._rng.permutation(self.total)
            self._curr = 0
        out = self._ids[self._curr : self._curr + self.batch]
        self._curr += self.batch
        if out.shape[0] < self.batch:  # dataset smaller than one batch
            reps = int(np.ceil(self.batch / max(out.shape[0], 1)))
            out = np.tile(out, reps)[: self.batch]
        return out
