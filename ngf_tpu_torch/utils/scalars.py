"""Scalar-curve logging (JSONL): a copy of `ngf_tpu/utils/scalars.py`.

The reference pip-installs tensorboard but every summary_writer call is
commented out (`InfoInv/main.py:316,349`; SURVEY.md §5 'Metrics/logging');
log.txt text lines were its only scalar record. This is the working
equivalent: one JSON object per record in ``scalars.jsonl`` next to
log.txt — trivially greppable/plottable, no heavyweight dependency.
TensorBoard users can convert with three lines of pandas.
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping


class ScalarWriter:
    """Append-only JSONL scalar writer: {"step": i, "tag": x, ...}."""

    def __init__(self, logdir: str, filename: str = "scalars.jsonl"):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, filename)
        self._t0 = time.time()

    def write(self, step: int, scalars: Mapping[str, float]) -> None:
        rec = {"step": int(step), "wall": round(time.time() - self._t0, 3)}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                continue
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
