"""``peak_mem_gib.train``: max_memory_allocated over the training window, reset at its start."""

from gpubench.metrics import common as c

UNIT = "GiB"
MOVES = "train_rays_per_s"


def read(ctx: dict):
    return c.peak_gib(ctx)
