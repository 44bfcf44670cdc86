"""``launches_per_step.train``: Device kernels, copies and sets in the window per training step (profiler)."""

from gpubench.metrics import common as c

UNIT = "launches/step"
MOVES = "train_rays_per_s"


def read(ctx: dict):
    return c.launches(ctx)
