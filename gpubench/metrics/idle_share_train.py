"""``idle_share.train``: Share of the training window in which no kernel, copy or set ran on the device."""

from gpubench.metrics import common as c

UNIT = "%"
MOVES = "train_rays_per_s"


def read(ctx: dict):
    return c.idle(ctx)
