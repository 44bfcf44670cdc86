"""``k2_roofline.train``: K2 (the plane gradient) in training: its least time over its device time."""

from gpubench.metrics import common as c

UNIT = "%"
MOVES = "train_rays_per_s"


def read(ctx: dict):
    return c.share(c.k2_bound_s(ctx), c.kernel_s(ctx, c.K2))
