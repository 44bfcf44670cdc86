"""``k2c_roofline.train``: K2c (the learned gauge's plane and coordinate gradients) in training: its least time over its device time."""

from gpubench.metrics import common as c

UNIT = "%"
MOVES = "train_rays_per_s"


def read(ctx: dict):
    return c.share(c.k2c_bound_s(ctx), c.kernel_s(ctx, c.K2C))
