"""``k1_roofline.train``: K1 (the tri-plane fetch) in training: its least time for the samples in the box and mask over its device time."""

from gpubench.metrics import common as c

UNIT = "%"
MOVES = "train_rays_per_s"


def read(ctx: dict):
    return c.share(c.k1_bound_s(ctx), c.kernel_s(ctx, c.K1))
