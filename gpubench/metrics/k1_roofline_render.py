"""``k1_roofline.render``: K1 in rendering: its least time for the samples in the box and mask over its device time."""

from gpubench.metrics import common as c

UNIT = "%"
MOVES = "render_rays_per_s"


def read(ctx: dict):
    return c.share(c.k1_bound_s(ctx), c.kernel_s(ctx, c.K1))
