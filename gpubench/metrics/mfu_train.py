"""``mfu.train``: The field's operations that the window's training steps need over the window's time and the float32 peak."""

from gpubench.metrics import common as c

UNIT = "%"
MOVES = "train_rays_per_s"


def read(ctx: dict):
    return c.mfu(ctx)
