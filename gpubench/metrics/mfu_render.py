"""``mfu.render``: The field's operations that the window's rendered rays need over the window's time and the float32 peak."""

from gpubench.metrics import common as c

UNIT = "%"
MOVES = "render_rays_per_s"


def read(ctx: dict):
    return c.mfu(ctx)
