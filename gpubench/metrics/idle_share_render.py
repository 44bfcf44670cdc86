"""``idle_share.render``: Share of the render window in which no kernel, copy or set ran on the device."""

from gpubench.metrics import common as c

UNIT = "%"
MOVES = "render_rays_per_s"


def read(ctx: dict):
    return c.idle(ctx)
