"""``launches_per_chunk.render``: Device kernels, copies and sets in the window per rendered chunk (profiler)."""

from gpubench.metrics import common as c

UNIT = "launches/chunk"
MOVES = "render_rays_per_s"


def read(ctx: dict):
    return c.launches(ctx)
