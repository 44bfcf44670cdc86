"""``peak_mem_gib.render``: max_memory_allocated over the render window, reset at its start."""

from gpubench.metrics import common as c

UNIT = "GiB"
MOVES = "render_rays_per_s"


def read(ctx: dict):
    return c.peak_gib(ctx)
