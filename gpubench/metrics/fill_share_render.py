"""``fill_share.render``: the share of the sample slots the field decodes in the render that hold a sample in the box and the mask: the program's counters ``kept`` over ``slots``."""

from gpubench.metrics import program as p

UNIT = "%"
MOVES = "render_rays_per_s"


def read(ctx: dict):
    return p.share(ctx, "kept", "slots")
