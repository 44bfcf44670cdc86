"""``shade_share.train``: the share of the kept samples whose blend weight clears the shading threshold in training: the program's counters ``shaded`` over ``kept``."""

from gpubench.metrics import program as p

UNIT = "%"
MOVES = "train_rays_per_s"


def read(ctx: dict):
    return p.share(ctx, "shaded", "kept")
