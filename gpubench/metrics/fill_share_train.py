"""``fill_share.train``: the share of the sample slots the field decodes in training that hold a sample in the box and the mask: the program's counters ``kept`` over ``slots``."""

from gpubench.metrics import program as p

UNIT = "%"
MOVES = "train_rays_per_s"


def read(ctx: dict):
    return p.share(ctx, "kept", "slots")
