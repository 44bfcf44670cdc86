"""``field_ms.train``: the field's device time a training step: the program's ``ngf.field`` span (projection, gauge, K1 fetch, both decoders' forward) over the window's steps."""

from gpubench.metrics import program as p

UNIT = "ms/step"
MOVES = "train_rays_per_s"


def read(ctx: dict):
    return p.span_ms(ctx, "ngf.field")
