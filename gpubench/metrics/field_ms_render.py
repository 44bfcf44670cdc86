"""``field_ms.render``: the field's device time a rendered chunk: the program's ``ngf.field`` span (projection, gauge, K1 fetch, both decoders) over the window's chunks."""

from gpubench.metrics import program as p

UNIT = "ms/chunk"
MOVES = "render_rays_per_s"


def read(ctx: dict):
    return p.span_ms(ctx, "ngf.field")
