"""``gauge_ms.uv``: the gauge field's forward device time a step: the program's ``ngf.uv.gauge`` (3D to uv) and ``ngf.uv.inverse`` (uv back to 3D, the samples and the template) spans over the window's steps."""

from gpubench.metrics import program as p

UNIT = "ms/step"
MOVES = "train_rays_per_s"


def read(ctx: dict):
    return p.span_ms(ctx, "ngf.uv.gauge", "ngf.uv.inverse")
