"""``backward_ms.train``: the backward's device time a training step: the program's ``ngf.backward`` span (``loss.backward()``: K5's, the decoders', K2 and K2c) over the window's steps."""

from gpubench.metrics import program as p

UNIT = "ms/step"
MOVES = "train_rays_per_s"


def read(ctx: dict):
    return p.span_ms(ctx, "ngf.backward")
