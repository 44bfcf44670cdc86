"""``trainer_ms.train``: the trainer's own device time a step: the program's ``ngf.batch`` (the batch gather) and ``ngf.optimizer`` (``zero_grad`` and Adam) spans over the window's steps."""

from gpubench.metrics import program as p

UNIT = "ms/step"
MOVES = "train_rays_per_s"


def read(ctx: dict):
    return p.span_ms(ctx, "ngf.batch", "ngf.optimizer")
