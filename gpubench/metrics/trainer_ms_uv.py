"""``trainer_ms.uv``: the trainer's own device time a step: the program's ``ngf.batch`` (a block's sampling on the host and its copy to the device), ``ngf.optimizer`` (``zero_grad`` and Adam) and ``ngf.log`` (the block's one read of its losses, and the log lines) spans over the window's steps."""

from gpubench.metrics import program as p

UNIT = "ms/step"
MOVES = "train_rays_per_s"


def read(ctx: dict):
    return p.span_ms(ctx, "ngf.batch", "ngf.optimizer", "ngf.log")
