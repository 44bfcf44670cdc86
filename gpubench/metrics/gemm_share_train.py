"""``gemm_share.train``: Matrix-product kernels' share of the window's device time in training (names in metrics/common.py)."""

from gpubench.metrics import common as c

UNIT = "%"
MOVES = "train_rays_per_s"


def read(ctx: dict):
    return c.gemm_share(ctx)
