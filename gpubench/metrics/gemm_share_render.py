"""``gemm_share.render``: Matrix-product kernels' share of the window's device time in rendering."""

from gpubench.metrics import common as c

UNIT = "%"
MOVES = "render_rays_per_s"


def read(ctx: dict):
    return c.gemm_share(ctx)
