"""``roofline.hessian_flow`` in the cells that report ``iter_ms.k1`` (one iteration a
chunk). Layer "kernels": the hessian_flow kernel's frozen bound over its device time a
launch in the traced chunks, in % (nothing where it did not run)."""


def read(ctx):
    return ctx.roofline("hessian_flow")
