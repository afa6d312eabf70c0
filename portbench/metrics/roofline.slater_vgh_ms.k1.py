"""``roofline.slater_vgh_ms`` in the cells that report ``iter_ms.k1`` (one
iteration a chunk). Layer "kernels": the mixed-state Slater VGH kernel's
(#6) frozen bound over its device time a launch in the traced chunks, in %
(nothing where it did not run)."""


def read(ctx):
    return ctx.roofline("slater_vgh_ms")
