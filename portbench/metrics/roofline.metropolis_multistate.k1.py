"""``roofline.metropolis_multistate`` in the cells that report
``iter_ms.k1`` (one iteration a chunk). Layer "kernels": the mixed-state
sampler's (#7) frozen bound over its device time a launch in the traced
chunks, in % (nothing where it did not run)."""


def read(ctx):
    return ctx.roofline("metropolis_multistate")
