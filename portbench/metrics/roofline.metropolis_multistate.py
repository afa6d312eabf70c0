"""Layer "kernels": the metropolis_multistate kernel's frozen bound over its device time a
launch in the traced chunks, in % (nothing where it did not run)."""


def read(ctx):
    return ctx.roofline("metropolis_multistate")
