"""Layer "kernels": the metropolis_chains kernel's frozen bound over its device time a
launch in the traced chunks, in % (nothing where it did not run)."""


def read(ctx):
    return ctx.roofline("metropolis_chains")
