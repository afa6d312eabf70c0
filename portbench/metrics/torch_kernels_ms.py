"""Layer "estimator chain and Adam": device milliseconds an iteration of
every kernel in the traced chunks that is not one of the port's own."""


def read(ctx):
    return ctx.other_kernels_ms
