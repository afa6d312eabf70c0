"""``torch_kernels_ms`` in the cells that report ``iter_ms.k1`` (one iteration a
chunk). Layer "estimator chain and Adam": device milliseconds an iteration of
every kernel in the traced chunks that is not one of the port's own."""


def read(ctx):
    return ctx.other_kernels_ms
