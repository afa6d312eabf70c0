"""``device_idle_share`` in the cells that report ``iter_ms.k1`` (one iteration a
chunk). Layer "device": the share of the untraced wall time an iteration in
which the device ran nothing, 1 - (busy ms an iteration in the traced
chunks) / (wall ms an iteration untraced), in %."""


def read(ctx):
    return 100.0 * (1.0 - ctx.busy_ms_per_iter / ctx.wall_ms_per_iter)
