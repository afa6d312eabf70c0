"""Layer "chunk loop": host milliseconds an iteration in the program's span
``loop.wait``, over the untraced part of the window (``spanread.py``): the
host blocked until the device has finished the chunk (``utils/metrics.py``,
before the row's first copy)."""

from spanread import span_ms


def read(ctx):
    return span_ms(ctx, "loop.wait")
