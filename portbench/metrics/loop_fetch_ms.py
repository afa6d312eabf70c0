"""Layer "chunk loop": host milliseconds an iteration in the program's span
``loop.fetch``, over the untraced part of the window (``spanread.py``):
after the wait: the row's copies to the host, the record, its JSON line and
flush (``utils/metrics.py``)."""

from spanread import span_ms


def read(ctx):
    return span_ms(ctx, "loop.fetch")
