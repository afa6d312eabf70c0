"""``loop_print_ms`` in the cells that report ``iter_ms.k1`` (one iteration a
chunk). Layer "chunk loop": host milliseconds an iteration in the program's
span ``loop.print``, over the untraced part of the window (``spanread.py``):
the rows' printing (``cli/common.py``: the ``print_row`` it is handed)."""

from spanread import span_ms


def read(ctx):
    return span_ms(ctx, "loop.print")
