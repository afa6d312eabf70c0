"""Layer "chunk loop": host milliseconds an iteration in the program's span
``loop.watchdog``, over the untraced part of the window (``spanread.py``):
the divergence watchdog's check of the chunk's rows and its trailing window
(``cli/common.py`` ``_bad``, ``_note_healthy``)."""

from spanread import span_ms


def read(ctx):
    return span_ms(ctx, "loop.watchdog")
