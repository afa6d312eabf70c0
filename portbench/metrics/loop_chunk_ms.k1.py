"""``loop_chunk_ms`` in the cells that report ``iter_ms.k1`` (one iteration a
chunk). Layer "chunk loop": host milliseconds an iteration in the program's
span ``loop.chunk``, over the untraced part of the window (``spanread.py``):
the chunk function's call from the loop (the program's counterpart of the
harness's ``chunk_call``)."""

from spanread import span_ms


def read(ctx):
    return span_ms(ctx, "loop.chunk")
