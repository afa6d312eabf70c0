"""``chunk_seeds_ms`` in the cells that report ``iter_ms.k1`` (one iteration a
chunk). Layer "chunk loop": host milliseconds an iteration in the program's
span ``chunk.seeds``, over the untraced part of the window
(``spanread.py``): a replay's seed draw, its pinned host tensor and its copy
into the graph's seed buffer (``train.py`` ``_Chunk._run_captured``). None
where no chunk was replayed (eager chunks)."""

from spanread import span_ms


def read(ctx):
    return span_ms(ctx, "chunk.seeds")
