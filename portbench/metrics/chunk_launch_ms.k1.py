"""``chunk_launch_ms`` in the cells that report ``iter_ms.k1`` (one iteration a
chunk). Layer "chunk loop": host milliseconds an iteration in the program's
span ``chunk.launch``, over the untraced part of the window
(``spanread.py``): a replay's pointer check, graph launch, clone and unbind
(``train.py`` ``_Chunk._run_captured``). None where no chunk was replayed
(eager chunks)."""

from spanread import span_ms


def read(ctx):
    return span_ms(ctx, "chunk.launch")
