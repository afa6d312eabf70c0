"""Layer "chunk loop": host milliseconds an iteration inside the chunk
function the loop calls (seed draw, pointer check, seed copy, replay
launch, clone), over the untraced part of the window."""


def read(ctx):
    return ctx.chunk_call_ms
