"""The program's own spans over the untraced window, for the readers of
the "chunk loop" metrics (``metrics/loop_*.py``, ``metrics/chunk_*.py``).

``fermiflow_tpu_torch.utils.profiling.SPANS`` keeps a ring of records
(chunk number, name, parent, start, seconds) that the training loop numbers
by chunk from 1, the count the traffic's ``warmup_chunks`` and
``trace_chunks`` use.  A run ends in the last traced chunk, so the window's
chunks are ``warmup_chunks`` + 1 to the last recorded chunk less
``trace_chunks``.  The window itself opens in the last warm-up chunk's
``loop.print`` (the harness's ``print_row``) and closes in its own last
chunk's, where the harness also starts its tracer: each span counts only
the part of it inside [end of the last warm-up chunk's ``loop.print``,
that + the window's wall time].
"""

from __future__ import annotations


def _records():
    """The program's span records, or None for a program that keeps
    none."""
    try:
        from fermiflow_tpu_torch.utils.profiling import SPANS
    except ImportError:
        return None
    return list(SPANS.records)


def window(ctx):
    """(first chunk, last chunk, open, close) of the untraced window on the
    spans' clock, or None where the ring no longer holds the last warm-up
    chunk's ``loop.print``."""
    records = _records()
    if not records:
        return None
    warmup = ctx.c["warmup_chunks"]
    last = max(r[0] for r in records) - ctx.c["trace_chunks"]
    opened = [t + d for n, name, _, t, d in records
              if n == warmup and name == "loop.print"]
    if not opened or last <= warmup:
        return None
    iters = (last - warmup) * ctx.c["steps_per_call"]
    t_open = opened[-1]
    return warmup + 1, last, t_open, t_open + 1e-3 * ctx.wall_ms_per_iter * iters


def span_ms(ctx, name: str):
    """Host ms an iteration in span ``name`` inside the untraced window, or
    None where the window holds no record of it."""
    win = window(ctx)
    if win is None:
        return None
    first, last, t_open, t_close = win
    inside = [min(t + d, t_close) - max(t, t_open)
              for n, nm, _, t, d in _records()
              if first <= n <= last and nm == name]
    if not inside:
        return None
    iters = (last - first + 1) * ctx.c["steps_per_call"]
    return 1e3 * sum(max(s, 0.0) for s in inside) / iters
