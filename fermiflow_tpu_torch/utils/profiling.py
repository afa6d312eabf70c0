"""Profiling hooks (port of ``fermiflow_tpu/utils/profiling.py``).

``trace(log_dir)`` records a ``torch.profiler`` trace of the code it wraps:
host operators and CUDA runtime calls and, on a CUDA device, the device's
kernels, copies and fills (through CUPTI).  On exit it writes into
``log_dir``:

* ``trace.json``, the Chrome trace (Perfetto or ``chrome://tracing``);
* ``summary.json`` (``summarize``): the window's wall time; the device's
  busy time, kernel time by name and idle time, split into short gaps
  between back-to-back work (< ``SHORT_GAP_US``: launch latency) and longer
  ones (the device waiting on the host); the kernels the device ran (those
  inside a replayed CUDA graph included); the host operators and runtime
  calls by self time; and the count of each of ``RUNTIME_CALLS``.

``PhaseTimer`` sums wall-clock time per named phase, waiting for the
devices of the tensors it is given before it stops the clock.  Its
``span`` records the host path of every training iteration without
waiting for anything: ``SPANS`` is the one instance that the training loop
(``cli/common.py``), the metrics logger and the captured chunk
(``train.py``) record into, each span also a ``record_function`` range
while a profiler runs, so that ``trace`` puts the spans beside the device's
kernels.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["trace", "summarize", "PhaseTimer", "SPANS", "SHORT_GAP_US",
           "RUNTIME_CALLS"]

SHORT_GAP_US = 10.0  # device gaps up to this long count as launch gaps
# Span records a PhaseTimer keeps: a 10 s run at one iteration a chunk
# makes ~5000 chunks of 7 spans.
_RING = 2**17
# Runtime calls counted on their own: graph replays, single launches (a
# replayed CUDA graph's kernels need none), and host waits for the card.
RUNTIME_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchKernelExC",
                 "cudaStreamSynchronize")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: str | None, cuda: bool | None = None):
    """Capture a ``torch.profiler`` trace into ``log_dir`` (no-op when
    None).  ``cuda`` adds the device's activity (default: when CUDA is
    available)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)
    with open(os.path.join(log_dir, "summary.json"), "w") as fh:
        json.dump(summarize(events), fh, indent=1)


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _top(totals: dict, counts: dict, n: int = 25):
    rows = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
    return [{"name": k, "ms": v / 1e3, "count": counts[k]} for k, v in rows]


def _self_times(ops):
    """Self time (us) and count per name of nested host events ``(ts, end,
    name, tid)``: each event's duration less its direct children's."""
    totals, counts = {}, {}
    by_tid = {}
    for ev in ops:
        by_tid.setdefault(ev[3], []).append(ev)
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e[0], -e[1]))
        stack = []  # [end, name, children's time, duration]
        for s, e, name, _ in evs:
            while stack and stack[-1][0] <= s:
                done = stack.pop()
                totals[done[1]] = totals.get(done[1], 0.0) + done[3] - done[2]
            if stack:
                stack[-1][2] += e - s
            stack.append([e, name, 0.0, e - s])
            counts[name] = counts.get(name, 0) + 1
        for done in stack:
            totals[done[1]] = totals.get(done[1], 0.0) + done[3] - done[2]
    return totals, counts


def summarize(trace_events: dict) -> dict:
    """Wall time, device busy/idle split and host self times (ms) of a
    Chrome trace as ``torch.profiler`` exports it."""
    evs = [e for e in trace_events.get("traceEvents", [])
           if e.get("ph") == "X" and "dur" in e]
    if not evs:
        return {"window_ms": 0.0}
    t0 = min(float(e["ts"]) for e in evs)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in evs)
    out = {"window_ms": (t1 - t0) / 1e3}
    dev = [e for e in evs if e.get("cat") in _DEVICE_CATS]
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
             (e.get("pid"), e.get("tid")))
            for e in evs if e.get("cat") == "cpu_op"
            or str(e.get("cat", "")).startswith("cuda_")]  # CUDA API calls
    totals, counts = _self_times(host)
    out["host_self"] = _top(totals, counts)
    out["runtime_calls"] = {name: counts.get(name, 0) for name in RUNTIME_CALLS}
    if dev:
        busy = _union((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                      for e in dev)
        gaps = [b[0] - a[1] for a, b in zip(busy, busy[1:])]
        short = [g for g in gaps if g <= SHORT_GAP_US]
        long_gaps = sorted((g for g in gaps if g > SHORT_GAP_US), reverse=True)
        k_tot, k_cnt = {}, {}
        for e in dev:
            k_tot[e["name"]] = k_tot.get(e["name"], 0.0) + float(e["dur"])
            k_cnt[e["name"]] = k_cnt.get(e["name"], 0) + 1
        busy_us = sum(e - s for s, e in busy)
        out.update(
            kernels=sum(1 for e in dev if e.get("cat") == "kernel"),
            device_busy_ms=busy_us / 1e3,
            device_idle_ms=(t1 - t0 - busy_us) / 1e3,
            device_idle_share=1.0 - busy_us / (t1 - t0),
            device_lead_tail_idle_ms=(busy[0][0] - t0 + t1 - busy[-1][1]) / 1e3,
            launch_gaps={"count": len(short), "ms": sum(short) / 1e3},
            long_gaps={"count": len(long_gaps), "ms": sum(long_gaps) / 1e3,
                       "largest_ms": [g / 1e3 for g in long_gaps[:10]]},
            device_work=_top(k_tot, k_cnt))
    return out


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class _Span:
    """One occurrence of a span: ``PhaseTimer.span``."""

    __slots__ = ("timer", "name", "parent", "t0", "annotation")

    def __init__(self, timer: PhaseTimer, name: str):
        self.timer = timer
        self.name = name

    def __enter__(self):
        timer = self.timer
        self.parent = timer.current
        timer.current = self.name
        # A record_function costs ~12 us even with no profiler running (the
        # H100 machine's host, torch 2.11); reading the flag, ~0.05 us.
        self.annotation = None
        if _autograd_profiler._is_profiler_enabled:
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        timer = self.timer
        timer.current = self.parent
        timer.records.append((timer.chunk, self.name, self.parent, self.t0,
                              t1 - self.t0))


class PhaseTimer:
    """Wall-clock time per named phase.  ``sync_on`` (a tensor or a nested
    dict, list or tuple of them) makes the phase wait for the CUDA devices
    those tensors live on before its clock stops, since kernels return
    before the device has run them.

    ``span(name)`` times a phase without waiting for any device and keeps
    each occurrence, outside the sums, in ``records``, a ring of the last
    ``_RING`` of them: (``chunk``, the number the caller has set, name, the
    innermost span open around it or None, start and seconds on the
    ``time.perf_counter`` clock).  While a ``torch.profiler`` profile runs,
    a span is also a ``record_function`` range of its name."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.records = collections.deque(maxlen=_RING)
        self.current: str | None = None  # the innermost open span
        self.chunk = 0

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def reset(self) -> None:
        """Forget every phase and record; the chunk number restarts at 0."""
        self.totals.clear()
        self.counts.clear()
        self.records.clear()
        self.current = None
        self.chunk = 0

    @contextlib.contextmanager
    def phase(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for dev in {t.device for t in _tensors(sync_on)}:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(1e3 * self.totals[name] / self.counts[name], 2),
            }
            for name in self.totals
        }


# The spans of the training loop's host path: ``run_training_loop`` resets
# it when it starts and numbers its chunks from 1.
SPANS = PhaseTimer()
