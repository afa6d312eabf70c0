"""Profiling hooks (port of ``fermiflow_tpu/utils/profiling.py``).

``trace(log_dir)`` records a ``torch.profiler`` trace of the code it wraps:
host operators and CUDA runtime calls and, on a CUDA device, the device's
kernels, copies and fills (through CUPTI).  On exit it writes into
``log_dir``:

* ``trace.json``, the Chrome trace (Perfetto or ``chrome://tracing``);
* ``summary.json`` (``summarize``): the window's wall time; the device's
  busy time, kernel time by name and idle time, split into short gaps
  between back-to-back work (< ``SHORT_GAP_US``: launch latency) and longer
  ones (the device waiting on the host); and the host operators and
  runtime calls by self time.
"""

from __future__ import annotations

import contextlib
import json
import os

import torch

__all__ = ["trace", "summarize", "SHORT_GAP_US"]

SHORT_GAP_US = 10.0  # device gaps up to this long count as launch gaps
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
            device_busy_ms=busy_us / 1e3,
            device_idle_ms=(t1 - t0 - busy_us) / 1e3,
            device_idle_share=1.0 - busy_us / (t1 - t0),
            device_lead_tail_idle_ms=(busy[0][0] - t0 + t1 - busy[-1][1]) / 1e3,
            launch_gaps={"count": len(short), "ms": sum(short) / 1e3},
            long_gaps={"count": len(long_gaps), "ms": sum(long_gaps) / 1e3,
                       "largest_ms": [g / 1e3 for g in long_gaps[:10]]},
            device_work=_top(k_tot, k_cnt))
    return out

