"""Frozen copy of the measured package's trace summary
(``fermiflow_tpu_torch/utils/profiling.py`` ``summarize`` and its helpers,
as of the benchmark's first version): device busy time as a union of
intervals, kernel time by name, launch gaps and long gaps, host self times.
The benchmark reads every traced window through this copy, so a later
change to the package's own does not move its metrics.  ``idle_gaps``
(the benchmark's own) names each long device gap by the host operation
running across it.
"""

from __future__ import annotations

SHORT_GAP_US = 10.0  # device gaps up to this long count as launch gaps
# Runtime calls counted on their own: graph replays, single launches (a
# replayed CUDA graph's kernels need none), and host waits for the card.
RUNTIME_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchKernelExC",
                 "cudaStreamSynchronize")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


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


def idle_gaps(trace_events: dict, n: int = 10) -> list:
    """The ``n`` longest gaps between device work (longer than
    ``SHORT_GAP_US``), each as [the innermost host operation or span
    running across the gap's middle, or "host (no traced op)", seconds]."""
    evs = [e for e in trace_events.get("traceEvents", [])
           if e.get("ph") == "X" and "dur" in e]
    busy = _union((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in evs if e.get("cat") in _DEVICE_CATS)
    gaps = sorted(((b[0] - a[1], 0.5 * (a[1] + b[0]))
                   for a, b in zip(busy, busy[1:])
                   if b[0] - a[1] > SHORT_GAP_US), reverse=True)[:n]
    host = [e for e in evs if e.get("cat") in ("cpu_op", "user_annotation",
                                               "python_function")
            or str(e.get("cat", "")).startswith("cuda_")]
    out = []
    for gap, mid in gaps:
        over = [e for e in host
                if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])]
        name = (min(over, key=lambda e: float(e["dur"]))["name"] if over
                else "host (no traced op)")
        out.append([name, gap / 1e6])
    return out
