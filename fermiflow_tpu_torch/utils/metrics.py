"""Structured metrics logging (port of ``fermiflow_tpu/utils/metrics.py``):
one JSON line per iteration plus the reference's hours-per-100-iters.
``log`` records one iteration (the loop at one iteration a call),
``log_many`` a chunk of stacked iterations."""

from __future__ import annotations

import json
import time

import torch


class MetricsLogger:
    def __init__(self, path: str | None = None):
        self.path = path
        self._fh = open(path, "a") if path else None
        self._last_t = None

    def log(self, step: int, metrics: dict) -> dict:
        """Record one iteration's metrics (tensors, one host copy each) and
        return the plain dict.  ``iter_seconds`` and
        ``hours_per_100_iters`` are the time since the previous record, so
        the first record has neither."""
        now = time.time()
        rec = {"step": int(step)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError, RuntimeError):
                rec[k] = v
        if self._last_t is not None:
            dt = now - self._last_t
            rec["iter_seconds"] = dt
            # The reference's throughput metric (src/FermionHO2D.py:74).
            rec["hours_per_100_iters"] = dt * 100 / 3600
        self._last_t = now
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        return rec

    def log_many(self, first_step: int, metrics: dict, t_start: float) -> list:
        """Record a chunk of stacked (K,) metrics; the single host copy here
        waits for the device, so wall time / K is the honest per-iteration
        speed."""
        host = {k: torch.as_tensor(v).detach().cpu().double().reshape(-1)
                for k, v in metrics.items()}
        now = time.time()
        n = max(v.shape[0] for v in host.values())
        dt = (now - t_start) / n
        recs = []
        for i in range(n):
            rec = {"step": int(first_step + i)}
            for k, v in host.items():
                rec[k] = float(v[i] if v.shape[0] > 1 else v[0])
            rec["iter_seconds"] = dt
            rec["hours_per_100_iters"] = dt * 100 / 3600
            recs.append(rec)
            if self._fh:
                self._fh.write(json.dumps(rec) + "\n")
        if self._fh:
            self._fh.flush()
        self._last_t = now
        return recs

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
