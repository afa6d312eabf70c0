"""Structured metrics logging (port of ``fermiflow_tpu/utils/metrics.py``):
one JSON line per iteration plus the reference's hours-per-100-iters."""

from __future__ import annotations

import json
import time

import torch


class MetricsLogger:
    def __init__(self, path: str | None = None):
        self.path = path
        self._fh = open(path, "a") if path else None
        self._last_t = None

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
