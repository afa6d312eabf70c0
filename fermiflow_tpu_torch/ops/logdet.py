"""Batched small-n Gauss-Jordan inverse and log|det| (port of ``fermiflow_tpu/ops/logdet.py``).

Swap-free partial pivoting: at step k the pivot row is the masked argmax of
|column k| over rows not yet used, applied through one-hot contractions, so
the computation is plain batched arithmetic, unrolled over the small n.
"""

from __future__ import annotations

import torch

__all__ = ["logabsdet", "gauss_jordan_inv"]


def _pivot(col: torch.Tensor, used: torch.Tensor) -> torch.Tensor:
    """One-hot (..., n) of the masked argmax of |col| over unused rows.

    Built by comparison with ``arange`` rather than ``F.one_hot``, whose
    size check reads a value on the host and so fails under
    ``torch.func.vmap`` (the nested-jvp engine maps over walkers).
    """
    score = torch.where(used > 0.5, torch.full_like(col, -float("inf")), col.abs())
    rows = torch.arange(col.shape[-1], device=col.device)
    return (rows == torch.argmax(score, dim=-1)[..., None]).to(col.dtype)


def gauss_jordan_inv(D: torch.Tensor) -> torch.Tensor:
    """(..., n, n) -> (..., n, n) inverses (garbage rows for singular input)."""
    n = D.shape[-1]
    if D.shape[-2] != n:
        raise ValueError(f"square matrices required, got {tuple(D.shape)}")
    batch = D.shape[:-2]
    eye = torch.eye(n, dtype=D.dtype, device=D.device).expand(batch + (n, n))
    m = torch.cat([D, eye], dim=-1)
    used = torch.zeros(batch + (n,), dtype=D.dtype, device=D.device)
    tiny = torch.finfo(D.dtype).tiny
    ohs = []
    for k in range(n):
        col = m[..., k]
        oh = _pivot(col, used)
        pivot_val = torch.sum(oh * col, dim=-1)
        safe = torch.where(pivot_val.abs() > tiny, pivot_val, torch.ones_like(pivot_val))
        pivot_row = torch.sum(oh[..., None] * m, dim=-2) / safe[..., None]
        mult = (1.0 - oh) * col
        m = m - mult[..., None] * pivot_row[..., None, :]
        m = torch.where(oh[..., None] > 0.5, pivot_row[..., None, :], m)
        used = used + oh
        ohs.append(oh)
    rhs = m[..., n:]
    return torch.stack(
        [torch.sum(ohs[k][..., None] * rhs, dim=-2) for k in range(n)], dim=-2
    )


def logabsdet(D: torch.Tensor, tiny: float | None = None) -> torch.Tensor:
    """(..., n, n) -> (...,) log|det D|; -inf-like (log tiny) when singular.

    ``tiny`` floors each |pivot| (default: the dtype's smallest normal); the
    sampler kernels floor at 1e-30.
    """
    n = D.shape[-1]
    if D.shape[-2] != n:
        raise ValueError(f"square matrices required, got {tuple(D.shape)}")
    batch = D.shape[:-2]
    a = D
    used = torch.zeros(batch + (n,), dtype=D.dtype, device=D.device)
    logabs = torch.zeros(batch, dtype=D.dtype, device=D.device)
    if tiny is None:
        tiny = torch.finfo(D.dtype).tiny
    for _ in range(n):
        col = a[..., 0]
        oh = _pivot(col, used)
        pivot_val = torch.sum(oh * col, dim=-1)
        pivot_row = torch.sum(oh[..., None] * a, dim=-2)
        logabs = logabs + torch.log(torch.clamp(pivot_val.abs(), min=tiny))
        remaining = (1.0 - used) * (1.0 - oh)
        safe = torch.where(pivot_val.abs() > tiny, pivot_val, torch.ones_like(pivot_val))
        mult = remaining * col / safe[..., None]
        a = a - mult[..., None] * pivot_row[..., None, :]
        used = used + oh
        a = a[..., 1:]
    return logabs
