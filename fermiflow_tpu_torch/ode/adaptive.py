"""Adaptive Dormand–Prince 5(4) with embedded error control
(port of ``fermiflow_tpu/ode/adaptive.py``).

The same embedded error estimate, error norm and step controller
h <- h * clip(0.9 * err^(-1/5), 0.2, 5) as the JAX solver (tolerance parity
with the reference's torchdiffeq dopri5 at rtol=1e-6, atol=1e-8).  JAX needs
two programs, a ``while_loop`` and a masked ``scan`` that reverse mode can
differentiate; eager PyTorch runs one Python loop, which autograd
differentiates, so ``differentiable`` only keeps the signature.  Each
attempt reads its accept decision on the host.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from fermiflow_tpu_torch.ode.integrators import (
    TABLEAUS,
    _axpy,
    tree_flatten,
    tree_map,
)

__all__ = ["odeint_adaptive"]

# 4th-order embedded weights for the error estimate (b5 - b4), including the
# FSAL 7th stage.
_B5 = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0])
_B4 = np.array(
    [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40]
)
_ERR = tuple(float(v) for v in (_B5 - _B4))
_A7 = tuple(float(v) for v in _B5[:6])  # stage-7 node == 5th-order solution (FSAL)
_DOPRI = TABLEAUS["dopri5"]


def _dopri_step(f, params, t, h, x):
    """One dopri5 step: returns (x5, err) with 7 stage evaluations."""
    ks = []
    for i in range(6):
        xi = _axpy(x, h, _DOPRI.a[i], ks) if i else x
        ks.append(f(params, t + _DOPRI.c[i] * h, xi))
    x5 = _axpy(x, h, _A7, ks)
    ks.append(f(params, t + h, x5))
    err = _axpy(tree_map(torch.zeros_like, x), h, _ERR, ks)
    return x5, err


def _error_norm(x, x_new, err, rtol, atol):
    total = 0.0
    count = 0
    for xl, nl, el in zip(tree_flatten(x)[0], tree_flatten(x_new)[0],
                          tree_flatten(err)[0]):
        scale = atol + rtol * torch.maximum(xl.abs(), nl.abs())
        total = total + torch.sum((el / scale) ** 2)
        count += xl.numel()
    ratio = total / count
    # The floor keeps sqrt's gradient finite when the error vanishes.
    return torch.sqrt(torch.clamp(ratio, min=torch.finfo(ratio.dtype).tiny))


def odeint_adaptive(f: Callable, params, x0, t0: float, t1: float,
                    rtol: float = 1e-6, atol: float = 1e-8,
                    max_steps: int = 512, differentiable: bool = False):
    """Integrate dx/dt = f(params, t, x) from t0 to t1 adaptively.

    Supports backward time (t1 < t0); returns the state at t1, or where
    ``max_steps`` attempts (accepted or not) end.
    """
    leaves = tree_flatten(x0)[0]
    kw = dict(dtype=leaves[0].dtype, device=leaves[0].device)
    sign = 1.0 if t1 >= t0 else -1.0
    t = torch.as_tensor(t0, **kw)
    t1a = torch.as_tensor(t1, **kw)
    h = (t1a - t) / 16.0
    x = x0
    n = 0
    while bool((t - t1a) * sign < 0) and n < max_steps:
        # Never overshoot the endpoint.
        h = sign * torch.minimum(h.abs(), (t1a - t).abs())
        x_new, err = _dopri_step(f, params, t, h, x)
        enorm = _error_norm(x, x_new, err, rtol, atol)
        if bool(enorm <= 1.0):
            x, t = x_new, t + h
        factor = torch.clamp(
            0.9 * torch.pow(torch.clamp(enorm, min=1e-10), -0.2), 0.2, 5.0)
        h = h * factor
        n += 1
    return x
