"""Fixed-grid explicit Runge-Kutta integrators (port of ``fermiflow_tpu/ode/integrators.py``).

``TABLEAUS`` is the port's own copy: the CUDA kernels read their dopri5
coefficients from here (passed in at launch), as the Pallas kernels import
them from the JAX module.  State is a nested tuple/list/dict of tensors;
the step loop is a Python loop (PyTorch runs eagerly), and autograd
differentiates it like JAX differentiates the scan.
"""

from __future__ import annotations

from typing import Callable

__all__ = ["odeint", "rk_step", "tree_map", "TABLEAUS"]


class _Tableau:
    def __init__(self, a, b, c):
        self.a = [tuple(float(v) for v in row) for row in a]
        self.b = tuple(float(v) for v in b)
        self.c = tuple(float(v) for v in c)
        self.stages = len(self.b)


TABLEAUS = {
    "euler": _Tableau(a=[[]], b=[1.0], c=[0.0]),
    "midpoint": _Tableau(a=[[], [0.5]], b=[0.0, 1.0], c=[0.0, 0.5]),
    "rk4": _Tableau(
        a=[[], [0.5], [0.0, 0.5], [0.0, 0.0, 1.0]],
        b=[1 / 6, 1 / 3, 1 / 3, 1 / 6],
        c=[0.0, 0.5, 0.5, 1.0],
    ),
    # Dormand-Prince 5(4), 5th-order weights; the zero-weight FSAL 7th stage
    # is omitted on the fixed grid.
    "dopri5": _Tableau(
        a=[
            [],
            [1 / 5],
            [3 / 40, 9 / 40],
            [44 / 45, -56 / 15, 32 / 9],
            [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
            [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
        ],
        b=[35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
        c=[0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0],
    ),
}


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the tensor leaves of nested tuples/lists/dicts (None kept)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def _axpy(x, h, coefs, ks):
    """x + h * sum_j coefs[j] * ks[j], over nested state."""
    def leaf(xl, *kls):
        acc = xl
        for cj, klj in zip(coefs, kls):
            if cj != 0.0:
                acc = acc + (h * cj) * klj
        return acc

    return tree_map(leaf, x, *ks)


def rk_step(f: Callable, params, t, h, x, tableau: _Tableau):
    """One explicit RK step; returns (x_next, ks) with ks the stage slopes."""
    ks = []
    for i in range(tableau.stages):
        xi = _axpy(x, h, tableau.a[i], ks) if i else x
        ks.append(f(params, t + tableau.c[i] * h, xi))
    return _axpy(x, h, tableau.b, ks), ks


def odeint(f: Callable, params, x0, t0: float, t1: float, steps: int = 16,
           method: str = "dopri5"):
    """Integrate dx/dt = f(params, t, x) from t0 to t1 on a fixed grid
    (t1 < t0 integrates backwards); returns the state at t1."""
    tableau = TABLEAUS[method]
    h = (t1 - t0) / steps
    x = x0
    for i in range(steps):
        x, _ = rk_step(f, params, t0 + i * h, h, x, tableau)
    return x
