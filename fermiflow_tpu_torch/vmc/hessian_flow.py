"""Hessian-flow local energy (port of ``fermiflow_tpu/vmc/hessian_flow.py``).

Along the generative flow dx/dt = v(x) the log-density and its derivatives
obey closed ODEs:

    d logp / dt = -div v
    d g    / dt = -grad(div v) - A^T g
    d H    / dt = -grad^2(div v) - (grad^2 v).g - A^T H - H A

so one forward integration of (x, logp, g, H) from the base sample gives the
kinetic energy -1/4 tr H - 1/8 |g|^2 at x(t1).  ``hessian_flow`` here is the
plain version of the Hessian-flow kernel (``ops/hessian_flow.py``).
The base point's (logp, grad, Hessian) comes from a closed form
(``FreeFermion.log_prob_vgh``) or, without one, from nested autodiff
(``base_val_grad_hess``).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import grad, jacfwd, vmap

from fermiflow_tpu_torch.ode import odeint

__all__ = ["base_val_grad_hess", "hessian_flow", "local_energy_flow"]


def base_val_grad_hess(logp_single: Callable, z: torch.Tensor, *args):
    """(logp, grad, Hessian) of the base log-density at z, per walker, by
    ``jacfwd`` of ``grad`` mapped over the batch.

    logp_single: (z_single, *a) -> scalar, z_single of shape (n, dim).
    z: (batch, n, dim); *args: per-walker extras (leading batch axis).
    Returns (y, g, H) of shapes (batch,), (batch, nd), (batch, nd, nd).
    """
    n, dim = z.shape[-2:]
    nd = n * dim

    def single(zs, *a):
        f = lambda v: logp_single(v.reshape(n, dim), *a)
        zf = zs.reshape(nd)
        return f(zf), grad(f)(zf), jacfwd(grad(f))(zf)

    return vmap(single)(z, *args)


def hessian_flow(field_tensors: Callable, params, z: torch.Tensor,
                 y0: torch.Tensor, g0: torch.Tensor, H0: torch.Tensor,
                 t0: float, t1: float, steps: int = 16,
                 method: str = "dopri5"):
    """Integrate the augmented (x, logp, g, H) system from t0 to t1.

    z (batch, n, dim); y0 (batch,); g0 (batch, nd); H0 (batch, nd, nd).
    Returns (x, logp, g, H) at t1 with the same shapes.
    """
    n, dim = z.shape[-2:]

    def rhs(p, t, state):
        x, _, g, H = state
        ft = field_tensors(p, x, g.reshape(g.shape[:-1] + (n, dim)))
        A = ft["A"]
        At_g = torch.einsum("...ca,...c->...a", A, g)
        AtH = torch.einsum("...ca,...cb->...ab", A, H)
        HA = H @ A
        return (ft["v"], -ft["div"], -(ft["gdiv"] + At_g),
                -(ft["S"] + ft["T"] + AtH + HA))

    return odeint(rhs, params, (z, y0, g0, H0), t0, t1, steps=steps,
                  method=method)


def local_energy_flow(field_tensors: Callable, base_vgh: Callable | None,
                      potential: Callable, params, z: torch.Tensor,
                      t0: float, t1: float, steps: int = 16,
                      method: str = "dopri5", return_grad: bool = False,
                      base_logp_single: Callable | None = None):
    """Per-walker (x, eloc, logp[, g]) from base samples z (batch, n, dim).

    ``base_vgh(z) -> (y0, g0, H0)`` is the closed-form base evaluation
    (``FreeFermion.log_prob_vgh``); when it is None, the nested autodiff
    ``base_val_grad_hess`` of ``base_logp_single`` ((n, dim) -> scalar)
    takes its place, as in the JAX function.
    """
    if base_vgh is not None:
        y0, g0, H0 = base_vgh(z)
    elif base_logp_single is not None:
        y0, g0, H0 = base_val_grad_hess(base_logp_single, z)
    else:
        raise ValueError("local_energy_flow needs base_vgh or "
                         "base_logp_single")
    x, logp, g, H = hessian_flow(field_tensors, params, z, y0, g0, H0,
                                 t0, t1, steps=steps, method=method)
    lap = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
    eloc = -0.25 * lap - 0.125 * torch.sum(g**2, dim=-1) + potential(x)
    if return_grad:
        return x, eloc, logp, g
    return x, eloc, logp
