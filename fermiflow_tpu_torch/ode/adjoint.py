"""O(1)-memory continuous-adjoint ODE solve as a ``torch.autograd.Function``
(port of ``fermiflow_tpu/ode/adjoint.py``).

The forward pass saves only the final state; the backward pass reconstructs
the trajectory by integrating the augmented system (x, a_x, a_p) in reverse
time,

    dx/dt   = f(p, t, x)
    da_x/dt = -(∂f/∂x)ᵀ a_x
    da_p/dt = -(∂f/∂p)ᵀ a_x

with the vector-Jacobian products from ``torch.func.vjp``.  The backward is
built from differentiable operations on the saved tensors, so autograd
differentiates it again (grad-of-grad to any order), as the reference's
``create_graph=True`` and JAX's ``custom_vjp`` backward; as JAX does, a
differentiated backward takes the final state's own derivative from the
forward solve (recomputed from the saved x0).  Gradients match the
forward discretization only up to the integration error (the reference's
optimize-then-discretize trade).
"""

from __future__ import annotations

from typing import Callable

import torch

from fermiflow_tpu_torch.ode.integrators import (
    odeint,
    tree_flatten,
    tree_map,
    tree_unflatten,
)

__all__ = ["odeint_adjoint"]


class _OdeintAdjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, *leaves):
        f, t0, t1, steps, method, p_struct, x_struct, n_p = spec
        params = tree_unflatten(p_struct, leaves[:n_p])
        x0 = tree_unflatten(x_struct, leaves[n_p:])
        with torch.no_grad():
            xT = odeint(f, params, x0, t0, t1, steps=steps, method=method)
        xT_leaves = tree_flatten(xT)[0]
        ctx.spec = spec
        ctx.save_for_backward(*leaves, *xT_leaves)
        return tuple(xT_leaves)

    @staticmethod
    def backward(ctx, *ct_xT):
        f, t0, t1, steps, method, p_struct, x_struct, n_p = ctx.spec
        saved = ctx.saved_tensors
        n_x = (len(saved) - n_p) // 2
        p_leaves = saved[:n_p]
        params = tree_unflatten(p_struct, p_leaves)
        if torch.is_grad_enabled():
            # A backward that is itself differentiated (create_graph): take
            # the final state from the forward solve, differentiably, as JAX
            # differentiates the custom_vjp's fwd for higher orders.  (A cotangent
            # that depends on the parameters is differentiated through this
            # backward again, where JAX uses fwd: the two agree up to the
            # integration error there.)
            x0 = tree_unflatten(x_struct, saved[n_p:n_p + n_x])
            xT = odeint(f, params, x0, t0, t1, steps=steps, method=method)
        else:
            xT = tree_unflatten(x_struct, saved[n_p + n_x:])
        ct = tree_unflatten(x_struct, [
            torch.zeros_like(x) if c is None else c
            for c, x in zip(ct_xT, saved[n_p + n_x:])])

        def f_aug(p, t, aug):
            # The vjp runs over the parameter leaves: torch.func takes
            # tensors only, and a parameter dict may hold None.
            x, a_x, _ = aug
            fx, vjp_fn = torch.func.vjp(
                lambda pl, xx: f(tree_unflatten(p_struct, pl), t, xx),
                tree_flatten(p)[0], x)
            vjp_p, vjp_x = vjp_fn(a_x)
            return (fx, tree_map(torch.neg, vjp_x), tree_map(torch.neg, vjp_p))

        a_p0 = [torch.zeros_like(l) for l in p_leaves]
        _, a_x, a_p = odeint(f_aug, params, (xT, ct, a_p0), t1, t0,
                             steps=steps, method=method)
        return (None, *a_p, *tree_flatten(a_x)[0])


def odeint_adjoint(f: Callable, params, x0, t0: float, t1: float,
                   steps: int = 16, method: str = "dopri5"):
    """Like ``odeint`` but with an O(1)-memory adjoint backward pass.

    t0/t1/steps/method are Python numbers; params (a nested dict of tensors,
    None leaves kept) and x0 (a tensor or nested tuple) are differentiable.
    """
    p_leaves, p_struct = tree_flatten(params)
    x_leaves, x_struct = tree_flatten(x0)
    spec = (f, float(t0), float(t1), int(steps), method, p_struct, x_struct,
            len(p_leaves))
    out = _OdeintAdjoint.apply(spec, *p_leaves, *x_leaves)
    return tree_unflatten(x_struct, out)
