"""Batched value/gradient/Laplacian engine for local-energy estimation
(port of ``fermiflow_tpu/vmc/local_energy.py``).

The nested-jvp engine: per walker and per basis direction e of the 2n·dim
coordinates, two nested forward-mode derivatives give (grad f · e, eᵀ H e);
``torch.func.vmap`` maps them over the directions and the walkers, so the
Laplacian of log p through the reverse ODE is one batched forward
computation, with no tape.  The Hessian-flow engine (``vmc/hessian_flow.py``)
is the production path; this one needs only ``log_prob``.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import grad, jacfwd, jvp, vmap

__all__ = ["y_grad_laplacian", "divergence_fwd"]


def y_grad_laplacian(f_single: Callable, x: torch.Tensor, *args,
                     chunk_size: int | None = None, mode: str = "fwdfwd"):
    """Value, gradient and Laplacian of a per-walker scalar function.

    Args:
      f_single: (xs, *a) -> scalar, xs of shape (n, dim).
      x: (batch, n, dim) walker positions.
      *args: optional extra per-walker tensors (leading batch axis), e.g. the
        finite-temperature per-walker state index.
      chunk_size: if set, process the batch in sequential chunks of this size
        (the JAX ``lax.map``), bounding live memory by the chunk.  The batch
        must be divisible by it.
      mode: "fwdfwd" (default), nested forward mode over the 2n·dim basis
        directions; "fwdrev", ``jacfwd`` of ``grad`` (a cross-check that
        needs f reverse-differentiable).

    Returns:
      (y, grad_y, lap_y) with shapes (batch,), (batch, n, dim), (batch,).
    """
    n, dim = x.shape[-2:]
    d = n * dim

    def single_fwdfwd(xs, *a):
        xf = xs.reshape(d)

        def f_flat(v):
            return f_single(v.reshape(n, dim), *a)

        eye = torch.eye(d, dtype=xs.dtype, device=xs.device)

        def dir2(e):
            # First jvp: g_e = grad f · e; its jvp along e gives eᵀ H e.
            g_fn = lambda v: jvp(f_flat, (v,), (e,))[1]
            return jvp(g_fn, (xf,), (e,))

        g, hdiag = vmap(dir2)(eye)
        return f_flat(xf), g.reshape(n, dim), hdiag.sum()

    def single_fwdrev(xs, *a):
        xf = xs.reshape(d)

        def f_flat(v):
            return f_single(v.reshape(n, dim), *a)

        g = grad(f_flat)(xf)
        H = jacfwd(grad(f_flat))(xf)
        return f_flat(xf), g.reshape(n, dim), torch.trace(H)

    if mode not in ("fwdfwd", "fwdrev"):
        raise ValueError(f"mode must be 'fwdfwd' or 'fwdrev', got {mode!r}")
    batched = vmap(single_fwdfwd if mode == "fwdfwd" else single_fwdrev)
    batch = x.shape[0]
    if chunk_size is None or batch <= chunk_size:
        return batched(x, *args)
    if batch % chunk_size:
        raise ValueError(f"batch {batch} not divisible by chunk {chunk_size}")
    outs = [batched(x[lo:lo + chunk_size],
                    *(a[lo:lo + chunk_size] for a in args))
            for lo in range(0, batch, chunk_size)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def divergence_fwd(v_single: Callable, x: torch.Tensor, *args) -> torch.Tensor:
    """Divergence tr(dv/dx) of a per-walker vector field by forward mode.

    v_single: (xs, *a) -> (n, dim); x: (batch, n, dim).  Returns (batch,).
    """
    n, dim = x.shape[-2:]
    d = n * dim

    def single(xs, *a):
        def v_flat(vf):
            return v_single(vf.reshape(n, dim), *a).reshape(d)

        return torch.trace(jacfwd(v_flat)(xs.reshape(d)))

    return vmap(single)(x, *args)
