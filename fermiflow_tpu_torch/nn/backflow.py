"""Permutation-equivariant backflow velocity field with analytic divergence
(port of ``fermiflow_tpu/nn/backflow.py``).

Parameters keep the JAX pytree layout,
``{"eta": {w1 (1,h), b1 (h,), w2 (h,1)}, "mu": same or None}``; the
``Backflow`` module owns them as ``nn.Parameter``s so ``torch.optim.Adam``
can update them, and ``Backflow.params()`` hands out that dict view.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from fermiflow_tpu_torch.nn.mlp import (
    mlp_apply,
    mlp_grad,
    mlp_init_gaussian,
    mlp_init_zeros,
)

__all__ = [
    "Backflow",
    "backflow_init_zeros",
    "backflow_init_gaussian",
    "backflow_apply",
    "backflow_divergence",
    "params_from_jax",
    "params_to_numpy",
]

_LEAVES = ("w1", "b1", "w2")


class Backflow(nn.Module):
    """Holder of the eta (two-body) and optional mu (one-body) MLP weights."""

    def __init__(self, params: dict):
        super().__init__()
        self.eta = nn.ParameterDict(
            {k: nn.Parameter(params["eta"][k].detach().clone()) for k in _LEAVES})
        mu = params.get("mu")
        self.mu = None if mu is None else nn.ParameterDict(
            {k: nn.Parameter(mu[k].detach().clone()) for k in _LEAVES})

    def params(self) -> dict:
        """The parameters as the JAX-layout dict (live views, not copies)."""
        return {
            "eta": {k: self.eta[k] for k in _LEAVES},
            "mu": None if self.mu is None else {k: self.mu[k] for k in _LEAVES},
        }


def backflow_init_zeros(d_eta: int, d_mu: int | None = None,
                        dtype=torch.float64, device=None) -> dict:
    """Identity-flow init (both reference drivers use this)."""
    return {
        "eta": mlp_init_zeros(1, d_eta, dtype=dtype, device=device),
        "mu": None if d_mu is None
        else mlp_init_zeros(1, d_mu, dtype=dtype, device=device),
    }


def backflow_init_gaussian(generator: torch.Generator, d_eta: int,
                           d_mu: int | None = None, std: float = 1e-3,
                           dtype=torch.float64, device=None) -> dict:
    kw = dict(std=std, dtype=dtype, device=device)
    return {
        "eta": mlp_init_gaussian(generator, 1, d_eta, **kw),
        "mu": None if d_mu is None else mlp_init_gaussian(generator, 1, d_mu, **kw),
    }


def params_from_jax(params_np: dict, dtype=None, device=None) -> dict:
    """JAX-package parameters (as numpy arrays) -> the port's tensor dict."""
    def conv(p):
        if p is None:
            return None
        return {k: torch.as_tensor(np.asarray(p[k]), dtype=dtype, device=device)
                for k in _LEAVES}

    return {"eta": conv(params_np["eta"]), "mu": conv(params_np.get("mu"))}


def params_to_numpy(params: dict) -> dict:
    """The port's parameter (or gradient) dict -> numpy arrays, JAX layout."""
    def conv(p):
        if p is None:
            return None
        return {k: p[k].detach().cpu().numpy() for k in _LEAVES}

    return {"eta": conv(params["eta"]), "mu": conv(params.get("mu"))}


def _pair_geometry(x: torch.Tensor):
    """rij with identity-offset-safe diagonal, distances, identity."""
    n = x.shape[-2]
    rij = x[..., :, None, :] - x[..., None, :, :]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    rij_safe = rij + eye[..., :, :, None]
    dij = torch.linalg.norm(rij_safe, dim=-1, keepdim=True)
    return rij_safe, dij, eye


def backflow_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Velocity v(x): (..., n, dim) -> (..., n, dim)."""
    rij_safe, dij, eye = _pair_geometry(x)
    mask = (1.0 - eye)[..., :, :, None]
    v = torch.sum(mask * mlp_apply(params["eta"], dij) * rij_safe, dim=-2)
    if params.get("mu") is not None:
        di = torch.linalg.norm(x, dim=-1, keepdim=True)
        v = v + mlp_apply(params["mu"], di) * x
    return v


def backflow_divergence(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Analytic div v: (..., n, dim) -> (...,)."""
    dim = x.shape[-1]
    _, dij, eye = _pair_geometry(x)
    mask = (1.0 - eye)[..., :, :, None]
    eta = mlp_apply(params["eta"], dij)
    d_eta = mlp_grad(params["eta"], dij)
    div = torch.sum(mask * (d_eta * dij + dim * eta), dim=(-3, -2, -1))
    if params.get("mu") is not None:
        di = torch.linalg.norm(x, dim=-1, keepdim=True)
        mu = mlp_apply(params["mu"], di)
        d_mu = mlp_grad(params["mu"], di)
        div = div + torch.sum(d_mu * di + dim * mu, dim=(-2, -1))
    return div
