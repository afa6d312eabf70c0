"""One-hidden-layer scalar MLP over a parameter dict (port of ``fermiflow_tpu/nn/mlp.py``).

Parameters are ``{"w1": (d_in, h), "b1": (h,), "w2": (h, 1)}`` tensors, the
JAX pytree layout.  Matmuls run in full float32/float64 (TF32 is off, see the
package ``__init__``).
"""

from __future__ import annotations

import torch

__all__ = [
    "mlp_init_zeros",
    "mlp_init_gaussian",
    "mlp_apply",
    "mlp_grad",
    "mlp_derivs3",
]


def mlp_init_zeros(d_in: int, d_hidden: int, dtype=torch.float64,
                   device=None) -> dict:
    """All-zero init: the induced flow starts as the identity."""
    kw = dict(dtype=dtype, device=device)
    return {
        "w1": torch.zeros((d_in, d_hidden), **kw),
        "b1": torch.zeros((d_hidden,), **kw),
        "w2": torch.zeros((d_hidden, 1), **kw),
    }


def mlp_init_gaussian(generator: torch.Generator, d_in: int, d_hidden: int,
                      std: float = 1e-3, dtype=torch.float64,
                      device=None) -> dict:
    """Seeded Gaussian init (reference std 1e-3)."""
    kw = dict(dtype=dtype, device=device, generator=generator)
    return {
        "w1": std * torch.randn((d_in, d_hidden), **kw),
        "b1": std * torch.randn((d_hidden,), **kw),
        "w2": std * torch.randn((d_hidden, 1), **kw),
    }


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """(..., d_in) -> (..., 1): w2 . sigmoid(x w1 + b1)."""
    h = torch.sigmoid(x @ params["w1"] + params["b1"])
    return h @ params["w2"]


def mlp_derivs3(params: dict, r: torch.Tensor):
    """Value and first three derivatives of the scalar-input MLP at r (...,).

    With s = sigmoid(w1 r + b1): s' = s(1-s), s'' = s'(1-2s),
    s''' = s'(1-2s)^2 - 2 s'^2, and y^(k) = (w1^k s^(k)) . w2.
    """
    w1 = params["w1"][0]
    w2 = params["w2"][:, 0]
    s = torch.sigmoid(r[..., None] * w1 + params["b1"])
    s1 = s * (1.0 - s)
    s2 = s1 * (1.0 - 2.0 * s)
    s3 = s1 * (1.0 - 2.0 * s) ** 2 - 2.0 * s1 * s1
    return (
        s @ w2,
        (s1 * w1) @ w2,
        (s2 * w1**2) @ w2,
        (s3 * w1**3) @ w2,
    )


def mlp_grad(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Analytic d(mlp)/dx: (..., d_in) -> (..., d_in)."""
    s = torch.sigmoid(x @ params["w1"] + params["b1"])
    return (s * (1.0 - s) * params["w2"][:, 0]) @ params["w1"].T
