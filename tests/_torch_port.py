"""Shared inputs for the tests that hold ``fermiflow_tpu_torch`` against the
JAX package: seeded numpy data handed to both, and conversions between the
two parameter layouts (the same ``{"eta": mlp, "mu": mlp | None}`` dict)."""

import numpy as np
import torch

import jax.numpy as jnp

from fermiflow_tpu_torch.nn.backflow import params_from_jax, params_to_numpy

LEAVES = ("w2", "w1", "b1")


def np_params(seed, d_eta=8, d_mu=8, std=0.3, dtype=np.float64):
    """Gaussian backflow parameters (std 0.3: the flow is far from identity)."""
    rng = np.random.default_rng(seed)

    def mlp(h):
        return {
            "w1": (std * rng.standard_normal((1, h))).astype(dtype),
            "b1": (std * rng.standard_normal((h,))).astype(dtype),
            "w2": (std * rng.standard_normal((h, 1))).astype(dtype),
        }

    return {"eta": mlp(d_eta), "mu": None if d_mu is None else mlp(d_mu)}


def jax_params(p, dtype=None):
    def conv(m):
        if m is None:
            return None
        return {k: jnp.asarray(v if dtype is None else v.astype(dtype))
                for k, v in m.items()}

    return {"eta": conv(p["eta"]), "mu": conv(p["mu"])}


def torch_params(p, dtype=torch.float64):
    return params_from_jax(p, dtype=dtype)


def flat_np(grads):
    """Gradient dict (either package) -> one float64 vector, fixed order."""
    out = []
    for m in ("eta", "mu"):
        if grads.get(m) is None:
            continue
        for k in LEAVES:
            out.append(np.asarray(grads[m][k], np.float64).ravel())
    return np.concatenate(out)


def flat_torch(grads):
    return flat_np(params_to_numpy(grads))


def walkers(seed, B, n, dim=2, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal((B, n, dim)).astype(dtype)
