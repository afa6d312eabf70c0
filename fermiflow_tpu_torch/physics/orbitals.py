"""Single-particle orbitals of the 2D isotropic harmonic oscillator.

Port of ``fermiflow_tpu/physics/orbitals.py``: the normalized Hermite
recurrence evaluated as one batched tensor op, and the host-side ``_subsets``
state enumeration (own copy, same state order).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

__all__ = ["hermite_functions", "HO2D"]


def hermite_functions(x: torch.Tensor, num: int) -> torch.Tensor:
    """Normalized 1D HO polynomial factors h_0..h_{num-1}: ``x.shape + (num,)``.

    h_0 = 1, h_1 = sqrt(2) x, h_{n+1} = sqrt(2/(n+1)) x h_n - sqrt(n/(n+1)) h_{n-1}.
    """
    if num < 1:
        raise ValueError("num must be >= 1")
    hs = [torch.ones_like(x)]
    if num > 1:
        hs.append(float(np.sqrt(2.0)) * x)
    for n in range(1, num - 1):
        hs.append(
            float(np.sqrt(2.0 / (n + 1))) * x * hs[n]
            - float(np.sqrt(n / (n + 1.0))) * hs[n - 1]
        )
    return torch.stack(hs, dim=-1)


def _subsets(k: int, pmax: float, prices: list) -> tuple[tuple, tuple]:
    """All index-subsets of length k with total price <= pmax, sorted by price.

    Same pruned DP as the reference (``src/orbitals.py:14-31``).
    """
    n_elements = len(prices)
    result = (((), 0),)
    for i in range(1, k + 1):
        result_new = []
        for subset, ptotal in result:
            next_idx = subset[-1] + 1 if subset else 0
            while next_idx + k - i < n_elements:
                if sum(prices[next_idx : next_idx + k - i + 1]) <= pmax - ptotal:
                    result_new.append(
                        (subset + (next_idx,), ptotal + prices[next_idx])
                    )
                next_idx += 1
        result = tuple(result_new)
    indices, ptotals = zip(*sorted(result, key=lambda ip: ip[1]))
    return indices, ptotals


class HO2D:
    """2D harmonic-oscillator orbital set.

    Attributes:
      nx, ny: (num_orbitals,) int arrays of 1D quantum numbers, ordered as
        ``[(nx, n - nx) for n in range(num_shells) for nx in range(n + 1)]``.
      Es: (num_orbitals,) orbital energies n + 1.
    """

    def __init__(self, num_shells: int = 8):
        self.num_shells = num_shells
        pairs = [(nx, n - nx) for n in range(num_shells) for nx in range(n + 1)]
        self.nx = np.array([p[0] for p in pairs], dtype=np.int32)
        self.ny = np.array([p[1] for p in pairs], dtype=np.int32)
        self.Es = np.array(
            [n + 1 for n in range(num_shells) for _ in range(n + 1)], dtype=np.int32
        )
        self.num_orbitals = len(pairs)

    def E_indices(self, n: int) -> tuple:
        """Orbital indices of shell n."""
        return tuple(range(n * (n + 1) // 2, (n + 1) * (n + 2) // 2))

    def eval_orbitals(self, orb_indices, x: torch.Tensor) -> torch.Tensor:
        """phi_m(r) = pi^{-1/2} exp(-r^2/2) h_{nx_m}(x) h_{ny_m}(y) for a static
        subset of orbitals: (..., 2) -> (..., len(orb_indices))."""
        orb_indices = np.asarray(orb_indices, dtype=np.int64)
        gauss = torch.exp(-0.5 * torch.sum(x**2, dim=-1)) * float(1 / np.sqrt(np.pi))
        hx = hermite_functions(x[..., 0], self.num_shells)
        hy = hermite_functions(x[..., 1], self.num_shells)
        ix = torch.as_tensor(self.nx[orb_indices], dtype=torch.long, device=x.device)
        iy = torch.as_tensor(self.ny[orb_indices], dtype=torch.long, device=x.device)
        return gauss[..., None] * hx[..., ix] * hy[..., iy]

    def fermion_states(self, nup: int, ndown: int, deltaE: float):
        """Spin-polarized Slater states with excitation <= deltaE, by energy."""
        if ndown != 0:
            raise ValueError("Only the polarized case (ndown = 0) is supported.")
        E0 = float(np.sum(self.Es[:nup]))
        indices, Es = _subsets(nup, E0 + deltaE, self.Es.tolist())
        return np.array(indices, dtype=np.int32), np.array(Es, dtype=np.float64)

    def fermion_states_naive(self, nup: int, ndown: int, deltaE: float):
        """Exhaustive-search cross-check of ``fermion_states``."""
        if ndown != 0:
            raise ValueError("Only the polarized case (ndown = 0) is supported.")
        E0 = int(np.sum(self.Es[:nup]))
        states = [
            (idx, sum(E))
            for idx, E in zip(
                itertools.combinations(range(self.num_orbitals), nup),
                itertools.combinations(self.Es.tolist(), nup),
            )
            if sum(E) <= E0 + deltaE
        ]
        states.sort(key=lambda s: s[1])
        occ = np.array([s[0] for s in states], dtype=np.int32)
        return occ, np.array([s[1] for s in states], dtype=np.float64)
