"""Frozen copy of the measured package's hand counts of its kernels' work
(``fermiflow_tpu_torch/utils/roofline.py`` as of the benchmark's first
version), and the published peaks of one H100 SXM.  The benchmark's
roofline shares and ``mfu.step`` divide by these; a later change to the
package's own copy does not move them.

A kernel's bound is the larger of (bytes it must move) / (memory rate) and
(operations) / (FP32 rate): every input read once, every output written
once, and the flop-equivalents the algorithm needs on this call's shapes.
Transcendentals (exp, log, sqrt, sin, cos) count as ~8 flop-equivalents, as
the JAX package's ``bench.py`` counts them; ``sampler_flops`` is a copy of
its ``_sampler_flops``, ``hflow_flops`` its ``_hflow_flops`` with the
Hessian term and the RK combine counted on the packed state (the kernel's
work) instead of a full d x d product and 10d.  Every count is a function of
n, K and the widths, and holds from N = 2 to N = 10 (K = 3 or 4).
The mixed-state kernels do the ground-state sampler's and VGH's work at
K = num_shells and also read each walker's 2n int32 quantum numbers; the
same counts hold for them from N = 2 to N = 10 at every compiled depth,
the finite-T path's N = 10, K = 8 included (the Hermite terms grow with K,
nothing else does).  How an implementation picks the orbitals (selects
over the K orders here, one-hot FMAs on the TPU) and unpacks the quantum
numbers is not counted.
None of these kernels uses the tensor cores, so the FP32 rate is the
denominator.
"""

from __future__ import annotations

__all__ = ["H100_FP32_FLOPS", "H100_BYTES_PER_S", "bound_ms",
           "sampler_flops", "vgh_flops", "hflow_flops", "reinforce_flops",
           "metropolis_work", "metropolis_single_work", "metropolis_ms_work",
           "vgh_work", "vgh_ms_work", "hflow_work", "reinforce_work",
           "reduce_work"]

# Published H100 SXM peaks at the 700 W limit (NVIDIA data sheet): FP32
# outside the tensor cores, and HBM3 bandwidth.
H100_FP32_FLOPS = 67e12
H100_BYTES_PER_S = 3.35e12
F32 = 4


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """(least milliseconds, "operations" or "bytes") for this much work."""
    t_ops = flops / H100_FP32_FLOPS
    t_mem = nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


def sampler_flops(n: int, K: int, dim: int = 2) -> float:
    """Flop-equivalents per walker-step of the Metropolis sampler.

    With d = n*dim: proposal 2d; Box-Muller 17.5d; random-bit plumbing
    4(d+1); Hermite tables 2n(4(K-2)+1); Gaussian prefactor 12n; Slater
    matrix 2n^2; pivoted elimination 1.5n^3 + 8n; accept d + 12.
    """
    d = n * dim
    return (
        2 * d + 17.5 * d + 4 * (d + 1)
        + 2 * n * (4 * max(K - 2, 0) + 1) + 12 * n
        + 2 * n * n + 1.5 * n**3 + 8 * n + d + 12
    )


def vgh_flops(n: int, K: int) -> float:
    """Flop-equivalents per walker of the Slater value/gradient/Hessian.

    Per coordinate (2n of them): Hermite orders 0..K (4 each), Gaussian
    (exp ~8 + 3), psi (K+1), psi' (4K), psi'' (3K).  Factor matrices D,
    D1, D2: 6n^2.  Gauss-Jordan inverse with select pivoting: ~7n^3 (the
    2n-wide elimination, the pivot gathers and the final row selects) plus
    log|pivot| 8n.  B = D1 A contractions: 4n^3.  C contractions: 6n^2.
    Packed Hessian: 3 per entry of d(d+1)/2.
    """
    d = 2 * n
    per_coord = 4 * (K + 1) + 11 + (K + 1) + 7 * K
    return 2 * n * per_coord + 12 * n * n + 11 * n**3 + 8 * n + 1.5 * d * (d + 1)


def hflow_flops(n: int, d_eta: int, d_mu: int, dim: int = 2) -> float:
    """Flop-equivalents per walker per RK stage of the Hessian flow.

    P = n(n-1)/2 pairs, d = n*dim: pair MLP with 4 derivative orders
    P*d_eta*14; one-body MLP n*d_mu*14; A, grad div, S, T assembly
    8d^2 + 20P; dH = -S - T - (AH + HA) on the packed triangle, 2d
    multiply-adds for each of its d(d+1)/2 entries: 2d^2(d+1); dg and
    dlogp 2d^2; the dopri5 stage inputs and combine, ~3.5 multiply-adds
    per state entry (2d + 1 + d(d+1)/2 of them) per stage: 7 per entry.
    """
    d = n * dim
    P = n * (n - 1) // 2
    state = 2 * d + 1 + d * (d + 1) // 2
    mlp = P * d_eta * 14 + (n * d_mu * 14 if d_mu else 0)
    return (mlp + 8 * d * d + 20 * P + 2 * d * d * (d + 1) + 2 * d * d
            + 7 * state)


def reinforce_flops(n: int, d_eta: int, d_mu: int, dim: int = 2) -> float:
    """Flop-equivalents per walker per RK stage of the REINFORCE adjoint.

    Per (pair, hidden unit): sigmoid ~11, its two derivatives 4, the three
    field coefficients 6, the eight theta reductions 16 -> 37; per hidden
    unit the three theta rows ~15; per pair the geometry and adjoint
    dynamics ~40; the one-body term alike over n particles; the dopri5
    stage inputs and combine, 7 per state entry (2d of them).
    """
    d = n * dim
    P = n * (n - 1) // 2
    eta = P * d_eta * 37 + d_eta * 15 + P * 40
    mu = (n * d_mu * 37 + d_mu * 15 + n * 30) if d_mu else 0
    return eta + mu + 14 * d


def metropolis_work(B, n, K, steps, segments):
    """(flops, bytes) of one multi-segment sampler launch (no noise buffers)."""
    d = 2 * n
    flops = B * (segments * steps + 1) * sampler_flops(n, K)
    nbytes = F32 * (B * (d + 1) + segments * B * (d + 2) + B)
    return flops, nbytes


def metropolis_single_work(B, n, K, steps):
    """(flops, bytes) of one fixed-tau chain: x0 and tau in; x, logp and
    the accept rate out."""
    d = 2 * n
    return (B * (steps + 1) * sampler_flops(n, K),
            F32 * (B * (d + 1) + B * (d + 2)))


def metropolis_ms_work(B, n, K, steps):
    """The fixed-tau chain at Hermite depth K with per-walker occupations:
    the (n, B) int32 nx and ny are read as well."""
    flops, nbytes = metropolis_single_work(B, n, K, steps)
    return flops, nbytes + 4 * 2 * n * B


def vgh_work(B, n, K):
    d = 2 * n
    return B * vgh_flops(n, K), F32 * B * (d + 1 + d + d * (d + 1) // 2)


def vgh_ms_work(B, n, K):
    """The Slater VGH at Hermite depth K with per-walker occupations."""
    flops, nbytes = vgh_work(B, n, K)
    return flops, nbytes + 4 * 2 * n * B


def hflow_work(B, n, d_eta, d_mu, steps, stages):
    d = 2 * n
    state = 2 * d + 1 + d * (d + 1) // 2
    weights = 6 * (d_eta + (d_mu or 0))
    return (B * steps * stages * hflow_flops(n, d_eta, d_mu or 0),
            F32 * (2 * B * state + weights))


def reinforce_work(B, n, d_eta, d_mu, steps, stages, nblocks):
    """The adjoint pass: (x, g, w) and the weights in; z and the
    (nblocks, nq) per-block theta partials out."""
    d = 2 * n
    nq = 3 * (d_eta + (d_mu or 0))
    return (B * steps * stages * reinforce_flops(n, d_eta, d_mu or 0),
            F32 * (B * (2 * d + 1) + nq + B * d + nblocks * nq))


def reduce_work(nblocks, nq):
    """The block-order sum of the adjoint's (nblocks, nq) partials."""
    return nblocks * nq, F32 * (nblocks * nq + nq)
