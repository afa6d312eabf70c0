"""Plain PyTorch reference of the VMC training iteration that the benchmark
times: a flow-plus-Slater wavefunction of spin-polarised fermions in a 2D
harmonic trap (Xie, Zhang & Wang, J. Mach. Learn. 1(1):38-59, 2022), at
zero temperature or at inverse temperature beta over a truncated set of
Slater states.

It imports nothing of the measured package and takes nothing it made: the
orbital and state tables, the flow, the local energy, the REINFORCE
gradient and Adam are worked out here again.  The inputs it is handed are
the walkers (and at finite T the occupation states) that the measured
sampler drew, which it reads in order to judge what was done with them.

* The flow is dx/dt = v(x), v_i = sum_{j != i} eta(|x_i - x_j|)(x_i - x_j)
  + mu(|x_i|) x_i, eta and mu one-hidden-layer sigmoid MLPs, integrated on
  the fixed dopri5 grid.
* The local energy -1/4 lap logp - 1/8 |grad logp|^2 + V is carried from
  the base point along the flow by the closed ODEs of (logp, grad, Hessian)
  (the field's derivative tensors in closed form, a frozen copy of the
  measured package's plain ``backflow_field_tensors``); the base point's
  derivatives come from the Slater matrix's inverse.
* The REINFORCE gradient is autograd of sum_b w_b logp_theta(x_b), logp by
  the reverse ODE (an independent route: the measured program takes an
  adjoint pass).
* Adam with optax's defaults.

Every function takes its dtype from its inputs.  Every matrix product goes
through ``mm``, which under ``tf32_products()`` rounds its operands, and
in the backward pass the gradient, to TF32's 10-bit mantissa, as the tensor
cores do: the control (``check.py``).  Allowing TF32 in cuBLAS does not
serve, since cuBLAS keeps products this small off the tensor cores.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

DOPRI5_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
]
DOPRI5_B = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]
DOPRI5_C = [0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0]

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
LEAVES = ("w1", "b1", "w2")
_TF32 = [False]


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to the nearest TF32 value (10 mantissa bits)."""
    if x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


class _RoundValue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round_tf32(g)


@contextlib.contextmanager
def tf32_products():
    """Every ``mm`` inside rounds its operands to TF32 (float32 only)."""
    _TF32[0] = True
    try:
        yield
    finally:
        _TF32[0] = False


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b, in TF32 inside ``tf32_products()``."""
    if not _TF32[0]:
        return a @ b
    return _RoundGrad.apply(_RoundValue.apply(a) @ _RoundValue.apply(b))


# ---- orbitals and Slater states ----


def ho2d_tables(num_shells: int = 8):
    """(nx, ny, energies) of the 2D oscillator's orbitals, shell by shell,
    nx rising within a shell."""
    pairs = [(nx, n - nx) for n in range(num_shells) for nx in range(n + 1)]
    nx = np.array([p[0] for p in pairs])
    ny = np.array([p[1] for p in pairs])
    return nx, ny, nx + ny + 1


def slater_states(nup: int, delta_e: float, num_shells: int = 8):
    """(occupations (Nstates, nup), energies): every set of nup orbitals
    whose energy lies within delta_e of the lowest, ordered by energy and,
    within one energy, as the reference code's pruned search lists them."""
    _, _, es = ho2d_tables(num_shells)
    prices = es.tolist()
    pmax = sum(prices[:nup]) + delta_e
    result = (((), 0),)
    for i in range(1, nup + 1):
        grown = []
        for subset, total in result:
            j = subset[-1] + 1 if subset else 0
            while j + nup - i < len(prices):
                if sum(prices[j:j + nup - i + 1]) <= pmax - total:
                    grown.append((subset + (j,), total + prices[j]))
                j += 1
        result = tuple(grown)
    ranked = sorted(result, key=lambda s: s[1])
    return (np.array([s[0] for s in ranked], dtype=np.int64),
            np.array([s[1] for s in ranked], dtype=np.float64))


def _hermite(x: torch.Tensor, num: int):
    """Normalised Hermite factors h_0..h_{num-1} and their first two
    derivatives, each x.shape + (num,): h'_k = sqrt(2k) h_{k-1}."""
    h = [torch.ones_like(x), math.sqrt(2.0) * x]
    for k in range(1, num - 1):
        h.append(math.sqrt(2.0 / (k + 1)) * x * h[k]
                 - math.sqrt(k / (k + 1.0)) * h[k - 1])
    h = torch.stack(h[:num], dim=-1)
    zero = torch.zeros_like(h[..., :1])
    c = torch.sqrt(2.0 * torch.arange(num, dtype=x.dtype, device=x.device))
    d1 = c * torch.cat([zero, h[..., :-1]], dim=-1)
    d2 = c * torch.cat([zero, d1[..., :-1]], dim=-1)
    return h, d1, d2


def slater_vgh(z: torch.Tensor, nx: torch.Tensor, ny: torch.Tensor,
               num: int):
    """log p0 = 2 log|det phi_j(r_i)| of each walker z (B, n, 2), its
    gradient (B, 2n) and Hessian (B, 2n, 2n); walker b occupies the
    orbitals (nx[b, j], ny[b, j]), phi = pi^-1/2 exp(-r^2/2) h_nx h_ny."""
    B, n, _ = z.shape
    hx, dx, ddx = _hermite(z[..., 0], num)
    hy, dy, ddy = _hermite(z[..., 1], num)
    ix = nx[:, None, :].expand(B, n, n)
    iy = ny[:, None, :].expand(B, n, n)
    X = [torch.gather(t, 2, ix) for t in (hx, dx, ddx)]
    Y = [torch.gather(t, 2, iy) for t in (hy, dy, ddy)]
    M = X[0] * Y[0]
    inv = torch.linalg.inv(M)
    # D_a = dM/dr_a (row i depends on particle i alone); B_a = D_a M^-1.
    Bx, By = mm(X[1] * Y[0], inv), mm(X[0] * Y[1], inv)
    Cxx, Cyy, Cxy = (mm(X[2] * Y[0], inv), mm(X[0] * Y[2], inv),
                     mm(X[1] * Y[1], inv))
    diag = lambda t: torch.diagonal(t, dim1=-2, dim2=-1)
    g = torch.stack([diag(Bx), diag(By)], dim=-1) - z  # (B, n, 2)
    blocks = [[Bx, Bx, Cxx], [Bx, By, Cxy]], [[By, Bx, Cxy], [By, By, Cyy]]
    H = torch.empty((B, n, 2, n, 2), dtype=z.dtype, device=z.device)
    eye = torch.eye(n, dtype=z.dtype, device=z.device)
    for a in range(2):
        for b in range(2):
            Ba, Bb, C = blocks[a][b]
            H[:, :, a, :, b] = (eye * diag(C)[:, :, None]
                                - Ba * Bb.transpose(-1, -2)
                                - float(a == b) * eye)
    logabs = torch.linalg.slogdet(M)[1]
    y = logabs - 0.5 * torch.sum(z * z, dim=(-2, -1)) - 0.5 * n * math.log(
        math.pi)
    return 2.0 * y, 2.0 * g.reshape(B, 2 * n), 2.0 * H.reshape(B, 2 * n, 2 * n)


def slater_logp(z: torch.Tensor, nx: torch.Tensor, ny: torch.Tensor,
                num: int) -> torch.Tensor:
    """log p0 alone, differentiable (the reverse ODE's end)."""
    B, n, _ = z.shape
    hx, _, _ = _hermite(z[..., 0], num)
    hy, _, _ = _hermite(z[..., 1], num)
    M = (torch.gather(hx, 2, nx[:, None, :].expand(B, n, n))
         * torch.gather(hy, 2, ny[:, None, :].expand(B, n, n)))
    return 2.0 * (torch.linalg.slogdet(M)[1] - 0.5 * torch.sum(z * z, (-2, -1))
                  - 0.5 * n * math.log(math.pi))


# ---- the flow ----


def _mlp(p: dict, r: torch.Tensor) -> torch.Tensor:
    """w2 . sigmoid(w1 r + b1) at every r (...,)."""
    return mm(torch.sigmoid(mm(r[..., None], p["w1"]) + p["b1"]), p["w2"])[..., 0]


def _mlp_derivs(p: dict, r: torch.Tensor):
    """The MLP's value and first three derivatives in r."""
    w1, w2 = p["w1"][0], p["w2"]
    s = torch.sigmoid(mm(r[..., None], p["w1"]) + p["b1"])
    s1 = s * (1.0 - s)
    s2 = s1 * (1.0 - 2.0 * s)
    s3 = s1 * (1.0 - 2.0 * s) ** 2 - 2.0 * s1 * s1
    return tuple(mm(t, w2)[..., 0] for t in (s, s1 * w1, s2 * w1**2,
                                             s3 * w1**3))


def _pairs(x: torch.Tensor):
    n = x.shape[-2]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    u = x[..., :, None, :] - x[..., None, :, :]
    r = torch.linalg.norm(u + eye[:, :, None], dim=-1)
    return u, r, 1.0 - eye


def velocity_div(p: dict, x: torch.Tensor):
    """(v (B, n, 2), div v (B,)) of the backflow field."""
    u, r, mask = _pairs(x)
    v = torch.sum((_mlp(p["eta"], r) * mask)[..., None] * u, dim=-2)
    e0, e1, _, _ = _mlp_derivs(p["eta"], r)
    div = torch.sum(mask * (e1 * r + 2 * e0), dim=(-2, -1))
    if p.get("mu") is not None:
        rho = torch.linalg.norm(x, dim=-1)
        m0, m1, _, _ = _mlp_derivs(p["mu"], rho)
        v = v + _mlp(p["mu"], rho)[..., None] * x
        div = div + torch.sum(m1 * rho + 2 * m0, dim=-1)
    return v, div


def _block(K: torch.Tensor, eye_n: torch.Tensor) -> torch.Tensor:
    """(..., n, 2, n, 2): off-diagonal blocks -K[i, j], diagonal blocks
    sum_j K[i, j]."""
    return (-torch.movedim(K, -2, -3)
            + torch.einsum("...iab,ik->...iakb", torch.sum(K, dim=-3), eye_n))


def field_tensors(p: dict, x: torch.Tensor, g: torch.Tensor):
    """v, div v, A = dv/dx, grad div v, S = grad^2 div v and T = sum_c g_c
    d^2 v_c / dx dx of the backflow field at x (B, n, 2), g (B, n, 2)."""
    B, n, dim = x.shape
    eye_n = torch.eye(n, dtype=x.dtype, device=x.device)
    I2 = torch.eye(dim, dtype=x.dtype, device=x.device)
    u, r, mask = _pairs(x)
    inv_r = 1.0 / r
    e0, e1, e2, e3 = (e * mask for e in _mlp_derivs(p["eta"], r))
    uu = u[..., :, None] * u[..., None, :]
    v = torch.sum(e0[..., None] * u, dim=-2)
    div = torch.sum(e1 * r + dim * e0, dim=(-2, -1))
    A = _block((e1 * inv_r)[..., None, None] * uu + e0[..., None, None] * I2,
               eye_n)
    phi1 = e2 * r + (dim + 1) * e1
    phi2 = e3 * r + (dim + 2) * e2
    gdiv = torch.sum(2.0 * (phi1 * inv_r)[..., None] * u, dim=-2)
    Phi = ((phi2 * inv_r**2)[..., None, None] * uu
           + phi1[..., None, None] * (inv_r[..., None, None] * I2
                                      - (inv_r**3)[..., None, None] * uu))
    S = _block(2.0 * Phi, eye_n)
    gi = g[..., :, None, :]
    gu = torch.sum(gi * u, dim=-1)
    gs = gi[..., :, None] * u[..., None, :]
    gs = gs + gs.transpose(-1, -2)
    Gq = ((e1 * inv_r)[..., None, None] * (gs + gu[..., None, None] * I2)
          + ((e2 * inv_r**2 - e1 * inv_r**3) * gu)[..., None, None] * uu)
    T = _block(Gq + Gq.transpose(-4, -3), eye_n)
    if p.get("mu") is not None:
        rho = torch.linalg.norm(x, dim=-1)
        irho = 1.0 / rho
        m0, m1, m2, m3 = _mlp_derivs(p["mu"], rho)
        xx = x[..., :, None] * x[..., None, :]
        v = v + m0[..., None] * x
        div = div + torch.sum(m1 * rho + dim * m0, dim=-1)
        psi1 = m2 * rho + (dim + 1) * m1
        psi2 = m3 * rho + (dim + 2) * m2
        gdiv = gdiv + (psi1 * irho)[..., None] * x
        A1 = (m1 * irho)[..., None, None] * xx + m0[..., None, None] * I2
        S1 = ((psi2 * irho**2)[..., None, None] * xx
              + psi1[..., None, None] * (irho[..., None, None] * I2
                                         - (irho**3)[..., None, None] * xx))
        gx = torch.sum(g * x, dim=-1)
        gxs = g[..., :, None] * x[..., None, :]
        gxs = gxs + gxs.transpose(-1, -2)
        G1 = ((m1 * irho)[..., None, None] * (gxs + gx[..., None, None] * I2)
              + ((m2 * irho**2 - m1 * irho**3) * gx)[..., None, None] * xx)
        A = A + torch.einsum("...iab,ik->...iakb", A1, eye_n)
        S = S + torch.einsum("...iab,ik->...iakb", S1, eye_n)
        T = T + torch.einsum("...iab,ik->...iakb", G1, eye_n)
    d = n * dim
    return v, div, gdiv.reshape(B, d), *(t.reshape(B, d, d) for t in (A, S, T))


def _rk(f, state, t0: float, t1: float, steps: int):
    """The fixed-grid dopri5 integration of the tuple ``state``."""
    h = (t1 - t0) / steps
    for i in range(steps):
        ks = []
        for s in range(6):
            xi = state if s == 0 else tuple(
                x + h * sum(a * k[j] for a, k in zip(DOPRI5_A[s], ks) if a)
                for j, x in enumerate(state))
            ks.append(f(xi))
        state = tuple(x + h * sum(b * k[j] for b, k in zip(DOPRI5_B, ks) if b)
                      for j, x in enumerate(state))
    return state


def flow_forward(p: dict, z, y0, g0, H0, steps: int):
    """(x, logp, g, H) at t = 1 from the base point's, along the flow."""
    B, n, _ = z.shape

    def rhs(state):
        x, _, g, H = state
        v, div, gdiv, A, S, T = field_tensors(p, x, g.reshape(B, n, 2))
        At = A.transpose(-1, -2)
        return (v, -div, -(gdiv + mm(At, g[..., None])[..., 0]),
                -(S + T + mm(At, H) + mm(H, A)))

    return _rk(rhs, (z, y0, g0, H0), 0.0, 1.0, steps)


def log_prob(p: dict, x: torch.Tensor, nx, ny, num: int, steps: int):
    """log p_theta(x), by the reverse ODE from x to the base point."""
    def rhs(state):
        v, div = velocity_div(p, state[0])
        return v, -div

    z, dlogp = _rk(rhs, (x, torch.zeros(x.shape[0], dtype=x.dtype,
                                        device=x.device)), 1.0, 0.0, steps)
    return slater_logp(z, nx, ny, num) - dlogp


def potential(x: torch.Tensor, Z: float) -> torch.Tensor:
    """1/2 sum r^2 + Z sum_{i<j} 1/r_ij."""
    _, r, mask = _pairs(x)
    return (0.5 * torch.sum(x * x, dim=(-2, -1))
            + 0.5 * Z * torch.sum(mask / r, dim=(-2, -1)))


# ---- one training iteration ----


class Model:
    """The configuration's static parts: n, Z, ODE steps, the orbitals
    (GS) or the Slater states (finite T, ``beta`` set)."""

    def __init__(self, cfg: dict):
        self.n, self.Z = cfg["nup"], cfg["Z"]
        self.steps, self.lr = cfg["ode_steps"], cfg["lr"]
        self.beta = cfg.get("beta")
        onx, ony, _ = ho2d_tables()
        if self.beta is None:
            occ = np.arange(self.n)[None, :]
            self.energies = np.array([float(np.sum(onx[:self.n] + ony[:self.n]
                                                   + 1))])
        else:
            occ, self.energies = slater_states(self.n, cfg["deltaE"])
        self.nx_tab, self.ny_tab = onx[occ], ony[occ]  # (Nstates, n)
        self.num = int(max(self.nx_tab.max(), self.ny_tab.max())) + 1
        self.nstates = occ.shape[0]

    def qnums(self, states: torch.Tensor):
        """(nx, ny) (B, n) of each walker's state (GS: all in state 0)."""
        dev = states.device
        nx = torch.as_tensor(self.nx_tab, device=dev)[states]
        ny = torch.as_tensor(self.ny_tab, device=dev)[states]
        return nx, ny

    def init_params(self, d_eta: int, d_mu: int, dtype, device) -> dict:
        """The identity flow (every weight 0); at finite T the Boltzmann
        logits -beta (E_s - E_0)."""
        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        p = {f"{m}.{k}": z(*s) for m, h in (("eta", d_eta), ("mu", d_mu))
             for k, s in (("w1", (1, h)), ("b1", (h,)), ("w2", (h, 1)))}
        if self.beta is not None:
            e = torch.as_tensor(self.energies, dtype=dtype, device=device)
            p["logits"] = -self.beta * (e - e[0])
        return p


def _flow(p: dict) -> dict:
    return {m: {k: p[f"{m}.{k}"] for k in LEAVES} for m in ("eta", "mu")}


def local_energy(model: Model, p: dict, z: torch.Tensor, states, block: int):
    """(x, eloc, logp) of walkers z (B, n, 2) in ``states``, in blocks."""
    out = []
    flow = _flow(p)
    with torch.no_grad():
        for lo in range(0, z.shape[0], block):
            zb = z[lo:lo + block]
            nx, ny = model.qnums(states[lo:lo + block])
            y0, g0, H0 = slater_vgh(zb, nx, ny, model.num)
            x, logp, g, H = flow_forward(flow, zb, y0, g0, H0, model.steps)
            lap = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
            eloc = (-0.25 * lap - 0.125 * torch.sum(g * g, -1)
                    + potential(x, model.Z))
            out.append((x, eloc, logp))
    return tuple(torch.cat(t) for t in zip(*out))


def step(model: Model, p: dict, adam: dict, z: torch.Tensor,
         states: torch.Tensor, block: int = 2048):
    """One iteration on walkers z (B, n, 2) in ``states`` (B,): the
    metrics, the gradient, and ``p`` and ``adam`` advanced by one Adam
    step (new dicts).  Returns (metrics, grads, p, adam)."""
    B = z.shape[0]
    x, eloc, logp = local_energy(model, p, z, states, block)
    E = eloc.mean()
    m = {"E": E}
    grads = {}
    if model.beta is None:
        w = (eloc - E) / B
        loss = torch.sum(w * logp)
        scale = eloc.std() * logp.std()
    else:
        lps_all = torch.log_softmax(p["logits"], -1)
        lps = lps_all[states]
        floc = eloc + lps / model.beta
        F = floc.mean()
        c = floc - F
        onehot = torch.nn.functional.one_hot(states, model.nstates).to(z.dtype)
        counts, sums, csums = onehot.sum(0), mm(eloc, onehot), mm(c, onehot)
        # d/dl mean_b log_softmax(l)[s_b] c_b, with sum_b c_b = 0 exactly.
        grads["logits"] = csums / B
        w = (eloc - (sums / counts.clamp_min(1.0))[states]) / B
        loss = torch.mean(lps * c) + torch.sum(w * logp)
        scale = c.std() * lps.std() + B * w.std() * logp.std()
        m.update(F=F, S=-lps.mean(),
                 S_analytical=-torch.sum(lps_all * lps_all.exp()))
    # The most |loss| can be (Cauchy-Schwarz): the scale of its gap.
    m.update(loss=loss, loss_scale=scale)
    flow_keys = [k for k in p if k != "logits"]
    leaves = {k: p[k].detach().clone().requires_grad_(True) for k in flow_keys}
    acc = {k: torch.zeros_like(p[k]) for k in flow_keys}
    for lo in range(0, B, block):
        nx, ny = model.qnums(states[lo:lo + block])
        with torch.enable_grad():
            lp = log_prob(_flow(leaves), x[lo:lo + block], nx, ny, model.num,
                          model.steps)
            gs = torch.autograd.grad(torch.sum(w[lo:lo + block] * lp),
                                     [leaves[k] for k in flow_keys])
        for k, gk in zip(flow_keys, gs):
            acc[k] += gk
    grads.update(acc)
    p, adam = adam_step(p, adam, grads, model.lr)
    return m, grads, p, adam


def adam_step(p: dict, adam: dict, grads: dict, lr: float):
    """Adam (b1 0.9, b2 0.999, eps 1e-8) on every leaf of ``grads``."""
    t = adam.get("t", 0) + 1
    out_p, out_a = dict(p), {"t": t}
    for k, g in grads.items():
        m = ADAM_B1 * adam.get(("m", k), torch.zeros_like(g)) + (1 - ADAM_B1) * g
        v = ADAM_B2 * adam.get(("v", k), torch.zeros_like(g)) + (1 - ADAM_B2) * g * g
        out_a[("m", k)], out_a[("v", k)] = m, v
        mh = m / (1 - ADAM_B1**t)
        vh = v / (1 - ADAM_B2**t)
        out_p[k] = p[k] - lr * mh / (torch.sqrt(vh) + ADAM_EPS)
    return out_p, out_a


def follow(model: Model, p0: dict, inputs: list, block: int = 2048):
    """The first iterations from ``p0`` on each iteration's (z, states):
    {"rows": [metrics...], "grad1": first gradient, "params": after the
    last}, every value a float or a tensor."""
    p, adam, rows, grad1 = p0, {}, [], None
    for z, states in inputs:
        m, g, p, adam = step(model, p, adam, z, states, block)
        rows.append({k: float(v) for k, v in m.items()})
        grad1 = g if grad1 is None else grad1
    return {"rows": rows, "grad1": grad1, "params": p}


# ---- the sampler's statistics ----


def metropolis(model: Model, z: torch.Tensor, states: torch.Tensor,
               tau: torch.Tensor, steps: int, generator: torch.Generator):
    """``steps`` Metropolis steps at fixed per-walker tau, proposals
    z + tau N(0, 1): (z, per-walker acceptance rate)."""
    nx, ny = model.qnums(states)
    logp = slater_logp(z, nx, ny, model.num)
    acc = torch.zeros_like(logp)
    t = tau[:, None, None]
    for _ in range(steps):
        new = z + t * torch.randn(z.shape, generator=generator, dtype=z.dtype,
                                  device=z.device)
        lp_new = slater_logp(new, nx, ny, model.num)
        u = torch.rand(logp.shape, generator=generator, dtype=z.dtype,
                       device=z.device)
        ok = u < torch.exp(lp_new - logp)
        z = torch.where(ok[:, None, None], new, z)
        logp = torch.where(ok, lp_new, logp)
        acc = acc + ok.to(z.dtype)
    return z, acc / steps
