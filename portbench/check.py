"""How a run's ``correct`` is decided: the numbers compared, each against a
limit of its own (``workloads/<cell>.json``), set from readings of sound
runs and of the control (PERF.md).

The iteration that closed the window, a replay of the captured chunk at
the parameters the run trained (``harness.last_iteration``): from the
state after it, the step it took is undone (Adam's update from its
moments and step count; the moments less the gradient each leaf handed
the optimizer), and the reference (``reference.py``, float64) runs that
iteration again from there, on the walkers (and states) it ran on:

* ``trained_E_rel`` (and at finite T ``trained_F_rel``,
  ``trained_S_rel``): the row's value against the reference's, relative;
* ``trained_loss_gap``: the row's surrogate loss against the reference's,
  over the most it could be, std(weights) std(log-density)
  (Cauchy-Schwarz), since the loss itself passes through 0;
* ``trained_grad_f32x``: the gradient the optimizer got, worst leaf:
  |norm(program) - norm(reference)| / max(norm(reference), the median
  leaf's), as a multiple of the same gap of the reference itself run in
  plain float32 on the same inputs (at least ``F32_FLOOR``): how far the
  program falls short of what float32 resolves on this batch.  A walker
  by a node of the determinant, whose two kinetic terms, each ~1/d^2,
  cancel in its local energy, makes both gaps swing a thousandfold from
  batch to batch, and their ratio stays within ~0.3-7 (PERF.md);
* ``adam_steps``: Adam's step count against the row's iteration number,
  on every leaf (exact).

At K = 1, where every iteration is a chunk of its own, the reference also
follows the first three iterations from the configuration's initial
parameters and its own Adam (``harness.FirstSteps``):

* ``E_rel`` (and ``F_rel``, ``S_rel``), ``loss_gap``: as above, the
  largest over the three rows;
* ``grad1_leaf``: the gradient Adam took at the first iteration (its first
  moment after one step over 1 - b1), worst leaf;
* ``change3_leaf``: the parameters' change over the three iterations,
  worst leaf.

A leaf whose reference gradient or change is under a thousandth of the
median nonzero leaf's (the identity flow's first layers at the first
iteration: their gradient is 0 through w2 = 0) is left out, and reads 1
if the program moves it by more than that.

From the state when the run ended, the sampler:

* ``r2_sems``: persistent walkers sit in the Slater densities, where the
  virial theorem gives mean sum r^2 = each walker's state energy; fresh
  walkers are compared with the reference's own chains, drawn from the
  same protocol with its own generator.  In standard errors.
* ``accept_sems``: the last iteration's acceptance against the
  reference's Metropolis acceptance on the same walkers (persistent: 30
  steps from the program's walkers at their tau) or the same protocol
  (fresh).  In standard errors.
"""

from __future__ import annotations

import math
import statistics

import torch

import reference

FIRST_KEYS = ("E",)
FINITE_KEYS = ("F", "S")
# The float32 reference's gap that ``trained_grad_f32x`` counts at least: a
# batch that float32 resolves better by chance does not blow the ratio up.
F32_FLOOR = 1e-5


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """Each leaf's |norm(prog) - norm(ref)| / max(norm(ref), the median
    leaf's norm); a leaf under a thousandth of the median nonzero one reads
    1 where the program's is not under it too, else 0."""
    rn = {k: float(ref[k].double().norm()) for k in ref}
    pn = {k: float(prog[k].double().norm()) for k in ref}
    med = statistics.median(rn.values())
    floor = 1e-3 * statistics.median([v for v in rn.values() if v > 0])
    return {k: (float(pn[k] >= floor) if rn[k] < floor
                else abs(pn[k] - rn[k]) / max(rn[k], med)) for k in rn}


def leaf_gap(prog: dict, ref: dict) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(prog, ref).values())


def reference_inputs(inputs: list, n: int, dtype, device) -> list:
    """The program's (z_cm (2n, B), states) as the reference takes them:
    (z (B, n, 2), states (B,) long; all 0 for the ground state)."""
    out = []
    for z_cm, states in inputs:
        B = z_cm.shape[1]
        z = z_cm.T.reshape(B, n, 2).to(device=device, dtype=dtype)
        s = (torch.zeros(B, dtype=torch.long, device=device) if states is None
             else states.to(device=device, dtype=torch.long))
        out.append((z, s))
    return out


def first_numbers(c: dict, rows: list, grad1: dict, change: dict,
                  ref: dict, ref_change: dict) -> dict:
    keys = FIRST_KEYS + (FINITE_KEYS if c["kind"] == "finite_t" else ())
    out = {f"{k}_rel": max(abs(p[k] - r[k]) / abs(r[k])
                           for p, r in zip(rows, ref["rows"]))
           for k in keys}
    out["loss_gap"] = max(abs(p["loss"] - r["loss"]) / r["loss_scale"]
                          for p, r in zip(rows, ref["rows"]))
    out["grad1_leaf"] = leaf_gap(grad1, ref["grad1"])
    out["change3_leaf"] = leaf_gap(change, ref_change)
    return out


def follow_reference(c: dict, inputs: list, dtype, device, halve=False):
    """The reference's three iterations from the configuration's initial
    parameters, on the program's walkers (``halve``: on the first half of
    them alone, a planted fault)."""
    model = reference.Model(c)
    p0 = model.init_params(c["d_eta"], c["d_mu"], dtype, device)
    ins = reference_inputs(inputs, c["nup"], dtype, device)
    if halve:
        ins = [(z[:z.shape[0] // 2], s[:s.shape[0] // 2]) for z, s in ins]
    out = reference.follow(model, p0, ins)
    return out, {k: out["params"][k] - p0[k] for k in p0}


def sampler_numbers(c: dict, final: dict, seed: int, device) -> dict:
    model = reference.Model(c)
    gen = torch.Generator(device).manual_seed(seed % (2**63) ^ 0x5EED)
    z = final["z"].to(device=device, dtype=torch.float64)
    B = z.shape[0]
    states = (torch.zeros(B, dtype=torch.long, device=device)
              if final["states"] is None
              else final["states"].to(device=device, dtype=torch.long))
    r2 = torch.sum(z * z, dim=(-2, -1))
    if c["persistent_walkers"]:
        dev = r2 - torch.as_tensor(model.energies, dtype=z.dtype,
                                   device=device)[states]
        r2_sems = abs(float(dev.mean())) / (float(dev.std()) / math.sqrt(B))
        _, acc = reference.metropolis(model, z, states,
                                      final["tau"].to(device, z.dtype),
                                      c["mcmc_steps"], gen)
    else:
        z0 = torch.randn(z.shape, generator=gen, dtype=z.dtype, device=device)
        zr, acc = reference.metropolis(
            model, z0, states, torch.full((B,), c["tau"], dtype=z.dtype,
                                          device=device),
            c["equilibrium_steps"], gen)
        r2r = torch.sum(zr * zr, dim=(-2, -1))
        r2_sems = abs(float(r2.mean() - r2r.mean())) / math.sqrt(
            (float(r2.var()) + float(r2r.var())) / B)
    accept_sems = abs(final["accept"] - float(acc.mean())) / (
        float(acc.std()) * math.sqrt(2.0 / B))
    return {"r2_sems": r2_sems, "accept_sems": accept_sems}


def undo_step(snap: dict, lr: float, device):
    """(parameters, Adam's state) before the step of the iteration that
    ``snap`` (``harness.last_iteration``) read, in float64: Adam's update
    undone from the moments and step count after it, and the moments less
    the gradient that the step took."""
    b1, b2, eps = reference.ADAM_B1, reference.ADAM_B2, reference.ADAM_EPS
    f64 = lambda t: t.to(device=device, dtype=torch.float64)
    t = max(snap["steps"].values())
    p, adam = {}, {"t": int(t) - 1}
    for k, theta in snap["theta"].items():
        g, m, v = (f64(snap[x][k]) if snap[x][k] is not None
                   else torch.zeros_like(f64(theta)) for x in ("grad", "m", "v"))
        if t > 0:
            vh = v / (1 - b2**t)
            p[k] = f64(theta) + lr * (m / (1 - b1**t)) / (vh.sqrt() + eps)
        else:
            p[k] = f64(theta)
        adam[("m", k)] = (m - (1 - b1) * g) / b1
        adam[("v", k)] = torch.clamp((v - (1 - b2) * g * g) / b2, min=0.0)
    return p, adam


def rerun(c: dict, snap: dict, dtype, device, halve=False):
    """The reference's run of the judged iteration in ``dtype``: (row,
    gradient) (``halve``: on the first half of its walkers alone, a planted
    fault)."""
    model = reference.Model(c)
    p, adam = undo_step(snap, c["lr"], device)
    (z, s), = reference_inputs([(snap["z_cm"], snap["states"])], c["nup"],
                               dtype, device)
    if halve:
        z, s = z[:z.shape[0] // 2], s[:s.shape[0] // 2]
    p = {k: v.to(dtype) for k, v in p.items()}
    m, grads, _, _ = reference.step(model, p, adam, z, s)
    return {k: float(v) for k, v in m.items()}, grads


def rerun_f32(c: dict, snap: dict, device) -> dict:
    """The reference's gradient of the judged iteration in plain float32,
    with TF32 off wherever PyTorch could take it."""
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        return rerun(c, snap, torch.float32, device)[1]
    finally:
        for f, s in zip(flags, saved):
            f.allow_tf32 = s


def trained_numbers(c: dict, row: dict, grad: dict, ref_row: dict,
                    ref_grad: dict, f32_grad: dict) -> dict:
    keys = FIRST_KEYS + (FINITE_KEYS if c["kind"] == "finite_t" else ())
    out = {f"trained_{k}_rel": abs(row[k] - ref_row[k]) / abs(ref_row[k])
           for k in keys}
    out["trained_loss_gap"] = (abs(row["loss"] - ref_row["loss"])
                               / ref_row["loss_scale"])
    out["trained_grad_f32x"] = leaf_gap(grad, ref_grad) / max(
        leaf_gap(f32_grad, ref_grad), F32_FLOOR)
    return out


def judge_trained(c: dict, snap: dict, device) -> dict:
    """The numbers of the iteration that closed the window."""
    ref_row, ref_grad = rerun(c, snap, torch.float64, device)
    grad = {k: (torch.zeros_like(snap["theta"][k]) if g is None else g)
            for k, g in snap["grad"].items()}
    out = trained_numbers(c, snap["row"], grad, ref_row, ref_grad,
                          rerun_f32(c, snap, device))
    out["adam_steps"] = max(abs(t - snap["row"]["step"])
                            for t in snap["steps"].values())
    return out


def judge(c: dict, first, rows: list, snap: dict, final: dict, seed: int,
          device) -> dict:
    """Every number compared, for a run whose window closed on the
    iteration ``snap`` read, which ended on ``final``, and (at K = 1) whose
    first iterations ``first`` (``harness.FirstSteps``) and rows ``rows``
    were read."""
    out = judge_trained(c, snap, device)
    if first is not None:
        ref, ref_change = follow_reference(c, first.inputs, torch.float64,
                                           device)
        change = {k: first.theta3[k] - first.theta0[k] for k in first.theta0}
        out.update(first_numbers(c, rows, first.grad1, change, ref,
                                 ref_change))
    out.update(sampler_numbers(c, final, seed, device))
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number there, finite and within its limit."""
    return all(k in numbers and math.isfinite(numbers[k])
               and numbers[k] <= lim for k, lim in limits.items())
