"""A finite-T run stopped by the package's divergence watchdog, looked at
with the reference (PERF.md, Open questions).

The finite-T configuration (``configs/ft_n6.json``) runs on the persistent
protocol as its cell would, with eager chunks (a replay repeats them
bitwise) and the package's default watchdog, while the estimator's inputs
of the last iterations are noted.  When the watchdog stops the run, the
reference reruns the iteration whose F jumped, in float64 from the same
parameters, walkers and states, and crosses it with the iteration before:
the new parameters on the old walkers, and the old on the new.  It prints
one JSON line for each seed.

    python3 portbench/spikes.py --iterations 6000 \\
        --seeds 3300000007 3300000021

With ``--ground-state`` the cell ``gs_n6.persistent_k10`` runs instead, its
fused chunks eager, and the iteration whose E_std jumped is rerun by the
reference in float64 and in plain float32 on the same parameters and
walkers: E, E_std and the walker that makes the jump (its local energy,
kinetic terms and nearest pair).

    python3 portbench/spikes.py --ground-state --iterations 6000 \\
        --seeds 7300000001 6700063353
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

import torch  # noqa: E402

import harness  # noqa: E402
import reference  # noqa: E402

TINY = dict(nup=3, batch=256, d_eta=8, d_mu=8, ode_steps=2,
            dtype="float64")


def _leaves(params: dict) -> dict:
    out = {f"{m}.{k}": v.detach().double().clone() for m in ("eta", "mu")
           for k, v in params["flow"][m].items()}
    out["logits"] = params["log_state_weights"].detach().double().clone()
    return out


def _f(model, beta: float, inputs) -> dict:
    """The reference's F and E of one iteration's (parameters, states,
    walkers), and the largest walker's share of F."""
    p, states, z_cm = inputs
    B = z_cm.shape[1]
    z = z_cm.T.reshape(B, model.n, 2).double()
    s = states.long()
    _, eloc, _ = reference.local_energy(model, p, z, s, 2048)
    floc = eloc + torch.log_softmax(p["logits"], -1)[s] / beta
    return dict(F=float(floc.mean()), E=float(eloc.mean()),
                F_median=float(floc.median()),
                top_share=float((floc.max() - floc.mean()) / B))


def look(spec: dict, seed: int, iterations: int, device: str) -> dict:
    from fermiflow_tpu_torch import train
    from fermiflow_tpu_torch.cli import common
    from fermiflow_tpu_torch.utils import MetricsLogger

    c = harness.shapes(spec)
    cfg = harness.program_config(spec, seed, device, HERE / "_spikes")
    cfg.metrics_path, cfg.iternum = None, iterations
    model, params = common.build_beta(cfg)
    state = train.init_beta_state(model, params, cfg,
                                  params["log_state_weights"].device)
    noted, full = [], model.loss_metrics_grads_cm

    def noting(params, state_idx, z, *rest):
        noted.append((_leaves(params), state_idx.clone(), z.detach().clone()))
        del noted[:-2 * cfg.steps_per_call]
        return full(params, state_idx, z, *rest)

    model.loss_metrics_grads_cm = noting
    chunk = train.make_multi_step(
        train.make_beta_train_step(model, cfg, graph=False),
        cfg.steps_per_call)
    rows = []

    class Logger(MetricsLogger):
        def log_many(self, *a):
            rows[:] = super().log_many(*a)
            return rows

    t0 = time.time()
    out = dict(seed=seed, seconds=None, tripped=None)
    try:
        common.run_training_loop(state, cfg, lambda k: chunk, Logger(None),
                                 lambda rec: None)
    except FloatingPointError as err:
        out["tripped"] = str(err)
        j = max(range(len(rows)), key=lambda i: rows[i]["F"]) - len(rows)
        ref = reference.Model(c)
        spike = _f(ref, c["beta"], noted[j])
        p1, s1, z1 = noted[j]
        p0, s0, z0 = noted[j - 1]
        out.update(
            row={k: rows[j][k] for k in ("step", "F", "E", "S", "F_std")},
            F_rel=abs(rows[j]["F"] - spike["F"]) / abs(spike["F"]),
            spike=spike, before=_f(ref, c["beta"], noted[j - 1]),
            new_parameters_old_walkers=_f(ref, c["beta"], (p1, s0, z0)),
            old_parameters_new_walkers=_f(ref, c["beta"], (p0, s1, z1)),
            parameter_step={k: float((p1[k] - p0[k]).norm()) for k in p1},
            rows_before=[{k: r[k] for k in ("step", "F", "F_std")}
                         for r in rows[:j]])
    out["seconds"] = time.time() - t0
    return out


def _e(model, p: dict, z, dtype) -> dict:
    """The reference's E and E_std of one GS iteration in ``dtype``, and
    its walker farthest from E: local energy, kinetic terms
    |lap log p| / 4 + |grad log p|^2 / 8, nearest pair distance."""
    p = {k: v.to(dtype) for k, v in p.items()}
    z = z.to(dtype)
    s = torch.zeros(z.shape[0], dtype=torch.long, device=z.device)
    x, eloc, _ = reference.local_energy(model, p, z, s, 2048)
    i = int(torch.argmax((eloc - eloc.mean()).abs()))
    nx, ny = model.qnums(s[i:i + 1])
    y0, g0, H0 = reference.slater_vgh(z[i:i + 1], nx, ny, model.num)
    _, _, g, H = reference.flow_forward(reference._flow(p), z[i:i + 1], y0,
                                        g0, H0, model.steps)
    lap = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
    _, r, mask = reference._pairs(x[i:i + 1])
    return dict(E=float(eloc.mean()), E_std=float(eloc.std()),
                top_walker=i, top_eloc=float(eloc[i]),
                top_kinetic=float(0.25 * lap.abs() + 0.125 * (g * g).sum()),
                top_min_pair=float((r + (1 - mask) * 1e9).min()),
                E_std_without_top=float(torch.cat([eloc[:i], eloc[i + 1:]])
                                        .std()))


def look_gs(spec: dict, seed: int, iterations: int, device: str) -> dict:
    from fermiflow_tpu_torch import train
    from fermiflow_tpu_torch.cli import common
    from fermiflow_tpu_torch.utils import MetricsLogger

    c = harness.shapes(spec)
    cfg = harness.program_config(spec, seed, device, HERE / "_spikes")
    cfg.metrics_path, cfg.iternum = None, iterations
    model, params = common.build_gs(cfg)
    state = train.init_gs_state(model, params, cfg,
                                params["eta"]["w1"].device)
    noted, make_update = [], train._make_gs_update

    def noting_update(*a, **kw):
        update = make_update(*a, **kw)

        def fn(st, z):
            p = {f"{m}.{k}": v.detach().double().clone()
                 for m in ("eta", "mu")
                 for k, v in getattr(st.flow, m).items()}
            noted.append((p, z.detach().T.reshape(z.shape[1], -1, 2).clone()))
            del noted[:-2 * cfg.steps_per_call]
            return update(st, z)
        return fn

    train._make_gs_update = noting_update
    try:
        chunk = train.make_gs_fused_multi_step(model, cfg, cfg.steps_per_call,
                                               graph=False)
    finally:
        train._make_gs_update = make_update
    rows = []

    class Logger(MetricsLogger):
        def log_many(self, *a):
            rows[:] = super().log_many(*a)
            return rows

    t0 = time.time()
    out = dict(seed=seed, seconds=None, tripped=None)
    try:
        common.run_training_loop(state, cfg, lambda k: chunk, Logger(None),
                                 lambda rec: None)
    except FloatingPointError as err:
        out["tripped"] = str(err)
        j = max(range(len(rows)), key=lambda i: rows[i]["E_std"]) - len(rows)
        ref = reference.Model(c)
        p, z = noted[j]
        out.update(
            row={k: rows[j][k] for k in ("step", "E", "E_std")},
            float64=_e(ref, p, z, torch.float64),
            float32=_e(ref, p, z, torch.float32),
            rows_before=[{k: r[k] for k in ("step", "E", "E_std")}
                         for r in rows[:j]])
    out["seconds"] = time.time() - t0
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iterations", type=int, default=6000)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--tiny", action="store_true",
                        help="a CPU-sized configuration, for a trial")
    parser.add_argument("--ground-state", action="store_true",
                        help="the cell gs_n6.persistent_k10")
    args = parser.parse_args(argv)
    spec = harness.kept_out_spec("gs_n6.persistent_k10")
    if not args.ground_state:
        spec["conf"] = json.loads((HERE / "configs" / "ft_n6.json")
                                  .read_text())
    if args.tiny:
        spec["conf"].update(TINY, divergence_nsigma=1.0)
    fn = look_gs if args.ground_state else look
    for seed in args.seeds:
        print(json.dumps(fn(spec, seed, args.iterations, args.device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
