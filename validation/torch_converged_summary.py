"""Summarise the port's converged training records against the JAX
package's (``validation/torch_converged.sh``).

For each row: the mean of the primary metric (E, or F at finite
temperature) over the last 300 rows (500 for the fresh-walker rows, as
their JAX records were summarised) of the port's final record and of the
JAX record, the sem of the port's mean (the rows' standard deviation over
sqrt of the rows, which ignores their autocorrelation), |delta|, the bound fixed
before the runs and whether it holds; S(MC) - S_analytical on the last
finite-temperature row, with its mean and the rows' spread over the tail
(and, where a row fixes one, the bound on that mean); a reference value
the mean must also meet where a row names one; the tail's acceptance;
the step-1 checks of the rows that have them (``STEP1``); the median of
``iter_seconds`` (steady ms per iteration) and the wall seconds of the
CLI runs
(``torch_converged_wall.jsonl``); and the evaluator's fresh-chain energies
at the ground-state checkpoints, each against its training tail (within 3
combined sems + 0.002; + 0.01 at Z = 8), its two engines within 3e-4
(relative) of each other.

The N = 6 coupling sweep adds: E(beta = 2) - E_GS from the port's own two
tail means at each Z, in [0.80, 1.00]; the crossover structure
(``torch_xover_z*.json``) against the JAX records (``xover_z*.json``), rms
r, the mean pair distance, V_int and V_trap each within its relative
bound, and on the port alone rms r and the mean pair distance rising
strictly with Z, n(0) falling, and 2 pi sum r n(r) dr = N times the share
of positions inside rmax to 1e-6; and the ODE-steps study
(``torch_ode_steps_z*.json``): at Z = 0.5 |dE| at 4 steps within 10x the
JAX row's and the gradient's relative error <= 1e-6; at Z = 8 the rows,
and whether |dE| at 4 steps exceeds 1e-4.  Every bound was fixed before
the runs.

    python validation/torch_converged_summary.py [--runs validation/runs]
        [--json OUT]
"""

import argparse
import gzip
import json
import math
import os
from typing import NamedTuple

import numpy as np

TAIL = 300


class Row(NamedTuple):
    """A training row: its port records, the JAX record, the metric, the
    bound (lo, hi) on the port's tail mean, on the last row the bound on
    |S - S_analytical| and on S itself (or None), and the tail's rows;
    the bound on the tail mean of S - S_analytical, about 0 or (with
    ``s_tail_vs_jax``) about the JAX record's own tail mean (or None); and
    (value, bound) of a reference that the port's tail mean must also lie
    within (or None)."""
    name: str
    recs: list
    jax: str
    key: str
    bound: tuple
    s_bound: float | None = None
    s_max: float | None = None
    tail: int = TAIL
    s_tail: float | None = None
    s_tail_vs_jax: bool = False
    ref: tuple | None = None


def _port(rec: str, polish: bool = True) -> list:
    return ["torch_" + rec] + (["torch_" + rec + "_polish"] if polish else [])


def _within(centre: float, lo: float, hi: float) -> tuple:
    return (centre - lo, centre + hi)


ROWS = [
    Row("GS N=6", _port("gs_n6_z05_ode4"), "gs_n6_z05_r5_ode4_polish", "E",
        _within(18.1605, 0.002, 0.002)),
    # The same row retrained through captured chunks (one CUDA graph a
    # chunk), under the same bound.
    Row("GS N=6 captured", _port("gs_n6_z05_ode4_graph"),
        "gs_n6_z05_r5_ode4_polish", "E", _within(18.1605, 0.002, 0.002)),
    Row("finite T N=6", _port("beta_n6_z05"), "beta_n6_z05_r4_polish", "F",
        _within(17.4998, 0.002, 0.002), 0.02),
    Row("GS N=10", _port("gs_n10_z05"), "gs_n10_z05_r3_polish", "E",
        _within(41.5519, 0.01, 0.01)),
    Row("finite T N=10", _port("beta_n10_de4", False), "beta_n10_de4", "F",
        _within(37.2113, 0.01, 0.01)),
    Row("Taut singlet", _port("gs_n2_taut_singlet", False),
        "gs_n2_taut_singlet", "E", (2.998, 3.009)),
    Row("Taut triplet", _port("gs_n2_taut_triplet", False),
        "gs_n2_taut_triplet", "E", (3.999, 4.002)),
    # The coupling sweep.  Z = 1 and 2 are lopsided: their JAX records are
    # round-2 runs, whose optima the r3 protocol undercut (0.003 at Z = 0.5
    # up to 0.13 at Z = 8); the other widths scale 0.002 with the energy.
    Row("GS Z=1", _port("gs_n6_z10"), "gs_n6_z10", "E",
        _within(22.00938, 0.03, 0.002)),
    Row("GS Z=2", _port("gs_n6_z20"), "gs_n6_z20", "E",
        _within(28.98446, 0.05, 0.003)),
    Row("GS Z=4", _port("gs_n6_z40"), "gs_n6_z40_r3_polish", "E",
        _within(40.93092, 0.005, 0.005)),
    Row("GS Z=8", _port("gs_n6_z80"), "gs_n6_z80_r3_polish", "E",
        _within(60.71517, 0.01, 0.01)),
    Row("finite T Z=1", _port("beta_n6_z10"), "beta_n6_z10_r4_polish", "F",
        _within(21.30159, 0.002, 0.002), 0.02),
    Row("finite T Z=2", _port("beta_n6_z20"), "beta_n6_z20_r4_polish", "F",
        _within(28.21236, 0.003, 0.003), 0.02),
    Row("finite T Z=4", _port("beta_n6_z40"), "beta_n6_z40_r4_polish", "F",
        _within(40.17882, 0.005, 0.005), 0.02),
    Row("finite T Z=8", _port("beta_n6_z80"), "beta_n6_z80_r4_polish", "F",
        _within(59.99868, 0.01, 0.01), 0.02),
    Row("beta=10 N=3 Z=2", _port("beta_n3_b10_z2", False), "beta_n3_b10_z2",
        "F", _within(8.32539, 0.003, 0.003), s_max=0.01),
    # The reference's fresh-walker protocol (the CLIs' default: every
    # iteration 100 Metropolis steps at a fixed tau 0.1 from fresh
    # Gaussians), the round-2 JAX records' own (docs/VALIDATION.md:12-17,
    # :23-30): batch 8192, lr 3e-3, dopri5 x 8, no polish.  Last-500
    # means; |port - JAX| within the bound, fixed before the runs.
    Row("GS N=3 fresh", _port("gs_n3_z05_fresh", False), "gs_n3_z05", "E",
        _within(5.90832, 0.002, 0.002), tail=500),
    Row("GS N=6 fresh", _port("gs_n6_z05_fresh", False), "gs_n6_z05", "E",
        _within(18.15935, 0.005, 0.005), tail=500),
    Row("GS Z=1 fresh", _port("gs_n6_z10_fresh", False), "gs_n6_z10", "E",
        _within(22.00883, 0.006, 0.006), tail=500),
    Row("GS Z=2 fresh", _port("gs_n6_z20_fresh", False), "gs_n6_z20", "E",
        _within(28.98483, 0.010, 0.010), tail=500),
    Row("finite T N=6 fresh", _port("beta_n6_z05_fresh", False),
        "beta_n6_z05", "F", _within(17.49912, 0.005, 0.005), 0.02,
        tail=500),
    # The last five JAX training records: the fresh-protocol runs at
    # Z = 4 and 8, and at beta = 1 and 4 (their beta read from the first
    # row's S_analytical, Z = 0.5 confirmed by the step-1 E, STEP1), and
    # the persistent N = 3 finite-T run with its polish, which the
    # reference's own finite-T training also ran (docs/VALIDATION.md:
    # 165-185, F 5.5264).  The widths scale the nearest fresh row's bound
    # by the ratio of the JAX records' row spreads (0.005 the floor); the
    # fresh finite-T rows hold the tail mean of S - S_an, where a single
    # row's S is a new 8192-walker estimate, and report the last row's.
    Row("GS Z=4 fresh", _port("gs_n6_z40_fresh", False), "gs_n6_z40", "E",
        _within(41.00402, 0.018, 0.018), tail=500),
    Row("GS Z=8 fresh", _port("gs_n6_z80_fresh", False), "gs_n6_z80", "E",
        _within(60.86448, 0.033, 0.033), tail=500),
    Row("finite T beta=1 fresh", _port("beta_n6_b10_fresh", False),
        "beta_n6_b10", "F", _within(15.69135, 0.010, 0.010), tail=500,
        s_tail=0.005),
    Row("finite T beta=4 fresh", _port("beta_n6_b40_fresh", False),
        "beta_n6_b40", "F", _within(18.09384, 0.005, 0.005), tail=500,
        s_tail=0.005),
    Row("finite T N=3 Z=0.5", _port("beta_n3_z05"), "beta_n3_z05_r5_polish",
        "F", _within(5.52509, 0.002, 0.002), 0.02, tail=500, s_tail=0.005,
        s_tail_vs_jax=True, ref=(5.5264, 0.004)),
]
# The step-1 check run before each of those fresh rows (the identity flow,
# 10 iterations of the row's flags): (row, its record, the JAX record);
# step 1's E within STEP1_BOUND of the JAX record's confirms Z.
STEP1 = [("GS Z=4 fresh", "torch_gs_n6_z40_fresh_step1", "gs_n6_z40"),
         ("GS Z=8 fresh", "torch_gs_n6_z80_fresh_step1", "gs_n6_z80"),
         ("finite T beta=1 fresh", "torch_beta_n6_b10_fresh_step1",
          "beta_n6_b10"),
         ("finite T beta=4 fresh", "torch_beta_n6_b40_fresh_step1",
          "beta_n6_b40")]
STEP1_BOUND = 0.1
# (row, record, slack added to 3 combined sems)
EVALS = [("GS N=6", "gs_n6_z05_ode4", 0.002), ("GS N=10", "gs_n10_z05", 0.002),
         ("Taut singlet", "gs_n2_taut_singlet", 0.002),
         ("GS Z=8", "gs_n6_z80", 0.01)]
ENGINES_RTOL = 3e-4
# E(beta = 2) - E_GS at each Z: (GS row, finite-T row); the JAX sweep has
# 0.88-0.93 (docs/VALIDATION.md:72-96).
EXCITATION = [(0.5, "GS N=6", "finite T N=6"), (1.0, "GS Z=1", "finite T Z=1"),
              (2.0, "GS Z=2", "finite T Z=2"), (4.0, "GS Z=4", "finite T Z=4"),
              (8.0, "GS Z=8", "finite T Z=8")]
EXCITATION_BOUND = (0.80, 1.00)
# Structure: (Z, port record, JAX record, relative bound on rms r and the
# mean pair distance, on V_int, on V_trap).  Z = 0.5, 4, 8 against the r3
# records; Z = 1, 2 against the r2 ones, which sit further from the port's
# optima.
XOVER = [(0.5, "torch_xover_z05", "xover_z05_r3", 0.005, 0.01, 0.01),
         (1.0, "torch_xover_z10", "xover_z10", 0.015, 0.03, 0.03),
         (2.0, "torch_xover_z20", "xover_z20", 0.015, 0.03, 0.03),
         (4.0, "torch_xover_z40", "xover_z40_r3", 0.01, 0.015, 0.02),
         (8.0, "torch_xover_z80", "xover_z80_r3", 0.01, 0.015, 0.02)]
NORM_TOL = 1e-6
# ODE steps: the JAX study's row at 4 steps (ode_steps_n6.json) and the
# bounds on the port's at Z = 0.5; at Z = 8, 4 steps above DE_FLAG put the
# main path's default in question (a tenth of the batch-8192 sem).
ODE_JAX = "ode_steps_n6"
ODE_DE_FACTOR = 10.0
ODE_GRAD_REL = 1e-6
ODE_DE_FLAG = 1e-4
ENGINES = ("hessian_flow", "nested_jvp")


def read(path):
    with (gzip.open(path, "rt") if path.endswith(".gz") else open(path)) as fh:
        return [json.loads(line) for line in fh]


def record(runs: str, name: str) -> str:
    """The path of record ``name`` in ``runs``: ``name.jsonl``, or its
    gzipped copy ``name.jsonl.gz`` (as the coupling sweep's records are
    kept in the repository)."""
    path = os.path.join(runs, name + ".jsonl")
    return path if os.path.exists(path) else path + ".gz"


def tail_stats(rows, key, tail=TAIL):
    v = np.array([r[key] for r in rows[-tail:]], dtype=np.float64)
    return float(v.mean()), float(v.std(ddof=1) / math.sqrt(len(v)))


def walls(runs: str) -> dict:
    """The last wall seconds of each record that ran to rc 0
    (``torch_converged_wall.jsonl``), by record."""
    path = os.path.join(runs, "torch_converged_wall.jsonl")
    if not os.path.exists(path):
        return {}
    return {r["record"]: r["wall_s"] for r in read(path) if r["rc"] == 0}


def summarise(runs: str) -> dict:
    out = {"rows": [], "evals": [], "excitation": [], "xover": [],
           "ode_steps": [], "step1": step1(runs)}
    tails, e_tails = {}, {}
    wall_s = walls(runs)
    for (name, recs, jax_rec, key, (lo, hi), s_bound, s_max, tail, s_tail,
         s_tail_vs_jax, ref) in ROWS:
        paths = [record(runs, r) for r in recs]
        if not all(os.path.exists(p) for p in paths):
            out["rows"].append({"row": name, "missing": recs})
            continue
        rows = [r for p in paths for r in read(p)]
        jrows = read(record(runs, jax_rec))
        mean, sem = tail_stats(rows, key, tail)
        jmean, jsem = tail_stats(jrows, key, tail)
        tails[name] = (mean, sem)
        e_tails[name] = tail_stats(rows, "E", tail)[0]
        row = {
            "row": name, "metric": key, "tail": tail,
            "iterations": rows[-1]["step"],
            "port": mean, "port_sem": sem, "jax": jmean, "jax_sem": jsem,
            "abs_delta": abs(mean - jmean), "bound": [lo, hi],
            "within_bound": lo <= mean <= hi,
            "ms_per_iteration_median": 1e3 * float(np.median(
                [r["iter_seconds"] for r in rows if "iter_seconds" in r])),
            "loop_seconds": float(sum(r.get("iter_seconds", 0.0)
                                      for r in rows)),
            "wall_seconds": (sum(wall_s[r] for r in recs)
                             if all(r in wall_s for r in recs) else None),
            "accept": tail_stats(rows, "accept_rate", tail)[0],
            "jax_accept": tail_stats(jrows, "accept_rate", tail)[0],
        }
        if s_bound is not None or s_tail is not None:
            dS = rows[-1]["S"] - rows[-1]["S_analytical"]
            tail_dS = float(np.mean([r["S"] - r["S_analytical"]
                                     for r in rows[-tail:]]))
            row.update(S_minus_S_analytical=dS,
                       S_minus_S_analytical_tail_mean=tail_dS,
                       S_minus_S_analytical_tail_std=float(np.std(
                           [r["S"] - r["S_analytical"] for r in rows[-tail:]],
                           ddof=1)))
            if s_bound is not None:
                row["S_within_bound"] = abs(dS) <= s_bound
        if s_tail is not None:
            centre = (float(np.mean([r["S"] - r["S_analytical"]
                                     for r in jrows[-tail:]]))
                      if s_tail_vs_jax else 0.0)
            row.update(S_tail_centre=centre, S_tail_bound=s_tail,
                       S_tail_within_bound=abs(tail_dS - centre) <= s_tail)
        if ref is not None:
            row.update(reference=ref[0], reference_bound=ref[1],
                       within_reference=abs(mean - ref[0]) <= ref[1])
        if s_max is not None:
            row.update(S=rows[-1]["S"], S_below_max=rows[-1]["S"] < s_max)
        out["rows"].append(row)
    for name, rec, slack in EVALS:
        es = {}
        for engine in ENGINES:
            path = os.path.join(runs, f"torch_eval_{rec}_{engine}.json")
            if not os.path.exists(path) or name not in tails:
                continue
            ev = load(path)
            es[engine] = ev["E"]
            mean, sem = tails[name]
            tol = 3.0 * math.hypot(ev["E_sem"], sem) + slack
            out["evals"].append({
                "row": name, "engine": engine, "step": ev["step"],
                "E": ev["E"], "E_sem": ev["E_sem"], "n_total": ev["n_total"],
                "training_tail": mean, "delta": ev["E"] - mean, "tol": tol,
                "within": abs(ev["E"] - mean) <= tol,
                "wall_seconds": wall_s.get(f"torch_eval_{rec}_{engine}")})
        if len(es) == len(ENGINES):
            rel = abs(es["hessian_flow"] - es["nested_jvp"]) / abs(
                es["nested_jvp"])
            out["evals"][-1].update(engines_rel=rel,
                                    engines_within=rel <= ENGINES_RTOL)
    for Z, gs, beta in EXCITATION:
        if gs in e_tails and beta in e_tails:
            d = e_tails[beta] - e_tails[gs]
            lo, hi = EXCITATION_BOUND
            out["excitation"].append({"Z": Z, "E_beta2_minus_E_GS": d,
                                      "within": lo <= d <= hi})
    out["xover"] = xover(runs)
    out["ode_steps"] = ode_steps(runs)
    return out


def step1(runs: str) -> list:
    """Each step-1 check present: the port's E at step 1 against the JAX
    record's, within STEP1_BOUND."""
    out = []
    for name, rec, jax_rec in STEP1:
        path = record(runs, rec)
        if not os.path.exists(path):
            continue
        e, je = read(path)[0]["E"], read(record(runs, jax_rec))[0]["E"]
        out.append({"row": name, "E": e, "jax_E": je, "delta": e - je,
                    "bound": STEP1_BOUND, "within": abs(e - je)
                    <= STEP1_BOUND})
    return out


def load(path):
    with open(path) as fh:
        return json.load(fh)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def xover(runs: str) -> list:
    """Each coupling's structure against the JAX record, then the port's
    trends across the couplings present (on the last entry: ``rising``,
    ``falling``)."""
    out = []
    for Z, rec, jrec, tol_r, tol_int, tol_trap in XOVER:
        path = os.path.join(runs, rec + ".json")
        if not os.path.exists(path):
            continue
        p, j = load(path), load(os.path.join(runs, jrec + ".json"))
        row = {"Z": Z, "record": rec, "jax": jrec, "walkers": p["walkers"],
               "n0": p["n0"], "jax_n0": j["n_of_r"][0], "checks": {}}
        for key, tol in (("rms_r", tol_r), ("mean_pair_distance", tol_r),
                         ("V_int", tol_int), ("V_trap", tol_trap)):
            rel = _rel(p[key], j[key])
            row[key], row["jax_" + key] = p[key], j[key]
            row["checks"][key] = {"rel": rel, "bound": tol,
                                  "within": rel <= tol}
        n = p["nup"]
        norm_err = abs(p["norm_integral"] - n * p["inside_fraction"])
        row["checks"]["normalisation"] = {"abs": norm_err, "bound": NORM_TOL,
                                          "within": norm_err <= NORM_TOL}
        out.append(row)
    if len(out) > 1:
        def strictly(key, sign):
            v = [r[key] for r in out]
            return all(sign * (b - a) > 0 for a, b in zip(v, v[1:]))
        out[-1]["trends"] = {
            "rms_r rising": strictly("rms_r", 1),
            "mean_pair_distance rising": strictly("mean_pair_distance", 1),
            "n0 falling": strictly("n0", -1)}
    return out


def ode_steps(runs: str) -> list:
    """The ODE-steps study's rows at each coupling; at Z = 0.5 the bounds
    against the JAX study, at Z = 8 the flag on 4 steps."""
    jax_rows = {r["ode_steps"]: r for r in
                load(os.path.join(runs, ODE_JAX + ".json"))["rows"]}
    out = []
    for tag, Z in (("z05", 0.5), ("z80", 8.0)):
        path = os.path.join(runs, f"torch_ode_steps_{tag}.json")
        if not os.path.exists(path):
            continue
        res = load(path)
        four = next(r for r in res["rows"] if r["ode_steps"] == 4)
        entry = {"Z": Z, "ckpt_step": res["ckpt_step"], "E_ref": res["E_ref"],
                 "mc_sem_at_batch8192": res["mc_sem_at_batch8192"],
                 "rows": res["rows"]}
        if Z == 0.5:
            bound = ODE_DE_FACTOR * jax_rows[4]["dE"]
            entry["checks"] = {
                "dE_4 within 10x JAX": {"port": four["dE"], "bound": bound,
                                        "within": four["dE"] <= bound},
                "grad_rel_err_4": {"port": four["grad_rel_err"],
                                   "bound": ODE_GRAD_REL,
                                   "within": four["grad_rel_err"]
                                   <= ODE_GRAD_REL}}
        else:
            entry["dE_4_above_1e-4"] = four["dE"] > ODE_DE_FLAG
        out.append(entry)
    return out


def failures(res: dict) -> list:
    """Every bound that does not hold."""
    bad = []
    bad += [f"step 1 {c['row']}" for c in res["step1"] if not c["within"]]
    for r in res["rows"]:
        for key in ("within_bound", "S_within_bound", "S_below_max",
                    "S_tail_within_bound", "within_reference"):
            if r.get(key) is False:
                bad.append(f"{r['row']}: {key}")
    for e in res["evals"]:
        for key in ("within", "engines_within"):
            if e.get(key) is False:
                bad.append(f"eval {e['row']} {e['engine']}: {key}")
    bad += [f"excitation Z={e['Z']}" for e in res["excitation"]
            if not e["within"]]
    for x in res["xover"]:
        bad += [f"xover Z={x['Z']}: {k}" for k, c in x["checks"].items()
                if not c["within"]]
        bad += [f"xover: {k}" for k, ok in x.get("trends", {}).items()
                if not ok]
    for o in res["ode_steps"]:
        bad += [f"ode steps Z={o['Z']}: {k}" for k, c in
                o.get("checks", {}).items() if not c["within"]]
    return bad


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--runs", default="validation/runs")
    p.add_argument("--json", default=None)
    args = p.parse_args()
    res = summarise(args.runs)
    for r in res["rows"]:
        if "missing" in r:
            print(f"{r['row']}: missing {r['missing']}")
            continue
        extra = ("" if "S_minus_S_analytical" not in r else
                 f"; S - S_an {r['S_minus_S_analytical']:+.5f} ("
                 + ({True: "pass; ", False: "FAIL; "}.get(
                     r.get("S_within_bound"), "reported only; "))
                 + f"over the tail {r['S_minus_S_analytical_tail_mean']:+.5f}"
                 + ("" if "S_tail_within_bound" not in r else
                    f" against {r['S_tail_centre']:+.5f} ± "
                    f"{r['S_tail_bound']:g} "
                    + ("pass" if r["S_tail_within_bound"] else "FAIL"))
                 + f", rows' std {r['S_minus_S_analytical_tail_std']:.5f})")
        if "reference" in r:
            extra += (f"; against the reference {r['reference']:g} ± "
                      f"{r['reference_bound']:g} "
                      + ("pass" if r["within_reference"] else "FAIL"))
        extra += f"; accept {r['accept']:.3f} (JAX {r['jax_accept']:.3f})"
        print(f"{r['row']}: {r['metric']} {r['port']:.5f} ± "
              f"{r['port_sem']:.5f} (JAX {r['jax']:.5f} ± {r['jax_sem']:.5f}),"
              f" |delta| {r['abs_delta']:.5f}, bound [{r['bound'][0]:.4f}, "
              f"{r['bound'][1]:.4f}] {'pass' if r['within_bound'] else 'FAIL'}"
              f"{extra}; {r['ms_per_iteration_median']:.3f} ms/iter median, "
              f"{r['loop_seconds']:.1f} s in the loop, wall "
              f"{r['wall_seconds']} s")
    for c in res["step1"]:
        print(f"step 1 {c['row']}: E {c['E']:.5f} (JAX {c['jax_E']:.5f}), "
              f"delta {c['delta']:+.5f} (bound {c['bound']:g}) "
              f"{'pass' if c['within'] else 'FAIL'}")
    for e in res["evals"]:
        print(f"eval {e['row']} {e['engine']} (step {e['step']}): E "
              f"{e['E']:.5f} ± {e['E_sem']:.5f}, tail {e['training_tail']:.5f}"
              f", delta {e['delta']:+.5f} (tol {e['tol']:.5f}) "
              f"{'pass' if e['within'] else 'FAIL'}; wall "
              f"{e['wall_seconds']} s")
    for e in res["evals"]:
        if "engines_rel" in e:
            print(f"eval {e['row']}: engines {e['engines_rel']:.2e} apart "
                  f"(relative; bound {ENGINES_RTOL:g}) "
                  f"{'pass' if e['engines_within'] else 'FAIL'}")
    for e in res["excitation"]:
        print(f"E(beta=2) - E_GS at Z={e['Z']:g}: "
              f"{e['E_beta2_minus_E_GS']:.5f} (bound {EXCITATION_BOUND}) "
              f"{'pass' if e['within'] else 'FAIL'}")
    for x in res["xover"]:
        parts = [f"{k} {x[k]:.5f} (JAX {x['jax_' + k]:.5f}, "
                 f"{100 * c['rel']:.2f}% of {100 * c['bound']:g}%"
                 f"{'' if c['within'] else ' FAIL'})"
                 for k, c in x["checks"].items() if k != "normalisation"]
        c = x["checks"]["normalisation"]
        print(f"xover Z={x['Z']:g}: " + "; ".join(parts) + f"; n0 "
              f"{x['n0']:.4f} (JAX {x['jax_n0']:.4f}); normalisation "
              f"{c['abs']:.1e} {'pass' if c['within'] else 'FAIL'}")
        if "trends" in x:
            print("xover trends: " + ", ".join(
                f"{k} {'pass' if ok else 'FAIL'}"
                for k, ok in x["trends"].items()))
    for o in res["ode_steps"]:
        rows = ", ".join(f"{r['ode_steps']}: dE {r['dE']:.2e} max "
                         f"{r['max_dEloc']:.2e} grad {r['grad_rel_err']:.2e}"
                         for r in o["rows"])
        extra = ("; ".join(f"{k} {c['port']:.2e} (bound {c['bound']:.2e}) "
                           f"{'pass' if c['within'] else 'FAIL'}"
                           for k, c in o.get("checks", {}).items())
                 or f"dE at 4 steps above 1e-4: {o['dE_4_above_1e-4']}")
        print(f"ode steps Z={o['Z']:g} (E_ref {o['E_ref']:.6f}, sem at 8192 "
              f"{o['mc_sem_at_batch8192']:.2e}): {rows}; {extra}")
    bad = failures(res)
    print("all bounds hold" if not bad else "FAILED: " + "; ".join(bad))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(res, fh, indent=1)


if __name__ == "__main__":
    main()
