"""Summarise the port's converged training records against the JAX
package's (``validation/torch_converged.sh``).

For each row: the mean of the primary metric (E, or F at finite
temperature) over the last 300 rows of the port's final record and of the
JAX record, the sem of the port's mean (the rows' standard deviation over
sqrt 300, which ignores their autocorrelation), |delta|, the bound fixed
before the runs and whether it holds; S(MC) - S_analytical on the last
finite-temperature row; the median of ``iter_seconds`` (steady ms per
iteration) and the wall seconds of the CLI runs
(``torch_converged_wall.jsonl``); and the evaluator's fresh-chain energies
at the three ground-state checkpoints, each against its training tail
(within 3 combined sems + 0.002).

    python validation/torch_converged_summary.py [--runs validation/runs]
        [--json OUT]
"""

import argparse
import json
import math
import os

import numpy as np

TAIL = 300
# (row, port records, JAX record, metric, bound (lo, hi) on the port's mean,
#  bound on |S - S_analytical| of the last row or None)
ROWS = [
    ("GS N=6", ["torch_gs_n6_z05_ode4", "torch_gs_n6_z05_ode4_polish"],
     "gs_n6_z05_r5_ode4_polish", "E", (18.1605 - 0.002, 18.1605 + 0.002),
     None),
    ("finite T N=6", ["torch_beta_n6_z05", "torch_beta_n6_z05_polish"],
     "beta_n6_z05_r4_polish", "F", (17.4998 - 0.002, 17.4998 + 0.002), 0.02),
    ("GS N=10", ["torch_gs_n10_z05", "torch_gs_n10_z05_polish"],
     "gs_n10_z05_r3_polish", "E", (41.5519 - 0.01, 41.5519 + 0.01), None),
    ("finite T N=10", ["torch_beta_n10_de4"], "beta_n10_de4", "F",
     (37.2113 - 0.01, 37.2113 + 0.01), None),
    ("Taut singlet", ["torch_gs_n2_taut_singlet"], "gs_n2_taut_singlet", "E",
     (2.998, 3.009), None),
    ("Taut triplet", ["torch_gs_n2_taut_triplet"], "gs_n2_taut_triplet", "E",
     (3.999, 4.002), None),
]
EVALS = [("GS N=6", "gs_n6_z05_ode4"), ("GS N=10", "gs_n10_z05"),
         ("Taut singlet", "gs_n2_taut_singlet")]
ENGINES = ("hessian_flow", "nested_jvp")


def read(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def tail_stats(rows, key):
    v = np.array([r[key] for r in rows[-TAIL:]], dtype=np.float64)
    return float(v.mean()), float(v.std(ddof=1) / math.sqrt(len(v)))


def walls(runs: str) -> dict:
    """The last wall seconds of each record that ran to rc 0
    (``torch_converged_wall.jsonl``), by record."""
    path = os.path.join(runs, "torch_converged_wall.jsonl")
    if not os.path.exists(path):
        return {}
    return {r["record"]: r["wall_s"] for r in read(path) if r["rc"] == 0}


def summarise(runs: str) -> dict:
    out = {"rows": [], "evals": []}
    tails = {}
    wall_s = walls(runs)
    for name, recs, jax_rec, key, (lo, hi), s_bound in ROWS:
        paths = [os.path.join(runs, r + ".jsonl") for r in recs]
        if not all(os.path.exists(p) for p in paths):
            out["rows"].append({"row": name, "missing": recs})
            continue
        rows = [r for p in paths for r in read(p)]
        mean, sem = tail_stats(rows, key)
        jmean, jsem = tail_stats(read(os.path.join(runs, jax_rec + ".jsonl")),
                                 key)
        tails[name] = (mean, sem)
        row = {
            "row": name, "metric": key, "iterations": rows[-1]["step"],
            "port": mean, "port_sem": sem, "jax": jmean, "jax_sem": jsem,
            "abs_delta": abs(mean - jmean), "bound": [lo, hi],
            "within_bound": lo <= mean <= hi,
            "ms_per_iteration_median": 1e3 * float(np.median(
                [r["iter_seconds"] for r in rows if "iter_seconds" in r])),
            "loop_seconds": float(sum(r.get("iter_seconds", 0.0)
                                      for r in rows)),
            "wall_seconds": (sum(wall_s[r] for r in recs)
                             if all(r in wall_s for r in recs) else None),
        }
        if s_bound is not None:
            dS = rows[-1]["S"] - rows[-1]["S_analytical"]
            row.update(S_minus_S_analytical=dS,
                       S_within_bound=abs(dS) <= s_bound)
        out["rows"].append(row)
    for name, rec in EVALS:
        for engine in ENGINES:
            path = os.path.join(runs, f"torch_eval_{rec}_{engine}.json")
            if not os.path.exists(path) or name not in tails:
                continue
            with open(path) as fh:
                ev = json.load(fh)
            mean, sem = tails[name]
            tol = 3.0 * math.hypot(ev["E_sem"], sem) + 0.002
            out["evals"].append({
                "row": name, "engine": engine, "step": ev["step"],
                "E": ev["E"], "E_sem": ev["E_sem"], "n_total": ev["n_total"],
                "training_tail": mean, "delta": ev["E"] - mean, "tol": tol,
                "within": abs(ev["E"] - mean) <= tol,
                "wall_seconds": wall_s.get(f"torch_eval_{rec}_{engine}")})
    return out


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
                 f"; S - S_an {r['S_minus_S_analytical']:+.5f} "
                 f"({'pass' if r['S_within_bound'] else 'FAIL'})")
        print(f"{r['row']}: {r['metric']} {r['port']:.5f} ± "
              f"{r['port_sem']:.5f} (JAX {r['jax']:.5f} ± {r['jax_sem']:.5f}),"
              f" |delta| {r['abs_delta']:.5f}, bound [{r['bound'][0]:.4f}, "
              f"{r['bound'][1]:.4f}] {'pass' if r['within_bound'] else 'FAIL'}"
              f"{extra}; {r['ms_per_iteration_median']:.3f} ms/iter median, "
              f"{r['loop_seconds']:.1f} s in the loop, wall "
              f"{r['wall_seconds']} s")
    for e in res["evals"]:
        print(f"eval {e['row']} {e['engine']} (step {e['step']}): E "
              f"{e['E']:.5f} ± {e['E_sem']:.5f}, tail {e['training_tail']:.5f}"
              f", delta {e['delta']:+.5f} (tol {e['tol']:.5f}) "
              f"{'pass' if e['within'] else 'FAIL'}; wall "
              f"{e['wall_seconds']} s")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(res, fh, indent=1)


if __name__ == "__main__":
    main()
