"""``validation/torch_converged_summary.py`` on the JAX package's last five
training records: their tail means and the bounds fixed for the port's
rows, and the tail-mean S bound on synthetic port records."""

import importlib.util
import json
import os

import numpy as np
import pytest

from _torch_port import REPO

RUNS = os.path.join(REPO, "validation", "runs")


def _summary():
    spec = importlib.util.spec_from_file_location(
        "torch_converged_summary",
        os.path.join(REPO, "validation", "torch_converged_summary.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


S = _summary()
ROWS = {r.name: r for r in S.ROWS}

# (row, the JAX record's last-500 mean, the bound on |port - JAX|)
FIVE = [("GS Z=4 fresh", 41.00402, 0.018), ("GS Z=8 fresh", 60.86448, 0.033),
        ("finite T beta=1 fresh", 15.69135, 0.010),
        ("finite T beta=4 fresh", 18.09384, 0.005),
        ("finite T N=3 Z=0.5", 5.52509, 0.002)]


@pytest.mark.parametrize("name,mean,width", FIVE)
def test_last_five_rows_read_the_jax_records_and_hold_the_fixed_bounds(
        name, mean, width):
    """Each new row's JAX record gives the last-500 mean the bound is
    centred on (to 5 decimals), and the bound is the one fixed before the
    runs; the fresh finite-T rows bound the tail mean of S - S_an at 0.005
    and leave the last row unbounded, the N = 3 row also holds the
    reference's F 5.5264 within 0.004."""
    row = ROWS[name]
    jmean, _ = S.tail_stats(S.read(S.record(RUNS, row.jax)), row.key,
                            row.tail)
    assert row.tail == 500 and round(jmean, 5) == mean
    assert row.bound == pytest.approx((mean - width, mean + width), abs=1e-12)
    if name.startswith("finite T"):
        assert row.s_tail == 0.005
    if "fresh" in name and name.startswith("finite T"):
        assert row.s_bound is None and not row.s_tail_vs_jax
    if name == "finite T N=3 Z=0.5":
        assert row.s_bound == 0.02 and row.s_tail_vs_jax
        assert row.ref == (5.5264, 0.004)
        assert row.recs == ["torch_beta_n3_z05", "torch_beta_n3_z05_polish"]


def _write(path, rows):
    with open(path, "w") as fh:
        for r in rows:
            fh.write(json.dumps(r) + "\n")


def _runs(tmp_path, jax_rec, port_rec, F, dS, last_dS):
    """A runs directory: the JAX record and the ODE study (linked) beside a
    synthetic port record of 600 rows with F, and S - S_an = dS but for
    the last row's ``last_dS``."""
    for name in (jax_rec + ".jsonl", S.ODE_JAX + ".json"):
        os.symlink(os.path.join(RUNS, name), tmp_path / name)
    rng = np.random.default_rng(0)
    rows = [{"step": i + 1, "E": F, "F": F, "S": 2.0 + dS + d,
             "S_analytical": 2.0, "accept_rate": 0.7, "iter_seconds": 0.003}
            for i, d in enumerate(1e-4 * rng.standard_normal(600))]
    rows[-1]["S"] = 2.0 + last_dS
    _write(tmp_path / (port_rec + ".jsonl"), rows)
    return str(tmp_path)


@pytest.mark.parametrize("dS,passes", [(0.0045, True), (-0.0045, True),
                                       (0.0056, False), (-0.0056, False)])
def test_tail_mean_s_bound_passes_and_fails_where_it_should(tmp_path, dS,
                                                            passes):
    """A synthetic port record of the beta = 4 row, F on the JAX tail mean:
    S - S_an averaging dS over the tail passes within 0.005 of 0 and fails
    beyond, whatever the last row (here 0.05 off, beyond the persistent
    rows' 0.02) says; only the tail bound enters ``failures``."""
    runs = _runs(tmp_path, "beta_n6_b40", "torch_beta_n6_b40_fresh",
                 18.09384, dS, 0.05)
    res = S.summarise(runs)
    row = next(r for r in res["rows"] if r["row"] == "finite T beta=4 fresh")
    assert row["within_bound"]
    assert row["S_tail_within_bound"] is passes
    assert "S_within_bound" not in row
    assert row["S_minus_S_analytical"] == pytest.approx(0.05)
    bad = [b for b in S.failures(res) if b.startswith("finite T beta=4")]
    assert bad == ([] if passes else
                   ["finite T beta=4 fresh: S_tail_within_bound"])


def test_n3_row_holds_the_tail_s_against_the_jax_record_and_the_reference(
        tmp_path):
    """The N = 3 row's tail S bound is centred on the JAX record's own tail
    mean of S - S_an (+0.00938), and F also answers to the reference's
    5.5264 within 0.004: F on the JAX tail mean (0.00131 from the
    reference) and S - S_an on the JAX tail pass; 0.006 off the JAX
    tail's S fails."""
    os.symlink(os.path.join(RUNS, "beta_n3_z05_r5_polish.jsonl"),
               tmp_path / "beta_n3_z05_r5_polish.jsonl")
    os.symlink(os.path.join(RUNS, S.ODE_JAX + ".json"),
               tmp_path / (S.ODE_JAX + ".json"))
    jrows = S.read(str(tmp_path / "beta_n3_z05_r5_polish.jsonl"))
    centre = float(np.mean([r["S"] - r["S_analytical"] for r in jrows[-500:]]))
    assert round(centre, 5) == 0.00938
    for off, passes in ((0.0, True), (0.006, False)):
        rows = [{"step": i + 1, "E": 6.5, "F": 5.52509, "S": 2.0 + centre
                 + off, "S_analytical": 2.0, "accept_rate": 0.5,
                 "iter_seconds": 0.0015} for i in range(3000)]
        _write(tmp_path / "torch_beta_n3_z05.jsonl", rows[:2000])
        _write(tmp_path / "torch_beta_n3_z05_polish.jsonl", rows[2000:])
        row = next(r for r in S.summarise(str(tmp_path))["rows"]
                   if r["row"] == "finite T N=3 Z=0.5")
        assert row["within_bound"] and row["within_reference"]
        assert row["S_within_bound"]
        assert row["S_tail_within_bound"] is passes
