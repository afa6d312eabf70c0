"""Readings that a cell's correctness limits are set from (PERF.md), on the
card at the cell's own size, in one process:

* the program's numbers on ``--seeds`` sound runs (``harness.run_cell``,
  the window as ``run_seconds``);
* the control on the first ``--control`` of them: the reference computed
  in float32 with TF32 matrix products (``reference.tf32_products``), put
  in the program's place on the program's own walkers and parameters: the
  iteration that closed the window and, at K = 1, the first three;
* planted faults on as many seeds: half of the batch (the reference on the
  first half of those walkers, in the program's place), and in the
  program's samplers, walkers 10 % too far out or an acceptance 20 % too
  low (``FAULTS``).  A state left unchanged reads 1 on ``change3_leaf`` and
  a count of Adam's steps off the rows' on ``adam_steps``, and needs no
  run.

    python3 portbench/calibrate.py --workload gs_n6.persistent_k10 \
        --seeds 12 --control 3 --out chiprun_out/cal.json
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]


@contextlib.contextmanager
def sampler_fault(train, walkers=None, rates=None):
    """Every sampler entry of the training steps hands on ``walkers(z0,
    z)`` in place of its walkers z and ``rates(r)`` in place of its
    acceptance rates r: a fault planted where they are produced."""
    walkers = walkers or (lambda z0, z: z)
    rates = rates or (lambda r: r)
    saved = {k: getattr(train, k) for k in (
        "metropolis_chains", "metropolis_single_cm",
        "metropolis_multistate_cm")}

    def chains(z0, *a, **kw):
        zs, logps, r, tau = saved["metropolis_chains"](z0, *a, **kw)
        return walkers(z0[None].expand_as(zs), zs), logps, rates(r), tau

    def single(name):
        def fn(z0, *a, **kw):
            z, logp, r = saved[name](z0, *a, **kw)
            return walkers(z0, z), logp, rates(r)
        return fn

    train.metropolis_chains = chains
    train.metropolis_single_cm = single("metropolis_single_cm")
    train.metropolis_multistate_cm = single("metropolis_multistate_cm")
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(train, k, v)


FAULTS = {
    # The walkers 10 % too far out, and the acceptance 20 % too low.
    "scaled_walkers": dict(walkers=lambda z0, z: 1.1 * z),
    "scaled_acceptance": dict(rates=lambda r: 0.8 * r),
}


def in_place(c: dict, res: dict, dev) -> dict:
    """{"control": numbers, "half_batch": numbers}: the reference in
    float32 with TF32 products, and in float64 on half of the walkers, put
    in the program's place on what the run ``res`` read."""
    import torch

    import check
    import reference

    snap = res["judged"]
    ref = check.rerun(c, snap, torch.float64, dev)
    with reference.tf32_products():
        ctl = check.rerun(c, snap, torch.float32, dev)
    half = check.rerun(c, snap, torch.float64, dev, halve=True)
    f32 = check.rerun_f32(c, snap, dev)
    out = {k: check.trained_numbers(c, *o, *ref, f32)
           for k, o in (("control", ctl), ("half_batch", half))}
    grad = {k: g for k, g in snap["grad"].items() if g is not None}
    out["program_leaves"] = check.leaf_gaps(grad, ref[1])
    first = res["first"]
    if first is not None:
        ref, ref_change = check.follow_reference(c, first.inputs,
                                                 torch.float64, dev)
        with reference.tf32_products():
            ctl, ctl_change = check.follow_reference(c, first.inputs,
                                                     torch.float32, dev)
        half, half_change = check.follow_reference(c, first.inputs,
                                                   torch.float64, dev,
                                                   halve=True)
        for k, (o, ch) in (("control", (ctl, ctl_change)),
                           ("half_batch", (half, half_change))):
            out[k].update(check.first_numbers(c, o["rows"], o["grad1"], ch,
                                              ref, ref_change))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control", type=int, default=3)
    parser.add_argument("--faults", type=int, default=3)
    parser.add_argument("--first-seed", type=int, default=4_100_000_001)
    parser.add_argument("--seconds", type=float, default=None)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    import torch

    import harness
    from fermiflow_tpu_torch import train

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    seconds = args.seconds or bench["run_seconds"]
    spec = harness.cell_spec(ROOT, args.workload)
    c = harness.shapes(spec)
    dev = torch.device("cuda")
    work = ROOT / "chiprun_out" / "calibrate"
    out = {"workload": args.workload, "seconds": seconds, "program": [],
           "control": [], "half_batch": [], "program_leaves": [],
           **{f: [] for f in FAULTS}}
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        res = harness.run_cell(spec, seed, seconds, False, "cuda",
                               time.perf_counter(), work, keep=True)
        row = dict(seed=seed, iter_ms=res.get("iter_ms"),
                   setup_s=res["setup_s"], failure=res["failure"],
                   **res.get("compared", {}))
        out["program"].append(row)
        print("program", json.dumps(row), flush=True)
        if i < args.control and res["failure"] is None:
            for key, nums in in_place(c, res, dev).items():
                out[key].append(dict(seed=seed, **nums))
                print(key, json.dumps(out[key][-1]), flush=True)
        del res
    for fault, kw in FAULTS.items():
        for i in range(args.faults):
            seed = args.first_seed + 7919 * i
            with sampler_fault(train, **kw):
                res = harness.run_cell(spec, seed, seconds, False, "cuda",
                                       time.perf_counter(), work)
            row = dict(seed=seed, failure=res["failure"],
                       **res.get("compared", {}))
            out[fault].append(row)
            print(fault, json.dumps(row), flush=True)
    summary = {}
    numbers = {k for r in out["program"] for k in r} - {
        "seed", "iter_ms", "setup_s", "failure"}
    for k in sorted(numbers):
        prog = [r[k] for r in out["program"] if k in r]
        bad = {kind: min((r[k] for r in out[kind] if k in r), default=None)
               for kind in ("control", "half_batch", *FAULTS)}
        summary[k] = dict(lower=max(prog, default=None), **bad)
    out["summary"] = summary
    print("summary", json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
