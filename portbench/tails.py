"""The seed-to-seed tail of the trained gradient's gap, looked at with the
reference (PERF.md, How ``correct`` is decided).

For each seed the cell runs as ``harness.run_cell`` runs it, and the
iteration that closed the window is rerun by the reference in float64 and
in plain float32 (no TF32), walker by walker: each walker's local energy,
the size of its kinetic terms, K = |lap log p| / 4 + |grad log p|^2 / 8,
which cancel where a walker nears a node of the determinant, and its
float32 error.  The gradient's worst-leaf gap is read as it is
(``grad_leaf``) and as a multiple of the float32 reference's (``f32x``,
the number ``check.py`` compares), for the program, the control (TF32
products) and half of the batch.  It prints one JSON line for each seed.

    python3 portbench/tails.py --workload gs_n6.persistent_k10 \\
        --seeds 59459463 6100000001 --out chiprun_out/tails.jsonl
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

import check  # noqa: E402
import harness  # noqa: E402
import reference  # noqa: E402


def walker_terms(model, p: dict, z, s, block: int = 2048):
    """(eloc, K) of every walker: its local energy and the size of its two
    kinetic terms."""
    flow = reference._flow(p)
    out = []
    with torch.no_grad():
        for lo in range(0, z.shape[0], block):
            zb = z[lo:lo + block]
            nx, ny = model.qnums(s[lo:lo + block])
            y0, g0, H0 = reference.slater_vgh(zb, nx, ny, model.num)
            x, _, g, H = reference.flow_forward(flow, zb, y0, g0, H0,
                                                model.steps)
            lap = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
            gg = torch.sum(g * g, -1)
            eloc = -0.25 * lap - 0.125 * gg + reference.potential(x, model.Z)
            out.append((eloc, 0.25 * lap.abs() + 0.125 * gg))
    return tuple(torch.cat(t) for t in zip(*out))


def look(spec: dict, seed: int, seconds: float, dev) -> dict:
    c = harness.shapes(spec)
    model = reference.Model(c)
    res = harness.run_cell(spec, seed, seconds, False, dev.type,
                           time.perf_counter(), ROOT / "chiprun_out" / "tails",
                           keep=True)
    out = dict(seed=seed, failure=res["failure"], iters=res["attempted"],
               compared=res.get("compared"))
    if res["failure"] is not None:
        return out
    snap = res["judged"]
    p, _ = check.undo_step(snap, c["lr"], dev)
    (z, s), = check.reference_inputs([(snap["z_cm"], snap["states"])],
                                     c["nup"], torch.float64, dev)
    e64, K = walker_terms(model, p, z, s)
    e32, _ = walker_terms(model, {k: v.float() for k, v in p.items()},
                          z.float(), s)
    err = (e32.double() - e64).abs()
    order = torch.argsort(K, descending=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=order.device)
    worst = int(torch.argmax(err))
    out.update(K_median=float(K.median()),
               K_top=[float(K[i]) for i in order[:3]],
               e32_err_of_K_top=[float(err[i]) for i in order[:3]],
               e32_err_worst=float(err[worst]),
               e32_err_worst_K_rank=int(rank[worst]))
    ref = check.rerun(c, snap, torch.float64, dev)[1]
    f32 = check.leaf_gap(check.rerun_f32(c, snap, dev), ref)
    sides = {"program": {k: g for k, g in snap["grad"].items()
                         if g is not None},
             "half_batch": check.rerun(c, snap, torch.float64, dev,
                                       halve=True)[1]}
    with reference.tf32_products():
        sides["control"] = check.rerun(c, snap, torch.float32, dev)[1]
    out["ref_f32.grad_leaf"] = f32
    for name, g in sides.items():
        out[f"{name}.grad_leaf"] = check.leaf_gap(g, ref)
        out[f"{name}.f32x"] = out[f"{name}.grad_leaf"] / max(f32,
                                                             check.F32_FLOOR)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=None)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = (harness.cell_spec(ROOT, args.workload)
            if any(w["name"] == args.workload for w in bench["workloads"])
            else harness.kept_out_spec(args.workload))
    dev = torch.device("cuda")
    fh = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        row = dict(workload=args.workload,
                   **look(spec, seed, args.seconds or bench["run_seconds"],
                          dev))
        print(json.dumps(row), flush=True)
        if fh:
            fh.write(json.dumps(row) + "\n")
            fh.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
