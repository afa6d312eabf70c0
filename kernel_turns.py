#!/usr/bin/env python3
"""Time the Hessian-flow kernel and the REINFORCE adjoint and reduce passes
of two trees of the port on one GPU, in turns (A, B, B, A), on the same
inputs.

    python3 kernel_turns.py PARENT_ROOT CHANGE_ROOT [--out FILE]

Each turn is a fresh process that imports ``fermiflow_tpu_torch`` from its
tree (building that tree's kernels at first use) and times, at the paths'
shapes (N=6, B=8192, d_eta=d_mu=50, dopri5 with 4 steps; (512, 300)
partials):
- ``hessian_flow_cm``: CUDA events over 20 launches, three times;
- ``reinforce_partials`` (the adjoint pass) on the Hessian flow's x and g
  with seeded weights: CUDA events over 20 launches, three times;
- ``block_sum`` and ``Tensor.sum`` on the partials: CUDA-graph replay of
  50 launches (device only) and 50 back-to-back calls (dispatch-inclusive).
It also saves its outputs (the Hessian flow's, the reduce's, and the
gradient and z_back of ``reinforce_cm``), so that the summary can hold the
trees' results against each other (relative to each output's largest entry: the
inputs are Gaussian walkers, not equilibrated ones, so H runs large) and
each tree's two turns bitwise.  The
summary goes to standard output and, as JSON, to ``--out``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

N, BATCH, D_ETA, D_MU, ODE_STEPS = 6, 8192, 50, 50, 4
NBLOCKS, NQ = 512, 300  # the adjoint's partials at B=8192
SEED = 1234
HERE = os.path.dirname(os.path.abspath(__file__))


def measure(root: str, save: str) -> dict:
    """One turn: time the three kernels of the tree at ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import fermiflow_tpu_torch
    from fermiflow_tpu_torch.nn.backflow import backflow_init_gaussian
    from fermiflow_tpu_torch.ops import _build
    from fermiflow_tpu_torch.ops.hessian_flow import hessian_flow_cm
    from fermiflow_tpu_torch.ops.reinforce import (
        block_sum,
        reinforce_cm,
        reinforce_partials,
    )
    from fermiflow_tpu_torch.ops.slater_vgh import slater_vgh_cm_plain

    # The timing helpers of this tree's chip_smoke.py, whichever tree runs.
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cuda_ms, graph_ms = smoke.cuda_ms, smoke.graph_ms

    pkg = os.path.dirname(fermiflow_tpu_torch.__file__)
    if not pkg.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {pkg}, not the tree at {root}")
    _build.build_all()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn((2 * N, BATCH), generator=gen).to(dev)
    # The N=6 spin-polarized ground state's orbitals (HO2D order).
    y, g, H = slater_vgh_cm_plain(x, nx_occ=(0, 0, 1, 0, 1, 2),
                                  ny_occ=(0, 1, 0, 2, 1, 0), num_shells=3)
    params = backflow_init_gaussian(gen, D_ETA, D_MU, std=0.1,
                                    dtype=torch.float32, device="cpu")
    params = {k: {kk: t.to(dev) for kk, t in v.items()}
              for k, v in params.items()}
    parts = torch.randn((NBLOCKS, NQ), generator=gen).to(dev)
    ts = (0.0, 1.0, ODE_STEPS, "dopri5")
    hf = lambda: hessian_flow_cm(params, x, y, g, H, *ts)
    out = hf()
    hf_ms = [cuda_ms(hf, 20) for _ in range(3)]
    x1, g1 = out[0], out[2]
    w = (torch.randn((BATCH,), generator=gen) / BATCH).to(dev)
    rf_ms = [cuda_ms(lambda: reinforce_partials(params, x1, g1, w, *ts), 20)
             for _ in range(3)]
    grads, z_back = reinforce_cm(params, x1, g1, w, *ts)
    flat = torch.cat([grads[m][k].reshape(-1) for m in ("eta", "mu")
                      for k in ("w2", "w1", "b1")])
    red_graph, rows = graph_ms(lambda: block_sum(parts))
    sum_graph, _ = graph_ms(lambda: parts.sum(0))
    res = dict(
        root=root, hessian_flow_ms=hf_ms, reinforce_adjoint_ms=rf_ms,
        reduce_graph_ms=red_graph, sum_graph_ms=sum_graph,
        reduce_dispatch_ms=cuda_ms(lambda: block_sum(parts), 50),
        sum_dispatch_ms=cuda_ms(lambda: parts.sum(0), 50))
    torch.save({"hflow": [t.cpu() for t in out], "rows": rows.cpu(),
                "reinforce": [flat.cpu(), z_back.cpu()]}, save)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--out", default=None)
    ap.add_argument("--measure", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--save", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.measure:
        print(json.dumps(measure(a.measure, a.save)), flush=True)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("kernel_turns: needs a GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, root) in enumerate((("parent", a.parent),
                                           ("change", a.change),
                                           ("change", a.change),
                                           ("parent", a.parent))):
            save = os.path.join(tmp, f"{i}.pt")
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), a.parent,
                 a.change, "--measure", root, "--save", save],
                capture_output=True, text=True, cwd=HERE)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return 1
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            res["label"] = label
            res["outputs"] = torch.load(save)
            turns.append(res)
            print(f"turn {i} {label}: hessian_flow ms "
                  f"{res['hessian_flow_ms']}, reinforce_adjoint ms "
                  f"{res['reinforce_adjoint_ms']}, reduce graph {res['reduce_graph_ms']:.6f} ms (Tensor.sum "
                  f"{res['sum_graph_ms']:.6f}), dispatch-inclusive "
                  f"{res['reduce_dispatch_ms']:.6f} ms (Tensor.sum "
                  f"{res['sum_dispatch_ms']:.6f})", flush=True)
    outs = [t.pop("outputs") for t in turns]
    same_tree = all(
        all(torch.equal(u, v)
            for key in ("hflow", "reinforce")
            for u, v in zip(outs[i][key], outs[j][key]))
        and torch.equal(outs[i]["rows"], outs[j]["rows"])
        for i, j in ((0, 3), (1, 2)))
    # Parent against change, max |difference| / max |parent| per output.
    pairs = dict(zip(("x", "logp", "g", "H"),
                     zip(outs[0]["hflow"], outs[1]["hflow"])))
    pairs["reduce"] = (outs[0]["rows"], outs[1]["rows"])
    pairs.update(zip(("reinforce_grads", "z_back"),
                     zip(outs[0]["reinforce"], outs[1]["reinforce"])))
    rel = {k: float((p.double() - c.double()).abs().max()
                    / p.double().abs().max()) for k, (p, c) in pairs.items()}
    summary = dict(card=smi, turns=turns, same_tree_bitwise=same_tree,
                   parent_vs_change_rel=rel)
    print(f"card: {smi}")
    print(f"each tree's two turns bitwise equal: {same_tree}; parent vs "
          f"change, max|d| / max|parent|: {json.dumps(rel)}")
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as fh:
            json.dump(summary, fh, indent=1)
    print(json.dumps(summary))
    return 0 if same_tree else 1


if __name__ == "__main__":
    sys.exit(main())
