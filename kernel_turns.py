#!/usr/bin/env python3
"""Time the port's kernels of two trees on one GPU, in turns (A, B, B, A),
on the same inputs.

    python3 kernel_turns.py PARENT_ROOT CHANGE_ROOT [--out FILE]

Each turn is a fresh process that imports ``fermiflow_tpu_torch`` from its
tree (building that tree's kernels at first use) and times, at the paths'
shapes (N=6, B=8192, d_eta=d_mu=50, dopri5 with 4 steps; (512, 300)
partials; 30 Metropolis steps):
- ``hessian_flow_cm``: CUDA events over 20 launches, three times;
- ``reinforce_partials`` (the adjoint pass) on the Hessian flow's x and g
  with seeded weights: CUDA events over 20 launches, three times;
- ``block_sum`` and ``Tensor.sum`` on the partials: CUDA-graph replay of
  50 launches (device only) and 50 back-to-back calls (dispatch-inclusive);
- the three sampler entries on their own Philox stream with one fixed seed,
  on walkers that the plain samplers equilibrated (the same walkers in
  every turn): ``metropolis_chains`` (10 segments, tau adapted between
  them), ``metropolis_single_cm`` and ``metropolis_multistate_cm`` (54
  states of the deltaE = 2 table, Hermite depth 5): CUDA events over 20
  launches, three times;
- the two Slater VGH kernels on the same equilibrated walkers:
  ``slater_vgh_cm`` on the ground-state walkers and ``slater_vgh_ms_cm`` on
  the mixed-state walkers in their states: CUDA-graph replay of 50 launches
  (device only), three times.
It also saves its outputs (the Hessian flow's, the reduce's, the gradient
and z_back of ``reinforce_cm``, each sampler's and each VGH kernel's), so
that the summary can hold the trees' results against each other (relative
to each output's largest entry: the flow's inputs are Gaussian walkers, not
equilibrated ones, so H runs large; for the samplers, the share of walkers
whose chain diverged and the largest |dx| on the rest; for the VGH kernels,
y, g and H each, and whether all three are bitwise equal) and each tree's
two turns bitwise.  The summary goes to standard output and, as JSON, to
``--out``.
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
MCMC_STEPS, SEGMENTS = 30, 10
SEED = 1234
HERE = os.path.dirname(os.path.abspath(__file__))
# The N=6 spin-polarized ground state's orbitals (HO2D order).
GS_OCC = dict(nx_occ=(0, 0, 1, 0, 1, 2), ny_occ=(0, 1, 0, 2, 1, 0),
              num_shells=3)


def sampler_inputs(torch, dev):
    """Walkers equilibrated by the plain samplers (deterministic: the same
    in every turn and tree): GS walkers and their adapted tau, and walkers
    in uniformly drawn deltaE = 2 states with the states' quantum numbers."""
    from fermiflow_tpu_torch.ops import metropolis as mp
    from fermiflow_tpu_torch.physics import HO2D

    gen = torch.Generator(device=dev).manual_seed(SEED)
    f32 = dict(device=dev, dtype=torch.float32)
    x0 = torch.randn((2 * N, BATCH), generator=gen, **f32)
    xs, _, _, tau = mp.metropolis_chains_plain(
        x0, torch.full((BATCH,), 0.1, **f32), 0, steps=MCMC_STEPS,
        segments=SEGMENTS, generator=gen, **GS_OCC)
    orb = HO2D()
    table, _ = orb.fermion_states(N, 0, 2.0)
    ks = int(max(orb.nx[table].max(), orb.ny[table].max())) + 1
    idx = torch.randint(0, table.shape[0], (BATCH,), generator=gen,
                        device=dev)
    occ = torch.as_tensor(table, device=dev).long()[idx]
    nx, ny = (torch.as_tensor(q, device=dev)[occ].T.to(torch.int32)
              .contiguous() for q in (orb.nx, orb.ny))
    ms = dict(nx_cm=nx, ny_cm=ny, num_shells=ks)
    z = torch.randn((2 * N, BATCH), generator=gen, **f32)
    z, _, _ = mp.metropolis_multistate_cm_plain(
        z, torch.full((BATCH,), 0.2, **f32), 0, steps=10 * MCMC_STEPS,
        generator=gen, **ms)
    return xs[-1].contiguous(), tau.contiguous(), z.contiguous(), ms


def time_samplers(torch, dev, cuda_ms, inputs):
    """{entry: [ms x 3]}, {entry: outputs}."""
    from fermiflow_tpu_torch.ops import metropolis as mp

    z_gs, tau_gs, z_ms, ms = inputs
    tau01 = torch.full((BATCH,), 0.1, device=dev)
    calls = {
        "metropolis_chains": lambda: mp.metropolis_chains(
            z_gs, tau_gs, SEED, steps=MCMC_STEPS, segments=SEGMENTS,
            **GS_OCC),
        "metropolis_single": lambda: mp.metropolis_single_cm(
            z_gs, tau01, SEED, steps=MCMC_STEPS, **GS_OCC),
        "metropolis_multistate": lambda: mp.metropolis_multistate_cm(
            z_ms, tau01, SEED, steps=MCMC_STEPS, **ms),
    }
    times = {k: [cuda_ms(fn, 20) for _ in range(3)] for k, fn in calls.items()}
    outs = {k: [t.cpu() for t in fn()] for k, fn in calls.items()}
    return times, outs


def time_vgh(graph_ms, inputs):
    """{entry: [graph-replay ms x 3]}, {entry: [y, g, H]} of the two Slater
    VGH kernels on the equilibrated walkers of ``sampler_inputs``."""
    from fermiflow_tpu_torch.ops import slater_vgh as sv

    z_gs, _, z_ms, ms = inputs
    calls = {
        "slater_vgh": lambda: sv.slater_vgh_cm(z_gs, **GS_OCC),
        "slater_vgh_ms": lambda: sv.slater_vgh_ms_cm(
            z_ms, ms["nx_cm"], ms["ny_cm"], ms["num_shells"]),
    }
    # graph_ms replays the captured launches and checks their last H.
    times = {k: [graph_ms(lambda: fn()[2])[0] for _ in range(3)]
             for k, fn in calls.items()}
    outs = {k: [t.cpu() for t in fn()] for k, fn in calls.items()}
    return times, outs


def measure(root: str, save: str) -> dict:
    """One turn: time the kernels of the tree at ``root``."""
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
    y, g, H = slater_vgh_cm_plain(x, **GS_OCC)
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
    inputs = sampler_inputs(torch, dev)
    sampler_ms, sampler_out = time_samplers(torch, dev, cuda_ms, inputs)
    vgh_ms, vgh_out = time_vgh(graph_ms, inputs)
    res = dict(
        root=root, hessian_flow_ms=hf_ms, reinforce_adjoint_ms=rf_ms,
        reduce_graph_ms=red_graph, sum_graph_ms=sum_graph,
        reduce_dispatch_ms=cuda_ms(lambda: block_sum(parts), 50),
        sum_dispatch_ms=cuda_ms(lambda: parts.sum(0), 50),
        sampler_ms=sampler_ms, vgh_graph_ms=vgh_ms)
    torch.save({"hflow": [t.cpu() for t in out], "rows": rows.cpu(),
                "reinforce": [flat.cpu(), z_back.cpu()],
                "samplers": sampler_out, "vgh": vgh_out}, save)
    return res


def chains_agreement(parent: list, change: list) -> dict:
    """Share of walkers (the last axis) whose positions (the first output)
    differ by more than 1e-4, the largest |dx| on the rest, and the largest
    |d| of the other outputs on the rest."""
    import torch

    px, cx = parent[0].double(), change[0].double()
    err = (px - cx).abs().reshape(-1, px.shape[-1]).amax(dim=0)
    agree = err <= 1e-4
    rest = [float((p.double() - c.double())[..., agree].abs().max())
            for p, c in zip(parent[1:], change[1:])]
    return dict(diverged=1.0 - float(agree.double().mean()),
                max_dx_agreeing=float(err[agree].max()),
                max_d_other_outputs=rest,
                bitwise=all(torch.equal(p, c) for p, c in zip(parent, change)))


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
                  f"{res['sum_dispatch_ms']:.6f}); samplers ms "
                  f"{json.dumps(res['sampler_ms'])}; VGH graph ms "
                  f"{json.dumps(res['vgh_graph_ms'])}", flush=True)
    outs = [t.pop("outputs") for t in turns]

    def sampler_lists(o):
        return [t for key in ("samplers", "vgh")
                for entry in o[key].values() for t in entry]

    same_tree = all(
        all(torch.equal(u, v)
            for key in ("hflow", "reinforce")
            for u, v in zip(outs[i][key], outs[j][key]))
        and torch.equal(outs[i]["rows"], outs[j]["rows"])
        and all(torch.equal(u, v) for u, v in zip(sampler_lists(outs[i]),
                                                 sampler_lists(outs[j])))
        for i, j in ((0, 3), (1, 2)))
    # Parent against change, max |difference| / max |parent| per output.
    pairs = dict(zip(("x", "logp", "g", "H"),
                     zip(outs[0]["hflow"], outs[1]["hflow"])))
    pairs["reduce"] = (outs[0]["rows"], outs[1]["rows"])
    pairs.update(zip(("reinforce_grads", "z_back"),
                     zip(outs[0]["reinforce"], outs[1]["reinforce"])))
    rel = {k: float((p.double() - c.double()).abs().max()
                    / p.double().abs().max()) for k, (p, c) in pairs.items()}
    # Each sampler entry of the parent against the change's.
    chains = {entry: chains_agreement(outs[0]["samplers"][entry], got)
              for entry, got in outs[1]["samplers"].items()}
    # Each VGH kernel's y, g and H, parent against change.
    vgh = {entry: dict(
        rel={k: float((p.double() - c.double()).abs().max()
                      / p.double().abs().max())
             for k, p, c in zip(("y", "g", "H"), outs[0]["vgh"][entry], got)},
        bitwise=all(torch.equal(p, c)
                    for p, c in zip(outs[0]["vgh"][entry], got)))
        for entry, got in outs[1]["vgh"].items()}
    summary = dict(card=smi, turns=turns, same_tree_bitwise=same_tree,
                   parent_vs_change_rel=rel,
                   sampler_parent_vs_change=chains,
                   vgh_parent_vs_change=vgh)
    print(f"card: {smi}")
    print(f"each tree's two turns bitwise equal: {same_tree}; parent vs "
          f"change, max|d| / max|parent|: {json.dumps(rel)}")
    for key, v in chains.items():
        print(f"sampler parent vs change {key}: diverged walkers "
              f"{v['diverged']:.3e}, max|dx| on the rest "
              f"{v['max_dx_agreeing']:.3e}, other outputs max|d| "
              f"{v['max_d_other_outputs']}, bitwise {v['bitwise']}")
    for key, v in vgh.items():
        print(f"VGH parent vs change {key}: max|d| / max|parent| "
              f"{json.dumps(v['rel'])}, bitwise {v['bitwise']}")
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as fh:
            json.dump(summary, fh, indent=1)
    print(json.dumps(summary))
    return 0 if same_tree else 1


if __name__ == "__main__":
    sys.exit(main())
