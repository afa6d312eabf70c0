"""Fermi-liquid -> Wigner-molecule crossover diagnostics at a trained
ground-state checkpoint (port of ``validation/crossover_analysis.py``).

Restores a checkpoint of the port's ground-state CLI, draws ``--walkers``
base walkers z ~ |det|^2 (Gaussian start, ``--equil`` fixed-tau Metropolis
steps at tau = 0.1, through ``FreeFermion.sample(use_pallas=True)``: the
single-chain sampler kernel for a polarized float32 run), transports them
with ``CNF.generate`` (x = flow(z), the transport the estimator uses) and
measures the structure of |Psi|^2 on x:

- the radial one-body density n(r), normalised so that
  2 pi int r n(r) dr = N (shell structure -> ring localisation),
- the pair-distance distribution g(r) (the short-range hole deepens with Z),
- rms r, the mean pair distance, <V_int> = Z <sum 1/r_ij> and
  <V_trap> = <sum x^2 / 2>.

    python -m fermiflow_tpu_torch.cli.crossover_analysis \\
        --ckpt validation/ck/torch_gs_n6_z80 --nup 6 --Z 8.0 \\
        --walkers 32768 --ode-steps 8 --out validation/runs/torch_xover_z80.json

The JAX script's flags, plus ``--device`` (``cuda`` unless ``--device
cpu``), ``--seed`` and the training run's ``--ode-steps``, ``--Deta`` and
``--Dmu``; the output JSON has the JAX script's keys and ``n0`` (n(r) in
the first bin), ``norm_integral`` (2 pi sum r n(r) dr) and
``inside_fraction`` (the share of particle positions with r <= rmax, the
histograms' range).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from fermiflow_tpu_torch.cli.eval_at_checkpoint import TAU, restore_model
from fermiflow_tpu_torch.config import Config

__all__ = ["main", "pair_observables", "structure", "draw"]


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Structure of |Psi|^2 at a ground-state checkpoint")
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--nup", type=int, default=6)
    p.add_argument("--ndown", type=int, default=0)
    p.add_argument("--Z", type=float, required=True)
    p.add_argument("--walkers", type=int, default=32768)
    p.add_argument("--train-batch", type=int, default=8192,
                   help="batch the checkpoint was trained with (walker-buffer "
                        "shape must match to restore)")
    p.add_argument("--equil", type=int, default=600)
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "float64"])
    p.add_argument("--rmax", type=float, default=6.0)
    p.add_argument("--bins", type=int, default=120)
    p.add_argument("--out", type=str, required=True)
    d = Config()
    p.add_argument("--ode-steps", type=int, default=d.ode_steps,
                   help="the training run's --ode-steps")
    p.add_argument("--Deta", type=int, default=d.d_eta,
                   help="the training run's --Deta")
    p.add_argument("--Dmu", type=int, default=d.d_mu,
                   help="the training run's --Dmu")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--seed", type=int, default=7)
    return p


def pair_observables(x: torch.Tensor, Z: float):
    """Per-walker arrays of flow-transported walkers x (B, n, dim), in x's
    dtype on its device: r (B, n), the pair distances (B, n (n - 1) / 2) in
    ``torch.triu_indices`` order, V_int = Z sum 1/r_ij (B,) and
    V_trap = sum x^2 / 2 (B,)."""
    n = x.shape[-2]
    r = torch.linalg.norm(x, dim=-1)
    diff = x[:, :, None, :] - x[:, None, :, :]
    # The identity on the diagonal keeps |x_i - x_i| off zero, as the JAX
    # script does; the diagonal is dropped below.
    eye = torch.eye(n, dtype=x.dtype, device=x.device)[..., None]
    iu = torch.triu_indices(n, n, offset=1, device=x.device)
    pair = torch.linalg.norm(diff + eye, dim=-1)[:, iu[0], iu[1]]
    v_int = Z * torch.sum(1.0 / pair, dim=-1)
    v_trap = 0.5 * torch.sum(x**2, dim=(-2, -1))
    return r, pair, v_int, v_trap


def structure(x: torch.Tensor, Z: float, rmax: float = 6.0,
              bins: int = 120) -> dict:
    """The crossover record of walkers x (B, n, dim): the JAX script's
    summary keys, n(r) and g(r) on ``np.linspace(0, rmax, bins + 1)``, and
    ``n0``, ``norm_integral``, ``inside_fraction`` (module docstring)."""
    r, pair, v_int, v_trap = (a.cpu().numpy()
                              for a in pair_observables(x, Z))
    edges = np.linspace(0.0, rmax, bins + 1)
    hist_r, _ = np.histogram(r.ravel(), bins=edges)
    centers = 0.5 * (edges[1:] + edges[:-1])
    area = 2 * np.pi * centers * np.diff(edges)
    B = r.shape[0]
    n_of_r = hist_r / (area * B)
    hist_pair, _ = np.histogram(pair.ravel(), bins=edges)
    g_of_r = hist_pair / (area * pair.shape[0])
    return {
        "walkers": B,
        "mean_r": float(r.mean()), "rms_r": float(np.sqrt((r**2).mean())),
        "mean_pair_distance": float(pair.mean()),
        "V_int": float(v_int.mean()),
        "V_int_sem": float(v_int.std() / np.sqrt(B)),
        "V_trap": float(v_trap.mean()),
        "V_trap_sem": float(v_trap.std() / np.sqrt(B)),
        "r_edges": edges.tolist(),
        "n_of_r": n_of_r.tolist(),
        "g_of_r": g_of_r.tolist(),
        "n0": float(n_of_r[0]),
        "norm_integral": float(np.sum(area * n_of_r)),
        "inside_fraction": float(np.mean(r <= rmax)),
    }


def draw(model, params, generator: torch.Generator, walkers: int, equil: int,
         dtype=torch.float32):
    """(z, x, mean acceptance): ``walkers`` base walkers from the kernel
    route, and x = flow(z)."""
    z, acc = model.basedist.sample(
        model.occ_up, model.occ_down, generator, (walkers,),
        equilibrium_steps=equil, tau=TAU, dtype=dtype, use_pallas=True,
        return_accept=True)
    with torch.no_grad():
        x = model.cnf.generate(params, z)
    return z, x, float(acc.mean())


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    t0 = time.time()
    model, params, step = restore_model(
        args.ckpt, args.nup, args.ndown, args.Z, args.train_batch,
        args.dtype, args.ode_steps, args.device, args.Deta, args.Dmu)
    device = params["eta"]["w1"].device
    gen = torch.Generator(device).manual_seed(args.seed)
    _, x, acc = draw(model, params, gen, args.walkers, args.equil,
                     params["eta"]["w1"].dtype)
    rec = {"Z": args.Z, "nup": args.nup, "ckpt_step": int(step)}
    rec.update(structure(x, args.Z, args.rmax, args.bins))
    where = "cpu"
    if device.type == "cuda":
        where = (f"{torch.cuda.get_device_name(device)}, peak "
                 f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    print(f"restored step {step}; acceptance {acc:.4f}; measured on {where} "
          f"in {time.time() - t0:.3f} s", flush=True)
    with open(args.out, "w") as fh:
        fh.write(json.dumps(rec) + "\n")
    centers = 0.5 * (np.asarray(rec["r_edges"][1:])
                     + np.asarray(rec["r_edges"][:-1]))
    peak = centers[int(np.argmax(rec["n_of_r"]))]
    print(json.dumps({k: rec[k] for k in
                      ("Z", "rms_r", "mean_pair_distance", "V_int", "V_trap",
                       "n0", "norm_integral", "inside_fraction")}
                     | {"n_of_r_peak_r": float(peak)}))
    return rec


if __name__ == "__main__":
    main()
