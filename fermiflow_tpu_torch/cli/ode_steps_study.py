"""Error against the ODE grid at trained parameters (port of
``validation/ode_steps_study.py``).

Restores a ground-state checkpoint of the port's CLI (float32 parameters),
casts the parameters to float64 and draws a fixed batch of equilibrated
base walkers (200 fixed-tau Metropolis steps at tau = 0.1, float64, the
plain sampler).  For each fixed dopri5 grid of ``--steps`` it measures,
against a 256-step grid on the same walkers:

- |dE|, the error of the batch mean of Eloc, and the largest per-walker
  |dEloc|;
- the cosine and the relative L2 error of the loss gradient.

Eloc is ``GSVMC.local_energy_from_base`` (the plain Hessian flow) and the
gradient autograd of ``GSVMC.loss_and_metrics_from_base``, all in float64:
the CUDA kernels run in float32 only, so this is the plain path on the
device asked for (the JAX script pins the CPU).

    python -m fermiflow_tpu_torch.cli.ode_steps_study \\
        --ckpt validation/ck/torch_gs_n6_z80 --nup 6 --Z 8.0 --batch 256 \\
        --out validation/runs/torch_ode_steps_z80.json

The JAX script's flags, plus ``--device`` (``cuda`` unless ``--device
cpu``), ``--seed``, ``--train-batch``, ``--Deta`` and ``--Dmu``; the
output JSON has the JAX script's keys, and each row also ``E``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from fermiflow_tpu_torch.cli import common
from fermiflow_tpu_torch.cli.eval_at_checkpoint import restore_model
from fermiflow_tpu_torch.config import Config
from fermiflow_tpu_torch.physics import (
    HO2D,
    CoulombPairPotential,
    FreeFermion,
    HOPotential,
)
from fermiflow_tpu_torch.vmc import GSVMC

__all__ = ["main", "make_model", "observables", "study", "REFERENCE_GRID"]

# A 256-step grid (error ~(1/256)^5 a step, far below f64 noise) is the
# yardstick, as in the JAX study.
REFERENCE_GRID = 256


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Error against the ODE grid at a ground-state checkpoint")
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--nup", type=int, default=6)
    p.add_argument("--Z", type=float, default=0.5)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--steps", type=int, nargs="+",
                   default=[2, 4, 8, 16, 32, 64])
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--train-batch", type=int, default=8192,
                   help="batch the checkpoint was trained with")
    d = Config()
    p.add_argument("--Deta", type=int, default=d.d_eta,
                   help="the training run's --Deta")
    p.add_argument("--Dmu", type=int, default=d.d_mu,
                   help="the training run's --Dmu")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--seed", type=int, default=7)
    return p


def make_model(nup: int, Z: float, steps: int) -> GSVMC:
    """The polarized ground-state model on a ``steps``-step fixed dopri5
    grid, built here because ``common.build_gs`` refuses float64 on the
    card."""
    cnf = common.make_cnf(Config(nup=nup, Z=Z, ode_steps=steps))
    return GSVMC(nup, 0, FreeFermion(HO2D()), cnf, CoulombPairPotential(Z),
                 HOPotential())


def observables(model: GSVMC, params: dict, z: torch.Tensor):
    """(per-walker Eloc, flat loss gradient) as float64 numpy arrays; the
    gradient's leaves in the JAX tree order (module, then sorted leaf)."""
    with torch.no_grad():
        _, eloc, _ = model.local_energy_from_base(params, z)
    p = {m: None if v is None else
         {k: t.detach().clone().requires_grad_(True) for k, t in v.items()}
         for m, v in params.items()}
    loss, _ = model.loss_and_metrics_from_base(p, z)
    leaves = [p[m][k] for m in sorted(p) if p[m] is not None
              for k in sorted(p[m])]
    grads = torch.autograd.grad(loss, leaves)
    return (eloc.double().cpu().numpy(),
            torch.cat([g.reshape(-1) for g in grads]).double().cpu().numpy())


def study(params: dict, z: torch.Tensor, nup: int, Z: float, steps,
          reference_grid: int = REFERENCE_GRID, verbose: bool = False) -> dict:
    """The JAX study's rows for each grid of ``steps`` against
    ``reference_grid`` on the same walkers z (B, n, dim)."""
    eloc_ref, g_ref = observables(make_model(nup, Z, reference_grid), params,
                                  z)
    results = {"reference_grid": reference_grid,
               "E_ref": float(eloc_ref.mean()), "batch": int(z.shape[0]),
               "rows": []}
    for s in steps:
        eloc, g = observables(make_model(nup, Z, s), params, z)
        row = {
            "ode_steps": s, "E": float(eloc.mean()),
            "dE": float(abs(eloc.mean() - eloc_ref.mean())),
            "max_dEloc": float(np.max(np.abs(eloc - eloc_ref))),
            "grad_cosine": float(np.dot(g, g_ref) / (np.linalg.norm(g)
                                                     * np.linalg.norm(g_ref))),
            "grad_rel_err": float(np.linalg.norm(g - g_ref)
                                  / np.linalg.norm(g_ref)),
        }
        results["rows"].append(row)
        if verbose:
            print(row, flush=True)
    results["mc_sem_at_batch8192"] = float(eloc_ref.std() / np.sqrt(8192))
    results["mc_sem_at_batch"] = float(eloc_ref.std() / np.sqrt(z.shape[0]))
    return results


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    # Restore the trained float32 parameters, then cast them to float64.
    _, params32, step = restore_model(
        args.ckpt, args.nup, 0, args.Z, args.train_batch, "float32",
        device=args.device, d_eta=args.Deta, d_mu=args.Dmu)
    params = {m: None if v is None else
              {k: t.double() for k, t in v.items()}
              for m, v in params32.items()}
    print(f"restored step {step} from {args.ckpt}", flush=True)
    device = params["eta"]["w1"].device
    gen = torch.Generator(device).manual_seed(args.seed)
    base = make_model(args.nup, args.Z, REFERENCE_GRID)
    z = base.basedist.sample(base.occ_up, base.occ_down, gen, (args.batch,),
                             equilibrium_steps=200, tau=0.1,
                             dtype=torch.float64)
    results = study(params, z, args.nup, args.Z, args.steps, verbose=True)
    results["ckpt_step"] = int(step)
    results["device"] = (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu")
    with open(args.out, "w") as fh:
        json.dump(results, fh, indent=1)
    print(f"MC sem at this batch: {results['mc_sem_at_batch']:.2e}; saved "
          f"{args.out}")
    return results


if __name__ == "__main__":
    main()
