"""Independent energy evaluation at a trained ground-state checkpoint (port
of ``validation/eval_at_checkpoint.py``).

Restores a checkpoint of the port's ground-state CLI, starts FRESH chains
(Gaussian walkers, ``--equil`` fixed-tau Metropolis steps at tau = 0.1 on
the base density, by ``FreeFermion.sample(use_pallas=True)``: the
single-chain sampler kernel for a polarized float32 run, else the plain
``mcmc.metropolis``; no persistent chain) and estimates E on them with one
of two engines:

* ``hessian_flow``: ``GSVMC.local_energy_from_base`` on the kernel route
  (the Slater-VGH and Hessian-flow kernels on the card);
* ``nested_jvp``: x = ``cnf.generate`` of the walkers, then
  ``GSVMC.local_energy`` (nested forward derivatives through the reverse
  ODE), independent of both kernels.

So it cross-checks the persistent sampler's stationarity and the training
estimator against the same wavefunction.  ``--reps`` rounds of fresh chains
are pooled.

    python -m fermiflow_tpu_torch.cli.eval_at_checkpoint \\
        --ckpt validation/ck/torch_gs_n6_z05_ode4 --nup 6 --Z 0.5 \\
        --batch 8192 --equil 600 --reps 8 --ode-steps 4 \\
        --out validation/runs/torch_eval_gs_n6_z05_ode4_hessian_flow.json

The JAX script's flags, plus ``--device`` (``cuda`` unless ``--device
cpu``), ``--seed`` and the training run's ``--ode-steps``, ``--Deta``
and ``--Dmu``.  The output JSON has the JAX
script's keys.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from fermiflow_tpu_torch.cli import common
from fermiflow_tpu_torch.config import Config
from fermiflow_tpu_torch.train import init_gs_state
from fermiflow_tpu_torch.utils.checkpointing import restore_checkpoint
from fermiflow_tpu_torch.vmc.gs import _detach

__all__ = ["main", "restore_model", "fresh_walkers", "local_energies",
           "evaluate"]

ENGINES = ("hessian_flow", "nested_jvp")
TAU = 0.1


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Fresh-chain energy of a ground-state checkpoint")
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--nup", type=int, default=6)
    p.add_argument("--ndown", type=int, default=0)
    p.add_argument("--Z", type=float, required=True)
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--train-batch", type=int, default=8192)
    p.add_argument("--equil", type=int, default=600)
    p.add_argument("--reps", type=int, default=8,
                   help="independent fresh-chain rounds to pool")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "float64"])
    p.add_argument("--engine", type=str, default="hessian_flow",
                   choices=list(ENGINES))
    p.add_argument("--out", type=str, required=True)
    d = Config()
    p.add_argument("--ode-steps", type=int, default=d.ode_steps,
                   help="the training run's --ode-steps")
    p.add_argument("--Deta", type=int, default=d.d_eta,
                   help="the training run's --Deta")
    p.add_argument("--Dmu", type=int, default=d.d_mu,
                   help="the training run's --Dmu")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--seed", type=int, default=0,
                   help="round r draws from seed + 1000 + r")
    return p


def restore_model(ckpt: str, nup: int, ndown: int, Z: float,
                  train_batch: int, dtype: str = "float32",
                  ode_steps: int = 4, device: str = "cuda", d_eta: int = 50,
                  d_mu: int = 50):
    """(model, detached flow params, step) of ``ckpt``'s latest checkpoint,
    restored into the state of a ``train_batch``-walker ground-state run.
    The nested-jvp engine takes the whole batch in one call: the JAX
    script's 256 walkers a call bounded a TPU's memory, and on the card
    made a call per 256 walkers (20x slower; N = 10 at batch 4096 peaks at
    ~21 GiB whole)."""
    cfg = Config(nup=nup, ndown=ndown, Z=Z, batch=train_batch, dtype=dtype,
                 ode_steps=ode_steps, device=device, d_eta=d_eta, d_mu=d_mu)
    model, params0 = common.build_gs(cfg)
    state = init_gs_state(model, params0, cfg, params0["eta"]["w1"].device)
    state, step = restore_checkpoint(ckpt, state)
    if step == 0:
        raise FileNotFoundError(f"no checkpoint in {ckpt}")
    return model, _detach(state.params), step


def fresh_walkers(model, generator: torch.Generator, batch: int, equil: int,
                  dtype=torch.float32):
    """Gaussian walkers (batch, n, dim) after ``equil`` Metropolis steps at
    tau = 0.1 on the base density, every draw from ``generator`` (on its
    device), through ``FreeFermion.sample``'s kernel route; returns
    (walkers, mean acceptance)."""
    z, acc = model.basedist.sample(
        model.occ_up, model.occ_down, generator, (batch,),
        equilibrium_steps=equil, tau=TAU, dtype=dtype, use_pallas=True,
        return_accept=True)
    return z, float(acc.mean())


def local_energies(model, params, z: torch.Tensor, engine: str):
    """Per-walker local energies of base walkers z (batch, n, dim)."""
    with torch.no_grad():
        if engine == "hessian_flow":
            return model.local_energy_from_base(params, z, chain=True)[1]
        if engine == "nested_jvp":
            return model.local_energy(params, model.cnf.generate(params, z))[0]
    raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")


def evaluate(model, params, engine: str, batch: int, equil: int, reps: int,
             seed: int = 0, dtype=torch.float32, device="cuda",
             verbose: bool = True) -> np.ndarray:
    """Every round's local energies, pooled (float64, reps * batch)."""
    elocs = []
    for r in range(reps):
        gen = torch.Generator(device).manual_seed(seed + 1000 + r)
        z, acc = fresh_walkers(model, gen, batch, equil, dtype)
        eloc = local_energies(model, params, z, engine)
        elocs.append(eloc.double().cpu().numpy())
        if verbose:
            print(f"round {r}: E={elocs[-1].mean():.5f} acc={acc:.3f}",
                  flush=True)
    return np.concatenate(elocs)


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    t0 = time.time()
    model, params, step = restore_model(
        args.ckpt, args.nup, args.ndown, args.Z, args.train_batch,
        args.dtype, args.ode_steps, args.device, args.Deta, args.Dmu)
    print(f"restored step {step}", flush=True)
    device = params["eta"]["w1"].device
    el = evaluate(model, params, args.engine, args.batch, args.equil,
                  args.reps, args.seed, params["eta"]["w1"].dtype, device)
    res = {
        "ckpt": args.ckpt, "step": int(step), "nup": args.nup, "Z": args.Z,
        "engine": args.engine, "batch": args.batch, "equil": args.equil,
        "reps": args.reps, "n_total": int(el.size),
        "E": float(el.mean()), "E_std": float(el.std()),
        "E_sem": float(el.std() / np.sqrt(el.size)),
    }
    where = "cpu"
    if device.type == "cuda":
        where = (f"{torch.cuda.get_device_name(device)}, peak "
                 f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    print(f"evaluated on {where} in {time.time() - t0:.3f} s", flush=True)
    print(json.dumps(res))
    with open(args.out, "w") as fh:
        json.dump(res, fh, indent=1)
    return res


if __name__ == "__main__":
    main()
