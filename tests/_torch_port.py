"""Shared inputs for the tests that hold ``fermiflow_tpu_torch`` against the
JAX package: seeded numpy data handed to both, and conversions between the
two parameter layouts (the same ``{"eta": mlp, "mu": mlp | None}`` dict).

Also the harness of the walker-mesh tests: ``run_ranks`` starts the ranks
of a gloo process group on the CPU, each in its own Python process (which
imports no JAX), and hands each the same jobs, functions of this module
that the tests also call in one process (``mesh=None``)."""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import torch

from fermiflow_tpu_torch.nn.backflow import params_from_jax, params_to_numpy

LEAVES = ("w2", "w1", "b1")


def np_params(seed, d_eta=8, d_mu=8, std=0.3, dtype=np.float64):
    """Gaussian backflow parameters (std 0.3: the flow is far from identity)."""
    rng = np.random.default_rng(seed)

    def mlp(h):
        return {
            "w1": (std * rng.standard_normal((1, h))).astype(dtype),
            "b1": (std * rng.standard_normal((h,))).astype(dtype),
            "w2": (std * rng.standard_normal((h, 1))).astype(dtype),
        }

    return {"eta": mlp(d_eta), "mu": None if d_mu is None else mlp(d_mu)}


def jax_params(p, dtype=None):
    import jax.numpy as jnp

    def conv(m):
        if m is None:
            return None
        return {k: jnp.asarray(v if dtype is None else v.astype(dtype))
                for k, v in m.items()}

    return {"eta": conv(p["eta"]), "mu": conv(p["mu"])}


def torch_params(p, dtype=torch.float64):
    return params_from_jax(p, dtype=dtype)


def flat_np(grads):
    """Gradient dict (either package) -> one float64 vector, fixed order."""
    out = []
    for m in ("eta", "mu"):
        if grads.get(m) is None:
            continue
        for k in LEAVES:
            out.append(np.asarray(grads[m][k], np.float64).ravel())
    return np.concatenate(out)


def flat_torch(grads):
    return flat_np(params_to_numpy(grads))


def walkers(seed, B, n, dim=2, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal((B, n, dim)).astype(dtype)


# ---- the walker mesh: one job, on one process or on each rank ----

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def child_env() -> dict:
    """A child's environment: the repository and the tests on its path, one
    CPU thread (the ranks share the host's cores)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO, TESTS])
    env["OMP_NUM_THREADS"] = "1"
    return env


def communicate_all(procs, timeout):
    """Every process's output; kills them all if one outlives ``timeout``
    or fails (a rank left alone would wait on its collectives)."""
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    return outs


def run_ranks(world: int, jobs: dict, tmp, timeout: float = 300.0) -> list:
    """Run ``jobs`` ({name: (job function name, kwargs)}) on each rank of a
    ``world``-rank gloo group; returns each rank's {name: result}."""
    tmp = str(tmp)
    with open(os.path.join(tmp, "jobs.pkl"), "wb") as fh:
        pickle.dump(jobs, fh)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         f"import _torch_port; _torch_port.mesh_child({port}, {rank}, "
         f"{world}, {tmp!r})"],
        env=child_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(world)]
    communicate_all(procs, timeout)
    out = []
    for rank in range(world):
        with open(os.path.join(tmp, f"out{rank}.pkl"), "rb") as fh:
            out.append(pickle.load(fh))
    return out


def mesh_child(port: int, rank: int, world: int, tmp: str) -> None:
    """One rank: bring the group up, run the jobs of ``tmp/jobs.pkl`` on the
    walker mesh, write their results to ``tmp/out<rank>.pkl``."""
    from fermiflow_tpu_torch.parallel.mesh import (
        init_distributed,
        make_walker_mesh,
        shutdown_distributed,
    )

    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", world, rank, 60, device="cpu")
    mesh = make_walker_mesh("cpu")
    with open(os.path.join(tmp, "jobs.pkl"), "rb") as fh:
        jobs = pickle.load(fh)
    out = {name: globals()[fn](mesh, **kw) for name, (fn, kw) in jobs.items()}
    with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)
    shutdown_distributed()


def _np(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return tree


def job_collectives(mesh):
    """The mesh's reductions on values that differ by rank (rank r holds
    r + 1), and its count of the collectives they ran."""
    from fermiflow_tpu_torch.parallel import mesh as m

    v = torch.tensor([mesh.rank + 1.0, 10.0 * (mesh.rank + 1)],
                     dtype=torch.float64)
    i = torch.tensor([mesh.rank + 1], dtype=torch.int32)
    x = torch.arange(4.0, dtype=torch.float64) + 4 * mesh.rank
    before = mesh.stats["count"]
    out = {"sum": m.all_sum(mesh, v), "mean": m.all_mean(mesh, v),
           "tensors": list(m.all_sum_tensors(mesh, v, None, i)),
           "tree": m.all_sum_tree(mesh, {"a": {"b": v, "c": None}, "d": i}),
           "walker_mean": m.walker_mean(mesh, x),
           "walker_std": m.walker_std(mesh, (x, m.walker_mean(mesh, x))),
           "local_mean": m.local_mean(mesh, x)}
    out["count"] = mesh.stats["count"] - before
    return _np(out)


MESH_CFG = dict(nup=3, Z=0.5, batch=64, d_eta=8, d_mu=8, ode_steps=2,
                equilibrium_steps=8, mcmc_steps=4, seed=3, lr=1e-3,
                dtype="float64", device="cpu")


def job_train(mesh, finite: bool, kind: str, iters: int = 2):
    """``iters`` training iterations from a fresh state: ``kind`` "fused"
    (GS, one multi-segment sampler call), "persistent" (persistent chains;
    finite T: the coupled state refresh), "fresh" (new chains, new states)
    or "autograd" (persistent; the autograd gradient, summed over ranks).
    Returns the stacked metrics, the flow's parameters (and logits), and
    this rank's walkers, tau and states."""
    from fermiflow_tpu_torch.cli import common
    from fermiflow_tpu_torch.config import Config
    from fermiflow_tpu_torch.train import (
        init_beta_state,
        init_gs_state,
        make_beta_train_step,
        make_gs_fused_multi_step,
        make_gs_train_step,
        make_multi_step,
    )

    cfg = Config(**MESH_CFG, persistent_walkers=kind != "fresh",
                 pallas_reinforce=kind != "autograd")
    cpu = torch.device("cpu")
    if finite:
        cfg.beta, cfg.deltaE = 2.0, 2.0
        model, params = common.build_beta(cfg)
        state = init_beta_state(model, params, cfg, cpu, mesh)
        step = make_multi_step(make_beta_train_step(model, cfg, mesh), iters)
    else:
        model, params = common.build_gs(cfg)
        state = init_gs_state(model, params, cfg, cpu, mesh)
        step = (make_gs_fused_multi_step(model, cfg, iters, mesh)
                if kind == "fused" else
                make_multi_step(make_gs_train_step(model, cfg, mesh), iters))
    state, metrics = step(state)
    return _np({"metrics": metrics, "flow": state.flow.params(),
                "logits": state.log_state_weights,
                "walkers_cm": state.walkers_cm, "tau": state.tau,
                "state_idx": state.state_idx})


def job_estimators(mesh, z_cm, params, state_idx=None, logits=None):
    """The kernel chain's estimator (``loss_metrics_grads_cm``, plain
    versions) and the autograd one (``loss_and_metrics_from_base``, its
    gradient summed over ranks) on this rank's rows of the global walkers
    ``z_cm`` (d, B) (and states): loss, metrics and gradients."""
    from fermiflow_tpu_torch.cli import common
    from fermiflow_tpu_torch.config import Config
    from fermiflow_tpu_torch.parallel.mesh import (
        all_sum_tensors,
        shard_walkers,
    )
    from fermiflow_tpu_torch.vmc.gs import PLAIN_OPS

    cfg = Config(**MESH_CFG)
    flow = {m: None if v is None else
            {k: torch.tensor(a, requires_grad=True) for k, a in v.items()}
            for m, v in params.items()}
    z_cm = shard_walkers(mesh, torch.as_tensor(z_cm), 1)
    B, d = z_cm.shape[1], z_cm.shape[0]
    z = z_cm.T.reshape(B, d // 2, 2)
    if state_idx is None:
        model, _ = common.build_gs(cfg)
        model.ops = PLAIN_OPS
        chain = model.loss_metrics_grads_cm(flow, z_cm, mesh)
        loss, metrics = model.loss_and_metrics_from_base(flow, z, mesh=mesh)
        extra = []
    else:
        cfg.beta, cfg.deltaE = 2.0, 2.0
        model, _ = common.build_beta(cfg)
        model.ops = PLAIN_OPS
        idx = shard_walkers(mesh, torch.as_tensor(state_idx), 0)
        lg = torch.tensor(logits, requires_grad=True)
        full = {"flow": flow, "log_state_weights": lg}
        chain = model.loss_metrics_grads_cm(full, idx, z_cm, mesh)
        loss, metrics = model.loss_and_metrics_from_base(full, idx, z,
                                                         mesh=mesh)
        extra = [lg]
    loss.backward()
    leaves = [flow[m][k] for m in ("eta", "mu") if flow[m] is not None
              for k in LEAVES] + extra
    *grads, loss = all_sum_tensors(mesh, *(t.grad for t in leaves),
                                   loss.detach())
    return _np({"chain": {"loss": chain[0], "metrics": chain[1],
                          "grads": chain[2]},
                "autograd": {"loss": loss, "metrics": metrics,
                             "grads": list(grads)}})


def job_ops(mesh, x_cm, params, state_idx, seed: int = 5):
    """The seven ``*_sharded`` entry points on this rank's rows of the
    global walkers x_cm (d, B), N = 3 (``mesh=None``: the whole batch in
    one process): the three samplers (Philox-free plain versions, seeded),
    both VGHs, the Hessian flow and the REINFORCE gradient (summed over
    ranks) on the VGH's output."""
    from fermiflow_tpu_torch.ops import hessian_flow, metropolis, reinforce
    from fermiflow_tpu_torch.ops import slater_vgh as sv
    from fermiflow_tpu_torch.parallel.mesh import shard_walkers
    from fermiflow_tpu_torch.physics import HO2D

    orb = HO2D()
    x_cm = shard_walkers(mesh, torch.as_tensor(x_cm), 1)
    idx = shard_walkers(mesh, torch.as_tensor(state_idx).long(), 0)
    B = x_cm.shape[1]
    x = x_cm.T.reshape(B, 3, 2).contiguous()
    q = (tuple(int(v) for v in orb.nx[:3]), tuple(int(v) for v in orb.ny[:3]))
    table, _ = orb.fermion_states(3, 0, 2.0)
    ks = int(max(orb.nx[table].max(), orb.ny[table].max())) + 1
    occ = torch.as_tensor(table).long()[idx]
    nx, ny = (torch.as_tensor(t)[occ] for t in (orb.nx, orb.ny))
    flow = {m: None if v is None else
            {k: torch.as_tensor(a) for k, a in v.items()}
            for m, v in params.items()}
    out = {
        "chains": metropolis.metropolis_free_fermion_chains_sharded(
            mesh, x, seed, 0.3, 4, 2, *q, num_shells=2),
        "single": metropolis.metropolis_free_fermion_sharded(
            mesh, x, seed, 0.3, 4, *q, num_shells=2),
        "multistate": metropolis.metropolis_free_fermion_multistate_sharded(
            mesh, x, seed, 0.3, 4, nx, ny, num_shells=ks),
        "vgh_ms": sv.slater_vgh_ms_pallas_sharded(mesh, x, nx, ny, ks),
    }
    y, g, Hp = out["vgh"] = sv.slater_vgh_pallas_sharded(mesh, x, *q, 2)
    xs, lp, gs, _ = out["hessian_flow"] = \
        hessian_flow.hessian_flow_pallas_sharded(mesh, flow, x, y, g, Hp,
                                                 0.0, 1.0, 2, "dopri5")
    w = torch.linspace(-1.0, 1.0, B * (1 if mesh is None else mesh.world),
                       dtype=torch.float64)
    out["reinforce"] = reinforce.reinforce_flow_grad_pallas_sharded(
        mesh, flow, xs, gs, shard_walkers(mesh, w, 0), 0.0, 1.0, 2,
        "dopri5")
    return _np(out)
