"""Training iterations (port of ``fermiflow_tpu/train.py``).

Ground state:
  * ``make_gs_fused_multi_step``: a chunk of K iterations is one
    multi-segment sampler launch (the K iterations' base chains are
    parameter-independent) followed, per iteration, by the kernel-chain
    update (``GSVMC.loss_metrics_grads_cm``) and one ``torch.optim.Adam``
    step;
  * ``make_gs_train_step``: one iteration, one single-chain sampler launch.

Finite temperature: ``make_beta_train_step``, one iteration of
(occupation-state refresh, mixed-state sampler launch, kernel-chain update,
Adam over the flow and the state logits).  ``make_multi_step`` runs K
one-iteration steps with the metrics kept on the device.  Walkers stay
coordinate-major (d, B) from the sampler through the update.

The update follows the JAX selection (``train.py:_use_hessian_flow``):
the kernel chain by default; with ``cfg.local_energy == "nested_jvp"``
x = flow(z) and autograd of the nested-jvp ``loss_and_metrics``; and with
``cfg.pallas_local_energy`` or ``cfg.pallas_reinforce`` off (the CLI's
``--no-pallas-*``) autograd of ``loss_and_metrics_from_base``, Eloc from
the kernel chain or the plain Hessian flow.  ``cfg.pallas_sampler`` off
runs the plain samplers, which draw from the state's device generator.
The sampler kernels draw z on every other path.  The autograd paths write
their gradients into the parameters' ``.grad`` tensors as the kernel chain
does.

Every builder takes ``graph``, the counterpart of the JAX builders' ``jit``
(with ``donate_argnums=0``): a chunk of K iterations becomes ONE CUDA graph
per chunk length, captured over the state's own tensors and replayed for
every later chunk of that length.  The chunk's body updates the state in
place (walkers, tau, states and their probabilities by ``copy_``, every
path's gradients into the parameters' ``.grad`` tensors, Adam with
``capturable=True`` on the card, eager or captured alike), so a replayed
chunk and an eager one leave the same bits.  Between replays the host
draws the chunk's sampler seeds from the host generator, as the eager
chunk does and in its order, and copies them into the static seed buffer
the sampler kernels read (``ops/metropolis.py``); fresh walkers, the
finite-T states and the plain samplers' noise come from the state's device
generator, which the graph registers, so a replay draws where the eager
chunk draws.  The first chunk of each length runs eagerly, on a side
stream, as the trajectory's own chunk (on an NCCL mesh its collectives
make the communicator); the capture that follows records and runs
nothing.  ``graph=None`` captures where the
state lies on the card and the path can be: every update path (the kernel
chain, ``--no-pallas-*``, the nested-jvp engine), persistent or fresh
walkers, no mesh or one without gloo, the fixed-grid solver.
``graph=True`` raises ``ValueError`` elsewhere; those paths stay eager.
The kernels' launch counts (``ops/_build.py``) and the mesh's collectives
are taken at capture and added once per replay.

Every builder takes ``mesh`` (``parallel/mesh.py``): the state then holds
this rank's rows of the global ``cfg.batch`` walkers.  Every walker-axis
draw (the initial Gaussians and states, fresh chain starts, the state
refresh's uniforms and redraws, the plain samplers' noise) takes the global
shape and keeps the rank's rows, so the host and device generators stay
replicated and a rank's rows are those of the one-process run; the
sampler kernels key their streams by the global walker index.  The
metrics are global (summed over ranks) and so replicated, the autograd
paths sum every parameter's gradient over ranks before Adam, and so every
rank takes the same decisions and the same Adam step.
"""

from __future__ import annotations

import dataclasses
import time
import warnings

import torch

from fermiflow_tpu_torch.config import Config
from fermiflow_tpu_torch.mcmc import MCMCState, adapt_tau
from fermiflow_tpu_torch.nn.backflow import Backflow
from fermiflow_tpu_torch.ops import _build
from fermiflow_tpu_torch.ops.metropolis import (
    metropolis_chains,
    metropolis_chains_plain,
    metropolis_multistate_cm,
    metropolis_multistate_cm_plain,
    metropolis_single_cm,
    metropolis_single_cm_plain,
)
from fermiflow_tpu_torch.parallel.mesh import (
    all_sum_tensors,
    global_batch,
    sampler_rows,
    shard_walkers,
    walker_mean,
)
from fermiflow_tpu_torch.utils.checkpointing import named_tensors
from fermiflow_tpu_torch.utils.profiling import SPANS
from fermiflow_tpu_torch.vmc.beta import BetaVMC
from fermiflow_tpu_torch.vmc.gs import GSVMC, _detach

__all__ = ["TrainState", "init_gs_state", "init_beta_state", "make_adam",
           "make_gs_fused_multi_step", "make_gs_train_step",
           "make_beta_train_step", "make_multi_step"]


@dataclasses.dataclass
class TrainState:
    flow: Backflow  # owns the flow parameters
    optimizer: torch.optim.Optimizer
    generator: torch.Generator  # host stream: sampler seeds
    step: int
    walkers_cm: torch.Tensor  # (n*dim, batch) persistent chain positions
    tau: torch.Tensor  # (batch,) per-walker proposal scales
    # Finite T only: the occupation-state logits (a parameter Adam updates),
    # each walker's state and the probabilities it was drawn from.
    log_state_weights: torch.nn.Parameter | None = None
    state_idx: torch.Tensor | None = None  # (batch,) int32
    sample_probs: torch.Tensor | None = None  # (Nstates,)
    # The stream on the walkers' device: fresh walkers and, at finite T,
    # the states.
    device_generator: torch.Generator | None = None

    @property
    def params(self) -> dict:
        """The flow parameters, or for finite T ``{"flow": ...,
        "log_state_weights": ...}`` as the JAX package's pytree."""
        if self.log_state_weights is None:
            return self.flow.params()
        return {"flow": self.flow.params(),
                "log_state_weights": self.log_state_weights}

    @property
    def walkers(self) -> torch.Tensor:
        """Chain positions in the JAX layout (batch, n, dim)."""
        d, B = self.walkers_cm.shape
        return self.walkers_cm.T.reshape(B, d // 2, 2)


# Eager chunks on the card step the same capturable Adam as captured ones
# (make_adam), which PyTorch warns about once per optimizer.
warnings.filterwarnings("ignore", message="This instance was constructed with "
                        "capturable=True")


def make_adam(flow: Backflow, lr: float, extra=()) -> torch.optim.Adam:
    """Adam with ``optax.adam``'s defaults (b1=0.9, b2=0.999, eps=1e-8) over
    the flow's parameters and any ``extra`` ones; ``capturable`` (its step
    count a tensor on the card) where they lie on the card, so that an
    eager and a captured chunk take the same arithmetic."""
    params = list(flow.parameters()) + list(extra)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            capturable=params[0].device.type == "cuda")


def _flow_on(params: dict, device, dtype) -> Backflow:
    return Backflow({k: None if v is None else
                     {kk: t.to(device=device, dtype=dtype) for kk, t in v.items()}
                     for k, v in params.items()})


def _local_batch(cfg: Config, mesh) -> int:
    return cfg.batch if mesh is None else mesh.rows(cfg.batch)[1]


def init_gs_state(model: GSVMC, params: dict, cfg: Config,
                  device: torch.device, mesh=None) -> TrainState:
    """Fresh state: Gaussian walkers and tau = cfg.tau, from ``cfg.seed``
    (with ``mesh``, this rank's rows of them), and the device generator the
    fresh walkers are drawn from."""
    dtype = cfg.torch_dtype()
    gen = torch.Generator().manual_seed(cfg.seed)
    d = model.n * model.basedist.dim
    walkers = torch.randn((d, cfg.batch), generator=gen, dtype=dtype)
    flow = _flow_on(params, device, dtype)
    return TrainState(
        flow=flow,
        optimizer=make_adam(flow, cfg.lr),
        generator=gen,
        step=0,
        walkers_cm=shard_walkers(mesh, walkers, 1).to(device),
        tau=torch.full((_local_batch(cfg, mesh),), cfg.tau, dtype=dtype,
                       device=device),
        device_generator=torch.Generator(device).manual_seed(cfg.seed + 2),
    )


def _set_grad(p: torch.Tensor, g: torch.Tensor) -> None:
    """Copy g into p.grad, the tensor Adam reads (made at the first call,
    kept after it: a captured chunk writes and reads that one)."""
    if p.grad is None:
        p.grad = torch.empty_like(p)
    p.grad.copy_(g)


def _apply_grads(state: TrainState, grads: dict) -> None:
    """Hand the kernel chain's gradients to the optimizer and step it."""
    flow_grads = grads.get("flow", grads)
    for name, mod in (("eta", state.flow.eta), ("mu", state.flow.mu)):
        if mod is None:
            continue
        for k, p in mod.items():
            _set_grad(p, flow_grads[name][k])
    if state.log_state_weights is not None:
        _set_grad(state.log_state_weights, grads["log_state_weights"])
    state.optimizer.step()


def _autograd_step(state: TrainState, loss: torch.Tensor,
                   mesh=None) -> torch.Tensor:
    """Adam on the gradient that autograd takes of ``loss``, written into
    the parameters' own ``.grad`` tensors (``_set_grad``, as the kernel
    chain's), so that a captured chunk reads and writes the same tensors
    at every replay; with ``mesh`` ``loss`` is this rank's share, and every
    parameter's gradient and the loss are summed over ranks (one
    collective) before the step.  A parameter ``loss`` does not reach keeps
    no gradient, and Adam leaves it as it is."""
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    *grads, loss = all_sum_tensors(mesh, *grads, loss.detach())
    for p, g in zip(params, grads):
        if g is None:
            p.grad = None
        else:
            _set_grad(p, g)
    state.optimizer.step()
    return loss


def _use_hessian_flow(cfg: Config, cnf) -> bool:
    """Local-energy engine selection: the Hessian flow needs the closed-form
    field tensors; "auto" uses it whenever they are available."""
    if cfg.local_energy == "nested_jvp":
        return False
    if cnf.field_tensors is None:
        if cfg.local_energy == "hessian_flow":
            raise ValueError(
                "local_energy='hessian_flow' requires cnf.field_tensors")
        return False
    return True


def _walkers(model, z_cm: torch.Tensor) -> torch.Tensor:
    """Coordinate-major (d, B) -> the JAX layout (B, n, dim)."""
    B = z_cm.shape[1]
    return z_cm.T.reshape(B, model.n, model.basedist.dim)


def _generated(model, flow_params: dict, z_cm: torch.Tensor) -> torch.Tensor:
    """x = flow(z) in the JAX layout, with no gradient (the samples)."""
    with torch.no_grad():
        return model.cnf.generate(_detach(flow_params), _walkers(model, z_cm))


def _make_gs_update(model: GSVMC, cfg: Config | None = None, mesh=None):
    """(state, z_cm) -> (loss, metrics): Eloc, the REINFORCE gradient and one
    Adam step, by the path ``cfg`` selects (module docstring; without one,
    the kernel chain)."""
    cfg = Config() if cfg is None else cfg
    if not _use_hessian_flow(cfg, model.cnf):
        def update(state: TrainState, z_cm: torch.Tensor):
            x = _generated(model, state.params, z_cm)
            loss, metrics = model.loss_and_metrics(state.params, x, mesh)
            return _autograd_step(state, loss, mesh), metrics
    elif not (cfg.pallas_local_energy and cfg.pallas_reinforce):
        def update(state: TrainState, z_cm: torch.Tensor):
            loss, metrics = model.loss_and_metrics_from_base(
                state.params, _walkers(model, z_cm),
                chain=cfg.pallas_local_energy, mesh=mesh)
            return _autograd_step(state, loss, mesh), metrics
    else:
        def update(state: TrainState, z_cm: torch.Tensor):
            loss, metrics, grads = model.loss_metrics_grads_cm(state.params,
                                                               z_cm, mesh)
            _apply_grads(state, grads)
            return loss, metrics

    return update


def _chain_start(state: TrainState, cfg: Config, mesh=None):
    """(z0, steps, tau) of this iteration's chains: the persistent walkers
    at their own tau, or fresh Gaussians at cfg.tau drawn from the device
    generator on the walkers' device (this rank's rows of the global
    draw)."""
    if cfg.persistent_walkers:
        return state.walkers_cm, cfg.mcmc_steps, state.tau
    d, B = state.walkers_cm.shape
    z0 = torch.randn((d, global_batch(mesh, B)),
                     generator=state.device_generator,
                     dtype=state.walkers_cm.dtype,
                     device=state.walkers_cm.device)
    return (shard_walkers(mesh, z0, 1), cfg.equilibrium_steps,
            torch.full_like(state.tau, cfg.tau))


def _chunk_generators(cfg: Config):
    """``generators(state)`` of a ground-state chunk: the device generator
    where the body draws from it (fresh walkers, or the plain samplers'
    noise)."""
    if cfg.persistent_walkers and cfg.pallas_sampler:
        return lambda state: ()
    return lambda state: (state.device_generator,)


def _plain_draws(cfg: Config, state: TrainState) -> dict:
    """The plain samplers' stream (``--no-pallas-sampler``): the state's
    device generator, which a captured chunk registers (a generator seeded
    from the seed word would read it on the host)."""
    return {} if cfg.pallas_sampler else {"generator": state.device_generator}


def _new_seed(state: TrainState) -> int:
    return int(torch.randint(0, 2**31 - 1, (1,), generator=state.generator))


def _end_iteration(state: TrainState, cfg: Config, z: torch.Tensor,
                   acc: torch.Tensor) -> None:
    """Persist the chains in place; adapt tau per walker when they
    persist."""
    state.walkers_cm.copy_(z)
    if cfg.persistent_walkers:
        state.tau.copy_(adapt_tau(MCMCState(None, None, state.tau, acc),
                                  cfg.tau_target_accept, cfg.tau_gain))


# ---- chunks: eager, or one captured CUDA graph ----


def _capture_refusal(cfg: Config, mesh) -> str | None:
    """Why the chunks of ``cfg``'s path cannot be captured as a CUDA graph
    (they stay eager), or None."""
    if torch.device(cfg.device).type != "cuda":
        return f"--device {cfg.device}: a CUDA graph needs the card"
    if mesh is not None and mesh.backend == "gloo":
        return ("a gloo walker mesh: its sums go through the host, which "
                "waits for the card")
    if cfg.ode_solver != "fixed":
        return (f"the {cfg.ode_solver} solver: its launches depend on the "
                "data")
    return None


_SIDE_STREAMS: dict = {}


def _side_stream(device: torch.device):
    stream = _SIDE_STREAMS.get(device)
    if stream is None:
        stream = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return stream


def _on_side_stream(fn, device: torch.device):
    """fn() run eagerly on the capture's side stream, ordered after the
    work already queued and before the work queued after it (PyTorch's
    warm-up before a capture)."""
    side, main = _side_stream(device), torch.cuda.current_stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = fn()
    main.wait_stream(side)
    return out


def _capture(fn, device: torch.device, generators=()):
    """fn's launches captured as one CUDA graph on the side stream, which
    records them and runs nothing.  Returns (replay, capture seconds, the
    bytes the graph's memory pool took): ``replay()`` runs them again and
    returns fn's outputs, rewritten.  ``generators`` are the device
    generators fn draws from, registered so that each replay draws where
    the eager calls would have."""
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, stream=_side_stream(device)):
            out = fn()
        seconds = time.perf_counter() - t0
        pool = torch.cuda.memory_reserved() - reserved

    def replay():
        graph.replay()
        return out

    return replay, seconds, pool


def _pointers(state: TrainState) -> list:
    """Where every tensor a captured chunk reads or writes lives: the
    state's, the gradients' and Adam's."""
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    tensors = list(named_tensors(state).values()) + [p.grad for p in params]
    tensors += [v for st in state.optimizer.state.values()
                for v in st.values() if isinstance(v, torch.Tensor)]
    return [None if t is None else t.data_ptr() for t in tensors]


class _Chunk:
    """``chunk(state) -> (state, metrics)``: ``iters`` training iterations
    with their metrics stacked to (iters,) (one iteration: unstacked).

    ``body(state, seed)`` runs them, in place on the state's tensors (the
    step count aside); ``seed(k)`` gives its k-th sampler seed: an ``int``
    drawn from the host generator when the body asks (eager), or a view of
    the static seed buffer.  ``refusal`` says why the chunk cannot be
    captured (None: it can), ``graph`` is the builder's argument,
    ``generators(state)`` the device generators the body draws from and
    ``mesh`` the walker mesh whose collectives it runs.  Captured (module
    docstring), ``capture_seconds``, ``pool_bytes``, ``launches`` (per
    kernel, one replay) and ``collectives`` (one replay) describe the
    graph.
    """

    def __init__(self, body, n_seeds: int, iters: int, refusal, graph,
                 generators=lambda state: (), mesh=None):
        if graph and refusal:
            raise ValueError(f"graph=True, but this path cannot be "
                             f"captured: {refusal}")
        self.body, self.n_seeds, self.iters = body, n_seeds, iters
        self.refusal, self.graph, self.generators = refusal, graph, generators
        self.mesh, self._replay = mesh, None
        self.capture_seconds = self.pool_bytes = self.launches = None
        self.collectives = None

    def _captured(self, state: TrainState) -> bool:
        if self.graph is False:
            return False
        why = self.refusal or (None if state.walkers_cm.is_cuda else
                               "the state lies on the CPU")
        if why and self.graph:
            raise ValueError(f"graph=True, but this chunk cannot be "
                             f"captured: {why}")
        return why is None

    def __call__(self, state: TrainState):
        if self._captured(state):
            metrics = self._run_captured(state)
        else:
            metrics = self.body(state, lambda k: _new_seed(state))
        state.step += self.iters
        return state, metrics

    def _run_captured(self, state: TrainState) -> dict:
        """The captured chunk's host side: its seeds drawn and copied into
        the static buffer, then the eager warm-up and capture (first call)
        or a replay; the metrics cloned out of the graph's output (the
        step count is the caller's).  The mesh counts the collectives of a
        replay as the capture recorded them, and its host seconds as
        theirs.  A replay records the spans ``chunk.seeds`` (the seeds'
        draw and copy) and ``chunk.launch`` (the pointer check, the replay
        and the clone) in ``utils.profiling.SPANS``."""
        device = state.walkers_cm.device
        stats = {} if self.mesh is None else self.mesh.stats
        if self._replay is None:
            self._seeds = torch.empty(self.n_seeds, dtype=torch.int32,
                                      device=device)
            self._seeds.copy_(self._draw_seeds(state, device),
                              non_blocking=True)

            def run():
                metrics = self.body(state, lambda k: self._seeds[k:k + 1])
                self._keys = list(metrics)
                return torch.stack([metrics[k] for k in self._keys])

            packed = _on_side_stream(run, device)
            before, recorded = dict(_build.LAUNCHES), dict(stats)
            self._replay, self.capture_seconds, self.pool_bytes = _capture(
                run, device, self.generators(state))
            self.launches = {k: v - before[k]
                             for k, v in _build.LAUNCHES.items()}
            _build.LAUNCHES.update(before)
            self.collectives = stats.get("count", 0) - recorded.get("count", 0)
            stats.update(recorded)
            self._pointers = _pointers(state)
            return dict(zip(self._keys, packed.unbind(0)))
        with SPANS.span("chunk.seeds"):
            self._seeds.copy_(self._draw_seeds(state, device),
                              non_blocking=True)
        with SPANS.span("chunk.launch"):
            if _pointers(state) != self._pointers:
                raise RuntimeError(
                    "a state tensor was replaced since this chunk was "
                    "captured (a restore?): make the chunk anew")
            t0 = time.perf_counter()
            packed = self._replay().clone()
            for k, v in self.launches.items():
                _build.LAUNCHES[k] += v
            if self.collectives:
                stats["count"] += self.collectives
                stats["replayed"] += self.collectives
                stats["seconds"] += time.perf_counter() - t0
            return dict(zip(self._keys, packed.unbind(0)))

    def _draw_seeds(self, state: TrainState, device) -> torch.Tensor:
        """The chunk's sampler seeds from the host generator, in pinned
        memory on the way to a card."""
        return torch.tensor([_new_seed(state) for _ in range(self.n_seeds)],
                            dtype=torch.int32,
                            pin_memory=device.type == "cuda")


def make_gs_fused_multi_step(model: GSVMC, cfg: Config, steps_per_call: int,
                             mesh=None, graph: bool | None = None):
    """K training iterations per call with ONE multi-segment sampler launch.

    Persistent walkers continue their chains for ``cfg.mcmc_steps`` per
    segment with per-walker tau adaptation; otherwise every segment starts
    from fresh Gaussians and runs ``cfg.equilibrium_steps`` at fixed tau.
    Returns ``multi(state) -> (state, metrics)`` with each metric stacked to
    shape (K,) on the state's device; one CUDA graph per call where
    ``graph`` (module docstring).
    """
    nx_up, ny_up, nx_dn, ny_dn, kshells = model.occ_qnums()
    update = _make_gs_update(model, cfg, mesh)
    chains = metropolis_chains if cfg.pallas_sampler else metropolis_chains_plain
    K = steps_per_call

    def body(state: TrainState, seed):
        s = seed(0)
        z0, n_steps, tau = _chain_start(state, cfg, mesh)
        zs, _, rates, tau_out = chains(
            z0, tau, s, steps=n_steps, segments=K, nx_occ=nx_up,
            ny_occ=ny_up, nx_dn=nx_dn, ny_dn=ny_dn, num_shells=kshells,
            target=cfg.tau_target_accept, gain=cfg.tau_gain,
            reinit=not cfg.persistent_walkers,
            **sampler_rows(mesh, z0.shape[1]), **_plain_draws(cfg, state))
        accept = walker_mean(mesh, rates)  # (K,)
        rows = []
        for k in range(K):
            loss, metrics = update(state, zs[k])
            rows.append(dict(metrics, accept_rate=accept[k], loss=loss))
        state.walkers_cm.copy_(zs[-1])
        if cfg.persistent_walkers:
            state.tau.copy_(tau_out)
        return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    return _Chunk(body, 1, K, _capture_refusal(cfg, mesh), graph,
                  _chunk_generators(cfg), mesh)


def make_gs_train_step(model: GSVMC, cfg: Config, mesh=None,
                       graph: bool | None = None):
    """One ground-state iteration: a single-chain sampler launch (the
    per-iteration kernel), the kernel-chain update and Adam.  Returns
    ``step(state) -> (state, metrics)``, a one-iteration chunk
    (``make_multi_step`` chains its body; ``graph`` as there)."""
    nx_up, ny_up, nx_dn, ny_dn, kshells = model.occ_qnums()
    update = _make_gs_update(model, cfg, mesh)
    single = (metropolis_single_cm if cfg.pallas_sampler
              else metropolis_single_cm_plain)

    def body(state: TrainState, seed):
        s = seed(0)
        z0, n_steps, tau = _chain_start(state, cfg, mesh)
        z, _, acc = single(
            z0, tau, s, steps=n_steps, nx_occ=nx_up, ny_occ=ny_up,
            nx_dn=nx_dn, ny_dn=ny_dn, num_shells=kshells,
            **sampler_rows(mesh, z0.shape[1]), **_plain_draws(cfg, state))
        loss, metrics = update(state, z)
        _end_iteration(state, cfg, z, acc)
        return dict(metrics, accept_rate=walker_mean(mesh, acc), loss=loss)

    return _Chunk(body, 1, 1, _capture_refusal(cfg, mesh), graph,
                  _chunk_generators(cfg), mesh)


def make_multi_step(step_fn: _Chunk, steps_per_call: int,
                    graph: bool | None = None):
    """K iterations of a one-iteration step (``make_gs_train_step``,
    ``make_beta_train_step``) as one chunk, metrics stacked to (K,) on the
    device, so that the caller fetches them once per chunk; one CUDA graph
    where ``graph`` (default: the step's own)."""
    K = steps_per_call
    one = step_fn.body

    def body(state: TrainState, seed):
        rows = [one(state, lambda _, k=k: seed(k)) for k in range(K)]
        return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    return _Chunk(body, K, K, step_fn.refusal,
                  step_fn.graph if graph is None else graph,
                  step_fn.generators, step_fn.mesh)


# ---- finite temperature ----


def _categorical(generator: torch.Generator, probs: torch.Tensor,
                 n: int) -> torch.Tensor:
    return torch.multinomial(probs, n, replacement=True,
                             generator=generator).to(torch.int32)


def _coupled_state_refresh(generator: torch.Generator, logits_new: torch.Tensor,
                           probs_old: torch.Tensor, state_idx_old: torch.Tensor,
                           u: torch.Tensor | None = None,
                           redraw: torch.Tensor | None = None, mesh=None):
    """Refresh per-walker occupation states to the current Categorical while
    keeping as many walkers as possible on their previous state.

    The maximal coupling of Categorical(p_old) and Categorical(p_new) keeps
    state s with probability min(p_new, p_old)[s] / p_old[s] and otherwise
    redraws from the normalized residual (p_new - p_old)_+: the new marginal
    is exactly p_new, and only a TV(p_old, p_new) fraction of walkers switch
    target densities (JAX ``train.py:_coupled_state_refresh``).  The keep
    uniforms ``u`` and the residual draws ``redraw`` come from ``generator``
    on the walkers' device unless given (with ``mesh``, this rank's rows of
    the global draws).

    Returns (state_idx_new, p_new, switch_fraction).
    """
    p_new = torch.softmax(logits_new, dim=-1)
    pmin = torch.minimum(p_new, probs_old)
    idx = state_idx_old.long()
    keep_prob = pmin[idx] / probs_old[idx].clamp_min(1e-30)
    Bg = global_batch(mesh, state_idx_old.shape[0])
    if u is None:
        u = shard_walkers(mesh, torch.rand((Bg,), generator=generator,
                                           dtype=p_new.dtype,
                                           device=p_new.device), 0)
    keep = u < keep_prob
    if redraw is None:
        # When the distributions coincide the residual is ~0 and every walker
        # keeps its state; the floor only keeps the draw well defined.
        resid = torch.clamp(p_new - pmin, min=0.0)
        redraw = shard_walkers(mesh, _categorical(generator, resid + 1e-30,
                                                  Bg), 0)
    state_idx = torch.where(keep, state_idx_old, redraw.to(state_idx_old.dtype))
    return state_idx, p_new, 1.0 - walker_mean(mesh, keep.to(p_new.dtype))


def init_beta_state(model: BetaVMC, params: dict, cfg: Config,
                    device: torch.device, mesh=None) -> TrainState:
    """Fresh finite-T state: Gaussian walkers, tau = cfg.tau, and states
    drawn from the initial logits, all from ``cfg.seed`` (with ``mesh``,
    this rank's rows of them).  ``params`` is ``{"flow": ...,
    "log_state_weights": ...}``."""
    dtype = cfg.torch_dtype()
    gen = torch.Generator().manual_seed(cfg.seed)
    dev_gen = torch.Generator(device).manual_seed(cfg.seed + 2)
    d = model.n * model.basedist.dim
    walkers = torch.randn((d, cfg.batch), generator=gen, dtype=dtype)
    flow = _flow_on(params["flow"], device, dtype)
    logits = torch.nn.Parameter(
        params["log_state_weights"].detach().to(device=device, dtype=dtype)
        .clone())
    probs0 = torch.softmax(logits.detach(), dim=-1)
    return TrainState(
        flow=flow,
        optimizer=make_adam(flow, cfg.lr, extra=[logits]),
        generator=gen,
        step=0,
        walkers_cm=shard_walkers(mesh, walkers, 1).to(device),
        tau=torch.full((_local_batch(cfg, mesh),), cfg.tau, dtype=dtype,
                       device=device),
        log_state_weights=logits,
        state_idx=shard_walkers(mesh, _categorical(dev_gen, probs0,
                                                   cfg.batch), 0),
        sample_probs=probs0,
        device_generator=dev_gen,
    )


def make_beta_train_step(model: BetaVMC, cfg: Config, mesh=None,
                         graph: bool | None = None):
    """One finite-T iteration: the state refresh (maximal coupling with
    persistent walkers, a fresh Categorical draw otherwise), one mixed-state
    sampler launch, the kernel-chain update, Adam over the flow and the
    logits, and tau adaptation.  Returns ``step(state) -> (state, metrics)``,
    a one-iteration chunk (``make_multi_step`` chains its body; ``graph``
    as there; a captured chunk draws the refresh from the state's device
    generator, registered with the graph)."""
    _, _, kshells = model._qnum_tables()
    sampler = (metropolis_multistate_cm if cfg.pallas_sampler
               else metropolis_multistate_cm_plain)
    hessian_flow = _use_hessian_flow(cfg, model.cnf)
    chain_grads = hessian_flow and cfg.pallas_local_energy \
        and cfg.pallas_reinforce

    def update(state: TrainState, state_idx: torch.Tensor, z: torch.Tensor):
        if chain_grads:
            loss, metrics, grads = model.loss_metrics_grads_cm(
                state.params, state_idx, z, mesh)
            _apply_grads(state, grads)
            return loss, metrics
        if hessian_flow:
            loss, metrics = model.loss_and_metrics_from_base(
                state.params, state_idx, _walkers(model, z),
                chain=cfg.pallas_local_energy, mesh=mesh)
        else:
            x = _generated(model, state.params["flow"], z)
            loss, metrics = model.loss_and_metrics(state.params, state_idx, x,
                                                   mesh)
        return _autograd_step(state, loss, mesh), metrics

    def body(state: TrainState, seed):
        logits = state.log_state_weights.detach()
        if cfg.persistent_walkers:
            # Chains continue; states refresh by maximal coupling so almost
            # every chain keeps its own target density and stays equilibrated.
            state_idx, probs, switch_frac = _coupled_state_refresh(
                state.device_generator, logits, state.sample_probs,
                state.state_idx, mesh=mesh)
        else:
            probs = torch.softmax(logits, dim=-1)
            state_idx = shard_walkers(mesh, _categorical(
                state.device_generator, probs,
                global_batch(mesh, state.state_idx.shape[0])), 0)
        s = seed(0)
        z0, n_steps, tau = _chain_start(state, cfg, mesh)
        nx_cm, ny_cm = model.qnums_cm(state_idx)
        z, _, acc = sampler(
            z0, tau, s, steps=n_steps, nx_cm=nx_cm, ny_cm=ny_cm,
            num_shells=kshells, **sampler_rows(mesh, z0.shape[1]),
            **_plain_draws(cfg, state))
        loss, metrics = update(state, state_idx, z)
        state.state_idx.copy_(state_idx)
        state.sample_probs.copy_(probs)
        _end_iteration(state, cfg, z, acc)
        metrics = dict(metrics, accept_rate=walker_mean(mesh, acc), loss=loss)
        if cfg.persistent_walkers:
            metrics["state_switch_frac"] = switch_frac
        return metrics

    return _Chunk(body, 1, 1, _capture_refusal(cfg, mesh), graph,
                  lambda state: (state.device_generator,), mesh)
