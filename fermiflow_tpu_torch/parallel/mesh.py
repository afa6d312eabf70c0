"""Walker-axis data parallelism on ``torch.distributed`` (port of
``fermiflow_tpu/parallel/mesh.py``).

One process per rank, PyTorch's idiom, where the JAX package runs one
program over a 1-D ``walkers`` mesh of devices.  ``--batch`` stays the
GLOBAL walker count: rank r of a world of W holds the contiguous rows
[r B/W, (r + 1) B/W) of every walker-axis tensor (``walkers_cm`` on dim 1,
``tau`` and ``state_idx`` on dim 0); parameters, optimizer state, logits
and both generators are replicated, identical on every rank.  Each rank
runs every kernel on its own rows; the estimators' means, standard
deviations, per-state sums and gradients are sums over ranks
(``all_sum``), which GSPMD inserts in the JAX package and the estimators
call here.

Unlike the JAX package, which spans several devices from one process,
``--shard`` over several cards needs one process per card: ``--shard``
alone is a 1-rank mesh.  ``walker_sharding`` and ``replicated_sharding``
have no tensor counterpart (a rank's tensor is its rows, or the whole
replicated value), and so are not ported.

Backend, chosen per host: the ranks on this host are counted from
``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` where a launcher sets both, else by
an exchange of hostnames through the rendezvous store before the group is
made.  NCCL where the device is CUDA and this host has no more ranks than
cards; gloo where ranks share a card or run on the CPU.  Rank r takes card
(its local rank) mod (cards of the host).  Gloo collectives on CUDA tensors
run on a host copy.  A failed bring-up raises; no rank continues alone.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import time

import torch
import torch.distributed as dist

__all__ = ["WalkerMesh", "init_distributed", "make_walker_mesh",
           "shard_walkers", "global_batch", "sampler_rows", "all_sum",
           "all_sum_tensors", "all_sum_tree", "all_mean", "walker_mean",
           "walker_std", "local_mean", "process_count", "process_index",
           "barrier", "shutdown_distributed"]


def process_count() -> int:
    """Ranks of the process group (1 without one), as ``jax.process_count``."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a group), as ``jax.process_index``."""
    return dist.get_rank() if dist.is_initialized() else 0


def _host_ranks(hosts: list, rank: int) -> tuple[int, int]:
    """(local rank, ranks on this host) of ``rank`` from every rank's
    hostname: its place among the ranks that share its host, in rank order,
    however the world numbers the hosts."""
    mine = [r for r, h in enumerate(hosts) if h == hosts[rank]]
    return mine.index(rank), len(mine)


def _local_ranks(store, rank: int, world: int) -> tuple[int, int]:
    """(local rank, ranks on this host): ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` where a launcher sets both, else every rank's
    hostname through the rendezvous ``store``."""
    if "LOCAL_RANK" in os.environ and "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_RANK"]), int(os.environ["LOCAL_WORLD_SIZE"])
    store.set(f"hostname/{rank}", socket.gethostname())
    hosts = [store.get(f"hostname/{r}").decode() for r in range(world)]
    return _host_ranks(hosts, rank)


def _backend_for(device: torch.device, local_world: int) -> str:
    """NCCL where every one of the ``local_world`` ranks on this host has a
    card of its own, else gloo."""
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     initialization_timeout: int = 120,
                     device: str | torch.device = "cuda") -> bool:
    """Bring up the process group over ``tcp://coordinator_address``.

    A no-op without a coordinator at one process or fewer, as the JAX
    ``init_distributed``.  Otherwise every rank calls it with its own
    ``process_id``.  Rank 0 serves the rendezvous store at the address;
    through it the ranks learn which of them share a host (``_local_ranks``)
    before the backend is chosen, and on CUDA each takes card (local rank)
    mod (cards of the host).  ``initialization_timeout`` (seconds) bounds
    the bring-up and every later collective.  Returns whether the world has
    more than one rank.
    """
    if (num_processes is None or num_processes <= 1) and \
            coordinator_address is None:
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "a multi-process run needs --coordinator HOST:PORT, "
            "--num-processes and --process-id on every rank (got "
            f"coordinator={coordinator_address!r}, num_processes="
            f"{num_processes!r}, process_id={process_id!r})")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} is not a rank of "
                         f"{num_processes} processes")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass --device cpu to run the ranks "
            "on the CPU (gloo)")
    timeout = datetime.timedelta(seconds=initialization_timeout)
    try:
        host, port = coordinator_address.rsplit(":", 1)
        store = dist.TCPStore(host, int(port), num_processes,
                              is_master=process_id == 0, timeout=timeout)
        local_rank, local_world = _local_ranks(store, process_id,
                                               num_processes)
        backend = _backend_for(device, local_world)
        if device.type == "cuda":
            torch.cuda.set_device(local_rank % torch.cuda.device_count())
        dist.init_process_group(backend, store=store,
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)
    except Exception as e:
        raise RuntimeError(
            f"torch.distributed bring-up of rank {process_id}/"
            f"{num_processes} at tcp://{coordinator_address} failed within "
            f"{initialization_timeout} s ({type(e).__name__}: {e})") from e
    where = (f"cuda:{torch.cuda.current_device()}" if device.type == "cuda"
             else "cpu")
    print(f"torch.distributed: process {process_id}/{num_processes}, "
          f"backend {backend}, device {where}, local rank {local_rank} of "
          f"{local_world} on this host", flush=True)
    return num_processes > 1


def shutdown_distributed() -> None:
    """Tear the process group down (after the last collective)."""
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class WalkerMesh:
    """This rank's place on the walker axis.  ``group`` is None for a mesh
    without a process group (``--shard`` at one process): its reductions
    are the single-process ones."""

    rank: int
    world: int
    device: torch.device
    group: object | None = None
    backend: str | None = None
    # The collectives this rank ran and their host seconds (gloo: from the
    # device's last kernel to the sum back on the device, the wait for the
    # other ranks included; NCCL: the enqueue).  ``replayed`` of them ran in
    # replays of a captured chunk (``train.py``), which count each replay's
    # collectives as the capture recorded them and its host seconds (the
    # graph's launch) as theirs.
    stats: dict = dataclasses.field(
        default_factory=lambda: {"count": 0, "seconds": 0.0, "replayed": 0},
        compare=False)

    def rows(self, batch: int) -> tuple[int, int]:
        """(first row, row count) of this rank in a global ``batch``."""
        if batch % self.world:
            raise ValueError(f"the global batch {batch} does not split "
                             f"evenly over {self.world} ranks")
        n = batch // self.world
        return self.rank * n, n


def make_walker_mesh(device: str | torch.device = "cuda") -> WalkerMesh:
    """The walker mesh of the live process group (a 1-rank mesh without
    one) with this rank's tensors on ``device`` (its card on CUDA)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        return WalkerMesh(0, 1, device)
    return WalkerMesh(dist.get_rank(), dist.get_world_size(), device,
                      dist.group.WORLD, dist.get_backend())


def global_batch(mesh: WalkerMesh | None, local_batch: int) -> int:
    """The global walker count of ranks holding ``local_batch`` rows each."""
    return local_batch * (1 if mesh is None else mesh.world)


def sampler_rows(mesh: WalkerMesh | None, local_batch: int) -> dict:
    """The samplers' ``walker0`` and ``global_batch`` for this rank's
    ``local_batch`` rows (none without a mesh: the one-process stream)."""
    if mesh is None:
        return {}
    return dict(walker0=mesh.rank * local_batch,
                global_batch=global_batch(mesh, local_batch))


def shard_walkers(mesh: WalkerMesh | None, tensor: torch.Tensor,
                  dim: int) -> torch.Tensor:
    """This rank's contiguous rows on ``dim`` of a global tensor, on
    the mesh's device (the whole tensor without a mesh)."""
    if mesh is None:
        return tensor
    first, n = mesh.rows(tensor.shape[dim])
    return tensor.narrow(dim, first, n).contiguous().to(mesh.device)


def _collective(mesh: WalkerMesh | None) -> bool:
    return mesh is not None and mesh.group is not None


def all_sum(mesh: WalkerMesh | None, t: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of ``t`` (a new tensor, on ``t``'s device); the
    identity without a process group."""
    if not _collective(mesh):
        return t
    if mesh.backend == "gloo" and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        buf = t.detach().to("cpu", copy=True)
        dist.all_reduce(buf, group=mesh.group)
        out = buf.to(t.device)
    else:
        t0 = time.perf_counter()
        out = t.detach().clone()
        dist.all_reduce(out, group=mesh.group)
    mesh.stats["count"] += 1
    mesh.stats["seconds"] += time.perf_counter() - t0
    return out


def all_sum_tensors(mesh: WalkerMesh | None, *tensors):
    """``all_sum`` of each tensor (None passes through) in ONE collective
    on their concatenation, cast to the first tensor's dtype; returns
    them in their shapes and dtypes."""
    if not _collective(mesh):
        return tensors
    live = [t for t in tensors if t is not None]
    flat = all_sum(mesh, torch.cat([t.detach().reshape(-1).to(live[0].dtype)
                                    for t in live]))
    out, at = [], 0
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return tuple(out)


def all_sum_tree(mesh: WalkerMesh | None, tree):
    """``all_sum`` of every tensor of a nested dict (None leaves kept), in
    one collective: a gradient dict of the flow's parameters."""
    if not _collective(mesh):
        return tree
    leaves = []

    def collect(t):
        if isinstance(t, dict):
            for v in t.values():
                collect(v)
        elif t is not None:
            leaves.append(t)

    collect(tree)
    summed = iter(all_sum_tensors(mesh, *leaves))

    def rebuild(t):
        if isinstance(t, dict):
            return {k: rebuild(v) for k, v in t.items()}
        return None if t is None else next(summed)

    return rebuild(tree)


def all_mean(mesh: WalkerMesh | None, t: torch.Tensor) -> torch.Tensor:
    """The mean over ranks of ``t``; the identity without a process group."""
    if not _collective(mesh):
        return t
    return all_sum(mesh, t) / mesh.world


def walker_mean(mesh: WalkerMesh | None, *xs: torch.Tensor):
    """Global means over the walker axis (the last) of each x, all from one
    collective; ``torch.mean`` of each without a process group.  One
    tensor in, one out."""
    if not _collective(mesh):
        out = tuple(torch.mean(x) if x.dim() == 1 else torch.mean(x, dim=-1)
                    for x in xs)
    else:
        sums = all_sum_tensors(mesh, *(x.sum(dim=-1) for x in xs))
        out = tuple(s / (xs[0].shape[-1] * mesh.world) for s in sums)
    return out[0] if len(xs) == 1 else out


def walker_std(mesh: WalkerMesh | None, *pairs):
    """Population standard deviations of (x, global mean of x) pairs over
    the walker axis, two-pass: the global mean of the squared deviations,
    all from one collective; ``torch.std(x, correction=0)`` without a
    process group.  One pair in, one tensor out."""
    if not _collective(mesh):
        out = tuple(torch.std(x, correction=0) for x, _ in pairs)
    else:
        sq = walker_mean(mesh, *((x - m) ** 2 for x, m in pairs))
        out = tuple(torch.sqrt(s) for s in (sq if len(pairs) > 1 else (sq,)))
    return out[0] if len(pairs) == 1 else out


def local_mean(mesh: WalkerMesh | None, x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the global mean of x (B,): its sum over the
    global batch, so that the shares (and their gradients) sum over ranks
    to the global mean; ``torch.mean`` without a process group."""
    if not _collective(mesh):
        return torch.mean(x)
    return x.sum() / (x.shape[0] * mesh.world)


def barrier() -> None:
    """Wait for every rank of the live process group (none: return)."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
