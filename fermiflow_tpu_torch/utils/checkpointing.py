"""Checkpoint and resume of the full training state (port of
``fermiflow_tpu/utils/checkpointing.py``).

A checkpoint is one ``torch.save`` file, ``ckpt_{step:08d}.pt``, written to
a temporary name and moved into place with ``os.replace`` (atomic, as
orbax's save).  It holds the whole ``TrainState``: the flow's parameters,
``optimizer.state_dict()`` (Adam's step and both moments; a capturable
Adam's step, on the card, is saved to the CPU and restored beside the
parameters), the chains
(``walkers_cm``, ``tau``), at finite T the logits, ``state_idx`` and
``sample_probs``, both generators' states and the step, with a structure
fingerprint (names, shapes and dtypes, as the JAX ``_fingerprint``).  The
sampler's seed is drawn from the host generator, fresh walkers and states
from the device generator, so a run that saves at step k and resumes is
bitwise the run that never stopped, at equal chunk boundaries.  A
ground-state file saved without a device generator (before the ground
state had one) restores, the live device generator left as it is.

Multi-process runs (``parallel/mesh.py``): each rank saves its own rows
under ``directory/procNNNNN/``, replicated tensors redundantly, as the JAX
``_proc_dir``, then waits for every rank (no rank reads a shard still being
written).  The walker-axis tensors are known by name, not by shape (the
walkers are coordinate-major): ``walkers_cm`` on dim 1, ``tau`` and
``state_idx`` on dim 0; everything else is replicated.  The restore is
elastic (the JAX ``_restore_resharded``): shards saved at another process
count are merged and the live rank's rows sliced out; a one-process file
is sliced for a multi-process run; where a directory holds both layouts
the newest step wins; a saved global batch other than the live one is a
``ValueError``.  Every restoring rank reads every saved shard (a shared or
synced filesystem).
"""

from __future__ import annotations

import json
import os

import torch

from fermiflow_tpu_torch.parallel.mesh import (
    barrier,
    process_count,
    process_index,
)

__all__ = ["save_checkpoint", "restore_checkpoint", "named_tensors"]

# TrainState fields saved beside the flow's parameters (None ones skipped).
_FIELDS = ("walkers_cm", "tau", "log_state_weights", "state_idx",
           "sample_probs")
_GENERATORS = ("generator", "device_generator")
# The walker-axis tensors and the dimension their rows lie on.
_SHARDED = {"walkers_cm": 1, "tau": 0, "state_idx": 0}


def named_tensors(state) -> dict:
    """The state's tensors by name: the flow's parameters, then ``_FIELDS``.
    Live tensors: the flow's share storage with its parameters."""
    out = {"flow." + k: v for k, v in state.flow.state_dict().items()}
    for name in _FIELDS:
        t = getattr(state, name)
        if t is not None:
            out[name] = t
    return out


def _fingerprint(state, generators=_GENERATORS) -> str:
    """Names, shapes and dtypes of the state's tensors, the form of each of
    its ``generators``' states and the optimizer's parameter groups, so a
    restore into another layout (another N, batch or state count, or a
    ground-state checkpoint into a finite-T run) fails loudly.  Adam's
    moments are created at its first step and follow the parameters'
    shapes."""
    entries = [[name, list(t.shape), str(t.dtype)]
               for name, t in named_tensors(state).items()]
    for name in generators:
        g = getattr(state, name)
        if g is not None:
            entries.append([name, g.device.type, list(g.get_state().shape)])
    entries.append(["optimizer", [len(g["params"])
                                  for g in state.optimizer.param_groups]])
    return json.dumps(entries)


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _saved_generators(payload: dict) -> tuple:
    """The generators a checkpoint holds: both, but in a ground-state file
    written before the ground state had a device generator, whose restore
    leaves the live one as it is."""
    return tuple(name for name in _GENERATORS if name in payload)


def _proc_dir(directory: str) -> str:
    """This rank's checkpoint directory: ``procNNNNN`` at more than one
    process, ``directory`` itself otherwise."""
    if process_count() > 1:
        return os.path.join(directory, f"proc{process_index():05d}")
    return directory


def save_checkpoint(directory: str, step: int, state) -> str:
    """Save ``state`` as ``ckpt_{step:08d}.pt`` in ``directory`` (in its
    ``procNNNNN`` on every rank of a multi-process run, which calls it from
    every rank); returns the path."""
    directory = _proc_dir(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.pt")
    payload = {
        "step": int(step),
        "fingerprint": _fingerprint(state),
        "tensors": _to_cpu(named_tensors(state)),
        "optimizer": _to_cpu(state.optimizer.state_dict()),
        **{name: getattr(state, name).get_state()
           for name in _GENERATORS if getattr(state, name) is not None},
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    barrier()
    return path


def _latest_name(directory: str):
    if not os.path.isdir(directory):
        return None
    ckpts = sorted(f for f in os.listdir(directory)
                   if f.startswith("ckpt_") and f.endswith(".pt"))
    return ckpts[-1] if ckpts else None


def _step_of(name: str) -> int:
    return int(name.split("_")[1].split(".")[0])


def _load(directory: str, name: str) -> dict:
    return torch.load(os.path.join(directory, name), map_location="cpu",
                      weights_only=True)


def _unsharded(fingerprint: str) -> list:
    """A fingerprint with the walker dimension of the sharded tensors
    blanked: what must agree across process counts."""
    entries = json.loads(fingerprint)
    for e in entries:
        if e[0] in _SHARDED:
            e[1][_SHARDED[e[0]]] = None
    return entries


def _load_into(state, payload: dict, tensors: dict):
    """Copy ``tensors`` into the live ones in place (the live optimizer
    keeps referring to the live parameters), Adam's state with the live
    run's hyperparameters kept (JAX's optimizer comes from the command
    line, not the checkpoint), both generators' states and the step."""
    live = named_tensors(state)
    with torch.no_grad():
        for k, t in tensors.items():
            live[k].copy_(t)
    hyper = [{k: v for k, v in g.items() if k != "params"}
             for g in state.optimizer.param_groups]
    state.optimizer.load_state_dict(payload["optimizer"])
    for g, h in zip(state.optimizer.param_groups, hyper):
        g.update(h)
        if g.get("capturable"):
            # A capturable Adam keeps its step count beside the parameters;
            # a checkpoint of one that was not holds it on the CPU.
            for p in g["params"]:
                st = state.optimizer.state.get(p, {})
                if "step" in st:
                    st["step"] = st["step"].to(p.device)
    for gname in _saved_generators(payload):
        getattr(state, gname).set_state(payload[gname])
    state.step = payload["step"]
    return state, state.step


def _restore_resharded(directory: str, proc_dirs: list, name: str, state):
    """Elastic restore of step ``name``: the ``proc_dirs`` shards (or with
    none, the one-process file of ``directory``) merged into the global
    tensors, of which this rank keeps its rows.  Replicated tensors, Adam
    and the generators come from the first shard."""
    sources = [os.path.join(directory, d) for d in proc_dirs] or [directory]
    payloads = [_load(d, name) for d in sources]
    where = os.path.join(sources[0], name)
    want = _fingerprint(state, _saved_generators(payloads[0]))
    if _unsharded(payloads[0]["fingerprint"]) != _unsharded(want):
        raise ValueError(
            f"checkpoint structure mismatch at {where}: the saved TrainState "
            f"layout does not match the one being restored into.\n saved: "
            f"{payloads[0]['fingerprint']}\n  live: {want}")
    live = named_tensors(state)
    world, rank = process_count(), process_index()
    tensors = dict(payloads[0]["tensors"])
    for k, dim in _SHARDED.items():
        if k not in tensors:
            continue
        merged = torch.cat([p["tensors"][k] for p in payloads], dim=dim)
        rows = live[k].shape[dim]
        if merged.shape[dim] != rows * world:
            raise ValueError(
                f"batch-size mismatch at {where}: {len(payloads)} saved "
                f"shard(s) hold {merged.shape[dim]} walkers, but the live "
                f"run's global batch is {rows * world} ({world} process(es) "
                f"of {rows}); restore with a matching --batch instead")
        tensors[k] = merged.narrow(dim, rank * rows, rows)
    return _load_into(state, payloads[0], tensors)


def restore_checkpoint(directory: str, state):
    """Restore the latest checkpoint of ``directory`` into ``state``.

    The tensors are copied into the live ones in place, Adam's state is
    loaded with the live run's hyperparameters kept, and both generators
    take their saved states.  Per-process ``procNNNNN`` shards and a
    one-process file are both read, whatever the live process count: the
    newest step wins, and a layout saved at another process count is
    merged and resliced (module docstring).

    Returns (state, step), or (state, 0) unchanged when the directory holds
    no checkpoint.  Raises ``ValueError`` when the saved structure differs
    from the live one beyond the walker split, or the saved global batch
    from the live one.
    """
    proc_dirs = []
    if os.path.isdir(directory):
        proc_dirs = sorted(
            d for d in os.listdir(directory)
            if d.startswith("proc") and os.path.isdir(os.path.join(directory, d)))
    direct = _latest_name(directory)
    shard = (_latest_name(os.path.join(directory, proc_dirs[0]))
             if proc_dirs else None)
    world = process_count()
    if shard is not None and (direct is None
                              or _step_of(shard) > _step_of(direct)):
        if world == 1 or len(proc_dirs) != world:
            return _restore_resharded(directory, proc_dirs, shard, state)
        name = shard  # every rank restores the step of proc00000
    elif direct is None:
        return state, 0
    elif world > 1:
        return _restore_resharded(directory, [], direct, state)
    else:
        name = direct
    directory = _proc_dir(directory)
    payload = _load(directory, name)
    want = _fingerprint(state, _saved_generators(payload))
    if payload["fingerprint"] != want:
        raise ValueError(
            f"checkpoint structure mismatch at "
            f"{os.path.join(directory, name)}: the saved TrainState layout "
            f"does not match the one being restored into.\n saved: "
            f"{payload['fingerprint']}\n  live: {want}")
    return _load_into(state, payload, payload["tensors"])
