"""Checkpoint and resume of the full training state, single process
(port of ``fermiflow_tpu/utils/checkpointing.py``).

A checkpoint is one ``torch.save`` file, ``ckpt_{step:08d}.pt``, written to
a temporary name and moved into place with ``os.replace`` (atomic, as
orbax's save).  It holds the whole ``TrainState``: the flow's parameters,
``optimizer.state_dict()`` (Adam's step and both moments), the chains
(``walkers_cm``, ``tau``), at finite T the logits, ``state_idx`` and
``sample_probs``, both generators' states and the step, with a structure
fingerprint (names, shapes and dtypes, as the JAX ``_fingerprint``).  The
sampler's seed is drawn from the host generator, so a run that saves at
step k and resumes is bitwise the run that never stopped, at equal chunk
boundaries.

The elastic restore of per-process ``procNNNNN`` shards (the JAX
``_restore_resharded``) belongs to the multi-process slice and is refused.
"""

from __future__ import annotations

import json
import os

import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "named_tensors"]

# TrainState fields saved beside the flow's parameters (None ones skipped).
_FIELDS = ("walkers_cm", "tau", "log_state_weights", "state_idx",
           "sample_probs")
_GENERATORS = ("generator", "device_generator")


def named_tensors(state) -> dict:
    """The state's tensors by name: the flow's parameters, then ``_FIELDS``.
    Live tensors: the flow's share storage with its parameters."""
    out = {"flow." + k: v for k, v in state.flow.state_dict().items()}
    for name in _FIELDS:
        t = getattr(state, name)
        if t is not None:
            out[name] = t
    return out


def _fingerprint(state) -> str:
    """Names, shapes and dtypes of the state's tensors, the form of each
    generator's state and the optimizer's parameter groups, so a restore
    into another layout (another N, batch or state count, or a ground-state
    checkpoint into a finite-T run) fails loudly.  Adam's moments are
    created at its first step and follow the parameters' shapes."""
    entries = [[name, list(t.shape), str(t.dtype)]
               for name, t in named_tensors(state).items()]
    for name in _GENERATORS:
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


def save_checkpoint(directory: str, step: int, state) -> str:
    """Save ``state`` as ``directory/ckpt_{step:08d}.pt``; returns the path."""
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
    return path


def _latest_name(directory: str):
    if not os.path.isdir(directory):
        return None
    ckpts = sorted(f for f in os.listdir(directory)
                   if f.startswith("ckpt_") and f.endswith(".pt"))
    return ckpts[-1] if ckpts else None


def restore_checkpoint(directory: str, state):
    """Restore the latest checkpoint of ``directory`` into ``state``.

    The tensors are copied into the live ones in place (the live optimizer
    keeps referring to the live parameters), Adam's state is loaded with the
    live run's hyperparameters kept (JAX's optimizer comes from the command
    line, not the checkpoint), and both generators take their saved states.

    Returns (state, step), or (state, 0) unchanged when the directory holds
    no checkpoint.  Raises ``ValueError`` when the saved structure differs
    from the live one and ``NotImplementedError`` for per-process shards.
    """
    if os.path.isdir(directory) and any(
            d.startswith("proc") and os.path.isdir(os.path.join(directory, d))
            for d in os.listdir(directory)):
        raise NotImplementedError(
            f"{directory} holds per-process procNNNNN checkpoints: their "
            "elastic restore comes with the multi-process slice "
            "(parallel/mesh.py), not ported yet")
    name = _latest_name(directory)
    if name is None:
        return state, 0
    path = os.path.join(directory, name)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    want = _fingerprint(state)
    if payload["fingerprint"] != want:
        raise ValueError(
            f"checkpoint structure mismatch at {path}: the saved TrainState "
            f"layout does not match the one being restored into.\n saved: "
            f"{payload['fingerprint']}\n  live: {want}")
    live = named_tensors(state)
    with torch.no_grad():
        for k, t in payload["tensors"].items():
            live[k].copy_(t)
    hyper = [{k: v for k, v in g.items() if k != "params"}
             for g in state.optimizer.param_groups]
    state.optimizer.load_state_dict(payload["optimizer"])
    for g, h in zip(state.optimizer.param_groups, hyper):
        g.update(h)
    for gname in _GENERATORS:
        g = getattr(state, gname)
        if g is not None:
            g.set_state(payload[gname])
    state.step = payload["step"]
    return state, state.step
