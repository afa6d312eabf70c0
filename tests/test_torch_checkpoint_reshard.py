"""Elastic checkpoints of the port's walker mesh: the four cases of
``tests/test_checkpoint_reshard.py`` on the port's layout (per-process
``procNNNNN/ckpt_*.pt`` files, the walkers coordinate-major), the
same-count restore, and the refusals.

A process count and rank are played by patching the checkpoint module's
``process_count``/``process_index`` (and its barrier), so the real
``save_checkpoint`` writes each rank's shard and the real
``restore_checkpoint`` reads them; ``tests/test_torch_multiprocess.py``
runs the same through real process groups.  A rank's state holds its
contiguous rows of a recognizable global payload (walkers numbered in
order, tau a ramp, states a ramp), and a shard permutation, a wrong
walker axis or a wrong row offset would show.
"""

import os

import pytest
import torch

from fermiflow_tpu_torch.cli import common
from fermiflow_tpu_torch.config import Config
from fermiflow_tpu_torch.parallel.mesh import WalkerMesh
from fermiflow_tpu_torch.train import (
    init_beta_state,
    init_gs_state,
    make_gs_train_step,
    make_multi_step,
)
from fermiflow_tpu_torch.utils import checkpointing as ck

BATCH = 16
CPU = torch.device("cpu")


def _state(finite, rank=0, world=1, batch=BATCH, nup=2, seed=0):
    """A fresh state of ``rank`` of ``world`` (its rows of ``batch``)."""
    cfg = Config(nup=nup, batch=batch, d_eta=8, d_mu=8, dtype="float64",
                 device="cpu", seed=seed, deltaE=1.0, boltzmann=True)
    mesh = WalkerMesh(rank, world, CPU) if world > 1 else None
    if finite:
        model, params = common.build_beta(cfg)
        return init_beta_state(model, params, cfg, CPU, mesh)
    model, params = common.build_gs(cfg)
    return init_gs_state(model, params, cfg, CPU, mesh)


def _payload(finite, seed=0, batch=BATCH):
    """A one-process state with a recognizable payload and Adam's moments
    (one step on fixed gradients) and both generators moved on."""
    st = _state(finite, batch=batch, seed=seed)
    d = st.walkers_cm.shape[0]
    with torch.no_grad():
        st.walkers_cm.copy_(torch.arange(d * batch, dtype=torch.float64)
                            .reshape(d, batch) + 1000 * seed)
        st.tau.copy_(torch.linspace(0.1, 0.9, batch) + seed)
        if finite:
            st.state_idx.copy_(torch.arange(batch) % 5)
    for p in st.optimizer.param_groups[0]["params"]:
        p.grad = torch.full_like(p, 0.5 + seed)
    st.optimizer.step()
    torch.rand(3 + seed, generator=st.generator)
    torch.rand(5 + seed, generator=st.device_generator)
    st.step = 7 + seed
    return st


def _rows_of(full, rank, world, finite):
    """The state that ``rank`` of ``world`` holds of the one-process
    ``full``: its rows of the walker-axis tensors, the rest replicated."""
    st = _state(finite, rank, world, batch=full.walkers_cm.shape[1])
    rows = full.walkers_cm.shape[1] // world
    live, src = ck.named_tensors(st), ck.named_tensors(full)
    with torch.no_grad():
        for k, t in live.items():
            s = src[k]
            if k in ck._SHARDED:
                s = s.narrow(ck._SHARDED[k], rank * rows, rows)
            t.copy_(s)
    st.optimizer.load_state_dict(full.optimizer.state_dict())
    for g in ("generator", "device_generator"):
        if getattr(st, g) is not None:
            getattr(st, g).set_state(getattr(full, g).get_state())
    st.step = full.step
    return st


def _as_rank(monkeypatch, rank, world):
    monkeypatch.setattr(ck, "process_count", lambda: world)
    monkeypatch.setattr(ck, "process_index", lambda: rank)
    monkeypatch.setattr(ck, "barrier", lambda: None)


def _save_shards(monkeypatch, directory, full, world, step, finite):
    for rank in range(world):
        _as_rank(monkeypatch, rank, world)
        ck.save_checkpoint(directory, step, _rows_of(full, rank, world,
                                                     finite))
    _as_rank(monkeypatch, 0, 1)


def _restore_as(monkeypatch, directory, rank, world, finite, **kw):
    _as_rank(monkeypatch, rank, world)
    fresh = _state(finite, rank, world, seed=99, **kw)
    return ck.restore_checkpoint(directory, fresh)


def _assert_equal(a, b):
    ta, tb = ck.named_tensors(a), ck.named_tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    for i in sa["state"]:
        for k, v in sa["state"][i].items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    for g in ("generator", "device_generator"):
        if getattr(a, g) is not None:
            assert torch.equal(getattr(a, g).get_state(),
                               getattr(b, g).get_state()), g
    assert a.step == b.step


@pytest.mark.parametrize("finite", [False, True])
def test_two_proc_shards_merge_into_single(tmp_path, monkeypatch, finite):
    full = _payload(finite)
    _save_shards(monkeypatch, str(tmp_path), full, 2, 7, finite)
    assert sorted(os.listdir(tmp_path)) == ["proc00000", "proc00001"]
    restored, step = _restore_as(monkeypatch, str(tmp_path), 0, 1, finite)
    assert step == 7
    _assert_equal(restored, full)


@pytest.mark.parametrize("newer", ["single", "shards"])
def test_newest_step_wins_in_a_mixed_directory(tmp_path, monkeypatch, newer):
    """Old 2-process shards and a later one-process save in one directory
    (an elastic resume that kept checkpointing): the newest step wins,
    whichever layout holds it."""
    old, new = _payload(False, seed=1), _payload(False, seed=2)
    shards, single = (old, new) if newer == "single" else (new, old)
    _save_shards(monkeypatch, str(tmp_path), shards, 2, shards.step, False)
    ck.save_checkpoint(str(tmp_path), single.step, single)
    restored, step = _restore_as(monkeypatch, str(tmp_path), 0, 1, False)
    assert step == new.step
    _assert_equal(restored, new)


@pytest.mark.parametrize("rank", [0, 1])
def test_shards_restore_into_another_process_count(tmp_path, monkeypatch,
                                                   rank):
    """4 saved shards into a live world of 2 (the counterpart of the
    8-device mesh save restored onto one device): merged, then each live
    rank keeps its rows."""
    full = _payload(True)
    _save_shards(monkeypatch, str(tmp_path), full, 4, 7, True)
    restored, step = _restore_as(monkeypatch, str(tmp_path), rank, 2, True)
    assert step == 7
    _assert_equal(restored, _rows_of(full, rank, 2, True))


@pytest.mark.parametrize("finite,rank", [(False, 0), (False, 1), (True, 1)])
def test_plain_save_restores_into_sharded_state(tmp_path, monkeypatch, finite,
                                                rank):
    """A one-process checkpoint into a 2-rank run: each rank slices its
    rows out of the global file."""
    full = _payload(finite)
    ck.save_checkpoint(str(tmp_path), 7, full)
    restored, step = _restore_as(monkeypatch, str(tmp_path), rank, 2, finite)
    assert step == 7
    _assert_equal(restored, _rows_of(full, rank, 2, finite))


def test_same_process_count_restores_each_rank_its_shard(tmp_path,
                                                        monkeypatch):
    full = _payload(True)
    _save_shards(monkeypatch, str(tmp_path), full, 2, 7, True)
    for rank in (0, 1):
        restored, step = _restore_as(monkeypatch, str(tmp_path), rank, 2,
                                     True)
        assert step == 7
        _assert_equal(restored, _rows_of(full, rank, 2, True))


@pytest.mark.parametrize("saved_world,live_world", [(2, 1), (1, 2), (2, 4)])
def test_batch_mismatch_raises(tmp_path, monkeypatch, saved_world,
                               live_world):
    """A saved global batch of 16 restored into a live run of 32 walkers,
    whatever the two process counts: a ``ValueError`` naming --batch."""
    full = _payload(False)
    if saved_world == 1:
        ck.save_checkpoint(str(tmp_path), 7, full)
    else:
        _save_shards(monkeypatch, str(tmp_path), full, saved_world, 7, False)
    with pytest.raises(ValueError, match="batch-size mismatch.*--batch"):
        _restore_as(monkeypatch, str(tmp_path), 0, live_world, False,
                    batch=2 * BATCH)


def test_resharded_restore_refuses_another_structure(tmp_path, monkeypatch):
    """Shards of an N=2 run restored into an N=3 one fail as the
    one-process restore does."""
    _save_shards(monkeypatch, str(tmp_path), _payload(False), 2, 7, False)
    with pytest.raises(ValueError, match="structure mismatch"):
        _restore_as(monkeypatch, str(tmp_path), 0, 1, False, nup=3)


def _fresh_gs(rank=0, world=1):
    """A fresh-walker GS state of ``rank`` of ``world`` (no process group)
    and a chunk of 2 one-segment iterations, each chain started from the
    device generator's draw."""
    cfg = Config(nup=2, batch=BATCH, d_eta=8, d_mu=8, ode_steps=1,
                 equilibrium_steps=3, lr=1e-2, dtype="float64", device="cpu")
    mesh = WalkerMesh(rank, world, CPU) if world > 1 else None
    model, params = common.build_gs(cfg)
    return (init_gs_state(model, params, cfg, CPU, mesh),
            make_multi_step(make_gs_train_step(model, cfg, mesh), 2))


def test_fresh_walker_shards_resume_in_one_process_bitwise(tmp_path,
                                                           monkeypatch):
    """Fresh walkers, 2 -> 1: two ranks run a chunk of 2 iterations, each
    drawing its rows of the global fresh draw from the replicated device
    generator, and save their shards; one process restores them and runs
    the next chunk.  Its walkers and both generators are bitwise those of
    the one-process run of 4 iterations (the GS chains never depend on the
    parameters, which here each rank fits to its own rows)."""
    whole, chunk = _fresh_gs()
    for _ in range(2):
        whole, _ = chunk(whole)
    for rank in range(2):
        st, ch = _fresh_gs(rank, 2)
        st, _ = ch(st)
        _as_rank(monkeypatch, rank, 2)
        ck.save_checkpoint(str(tmp_path), 2, st)
    _as_rank(monkeypatch, 0, 1)
    resumed, chunk = _fresh_gs()
    resumed, step = ck.restore_checkpoint(str(tmp_path), resumed)
    assert step == 2
    resumed, _ = chunk(resumed)
    assert torch.equal(resumed.walkers_cm, whole.walkers_cm)
    for g in ("generator", "device_generator"):
        assert torch.equal(getattr(resumed, g).get_state(),
                           getattr(whole, g).get_state()), g
