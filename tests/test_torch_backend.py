"""The walker mesh's per-host backend and card choice
(``fermiflow_tpu_torch/parallel/mesh.py``): the ranks on this host come
from ``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` where a launcher sets them, else
from a hostname exchange through the rendezvous store; NCCL where this
host has a card per rank, gloo otherwise; rank r takes card (its local
rank) mod (cards of the host).  The card counts are monkeypatched; the
hostname route runs as 2 gloo processes on the CPU.
"""

import re
import subprocess
import sys

import pytest
import torch

import _torch_port as tp
from fermiflow_tpu_torch.parallel import mesh

LOCAL = ("LOCAL_RANK", "LOCAL_WORLD_SIZE")


@pytest.mark.parametrize(
    "case, device, cards, rank, world, local, expect",
    [
        # 2 hosts x 8 cards, 16 ranks: a card per rank on each host.
        ("2x8", "cuda", 8, 13, 16, (5, 8), ("nccl", 5)),
        # 2 ranks sharing the one card of the host.
        ("2on1", "cuda", 1, 1, 2, (1, 2), ("gloo", 0)),
        # One rank on a one-card host.
        ("1on1", "cuda", 1, 0, 1, (0, 1), ("nccl", 0)),
        # 4 ranks on a 2-card host: two ranks a card.
        ("4on2", "cuda", 2, 3, 4, (3, 4), ("gloo", 1)),
        # Ranks on the CPU: gloo whatever the host's cards.
        ("cpu", "cpu", 8, 13, 16, (5, 8), ("gloo", None)),
    ])
def test_backend_and_card_from_launcher(monkeypatch, case, device, cards,
                                        rank, world, local, expect):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setenv("LOCAL_RANK", str(local[0]))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local[1]))
    # The launcher's variables win: the store is never asked.
    assert mesh._local_ranks(None, rank, world) == local
    dev = torch.device(device)
    backend = mesh._backend_for(dev, local[1])
    assert backend == expect[0]
    if dev.type == "cuda":
        assert local[0] % cards == expect[1]


def test_host_ranks_do_not_assume_host_by_host_numbering():
    # 16 ranks numbered round-robin over two hosts.
    hosts = ["a", "b"] * 8
    assert mesh._host_ranks(hosts, 11) == (5, 8)
    assert mesh._host_ranks(hosts, 0) == (0, 8)
    # Uneven hosts: 3 ranks on "a", 1 on "b".
    hosts = ["a", "a", "b", "a"]
    assert [mesh._host_ranks(hosts, r) for r in range(4)] == \
        [(0, 3), (1, 3), (0, 1), (2, 3)]


class _FakeStore:
    def __init__(self, *args, **kwargs):
        self.kv = {}

    def set(self, key, value):
        self.kv[key] = value.encode()

    def get(self, key):
        return self.kv[key]


def test_init_distributed_takes_the_local_card(monkeypatch):
    """Rank 3 of 16 in a world numbered round-robin over two hosts of 8
    cards, local rank 1 of 8 by the launcher: NCCL on card 1, where rank
    mod cards would take card 3."""
    calls = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: calls.setdefault("card", i))
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: calls["card"])
    monkeypatch.setattr(mesh.dist, "TCPStore", _FakeStore)
    monkeypatch.setattr(
        mesh.dist, "init_process_group",
        lambda backend, **kw: calls.update(backend=backend, **kw))
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert mesh.init_distributed("127.0.0.1:1", 16, 3, 5, device="cuda")
    assert calls["backend"] == "nccl"
    assert calls["card"] == 1
    assert (calls["world_size"], calls["rank"]) == (16, 3)


def test_init_distributed_hostname_route_without_launcher(monkeypatch):
    """No launcher variables: the ranks exchange hostnames through the
    store.  Rank 6 of 16 numbered round-robin over two hosts is the fourth
    of its host's eight ranks: NCCL on card 3."""
    calls = {}
    store = _FakeStore()
    for r in range(16):
        if r != 6:
            store.set(f"hostname/{r}", "a" if r % 2 == 0 else "b")
    monkeypatch.setattr(mesh.socket, "gethostname", lambda: "a")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: calls.setdefault("card", i))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: calls["card"])
    monkeypatch.setattr(mesh.dist, "TCPStore", lambda *a, **k: store)
    monkeypatch.setattr(
        mesh.dist, "init_process_group",
        lambda backend, **kw: calls.update(backend=backend, **kw))
    for name in LOCAL:
        monkeypatch.delenv(name, raising=False)
    assert mesh.init_distributed("127.0.0.1:1", 16, 6, 5, device="cuda")
    assert (calls["backend"], calls["card"]) == ("nccl", 3)


CHILD = """
import sys, torch
from fermiflow_tpu_torch.parallel import mesh
port, rank = int(sys.argv[1]), int(sys.argv[2])
mesh.init_distributed(f"127.0.0.1:{port}", 2, rank, 60, device="cpu")
t = torch.tensor([float(rank + 1)])
torch.distributed.all_reduce(t)
print("sum", float(t))
mesh.shutdown_distributed()
"""


def test_hostname_route_two_gloo_ranks():
    """Two CPU ranks without launcher variables find each other on this
    host through the hostname exchange, then sum over gloo."""
    env = tp.child_env()
    for name in LOCAL:
        env.pop(name, None)
    port = tp.free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(port), str(rank)], env=env,
        cwd=tp.REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in (0, 1)]
    outs = tp.communicate_all(procs, 60)
    for rank, out in enumerate(outs):
        assert re.search(rf"torch.distributed: process {rank}/2, backend "
                         rf"gloo, device cpu, local rank {rank} of 2 on this "
                         rf"host", out), out
        assert "sum 3.0" in out, out
