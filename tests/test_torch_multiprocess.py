"""The port's CLIs as 2-process runs on the CPU (gloo), the counterpart of
``tests/test_multiprocess.py``: bring-up, rank 0 alone printing rows, the
per-process checkpoints, and resume at the same and at another process
count.  The ground-state walkers never depend on the parameters and the
samplers' streams are keyed by the global walker, so every resume is
checked bitwise against the uninterrupted run.  Each rank is a
``python -m fermiflow_tpu_torch.cli...`` process killed on failure, with
its own ``--init-timeout`` and a ``communicate`` timeout.
"""

import json
import os
import re
import shutil
import subprocess
import sys

import torch

import _torch_port as tp
from fermiflow_tpu_torch.cli import ground_state

GS = ["--nup", "3", "--Z", "0.5", "--batch", "32", "--Deta", "8", "--Dmu",
      "8", "--ode-steps", "2", "--equilibrium-steps", "4", "--mcmc-steps",
      "4", "--persistent", "--dtype", "float64", "--lr", "1e-3", "--device",
      "cpu", "--checkpoint-every", "1"]
BETA = ["--nup", "3", "--Z", "0.5", "--batch", "32", "--Deta", "8",
        "--Dmu", "8", "--ode-steps", "2", "--equilibrium-steps", "4",
        "--mcmc-steps", "4", "--dtype", "float64", "--beta", "2.0",
        "--deltaE", "2.0", "--boltzmann", "--persistent", "--device", "cpu",
        "--iternum", "2"]
ROW = re.compile(r"iter: (\d+) E: ([\d.eE+-]+)")


def _pair(cli, argv, timeout=240):
    """Both ranks' outputs of ``cli`` over 2 processes."""
    port = tp.free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"fermiflow_tpu_torch.cli.{cli}", *argv,
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(rank), "--init-timeout", "60"],
        env=tp.child_env(), cwd=tp.REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in (0, 1)]
    return tp.communicate_all(procs, timeout)


def _gs(iters, ckpt):
    return GS + ["--iternum", str(iters), "--checkpoint-dir", str(ckpt)]


def _ckpt(directory, step, rank=None):
    sub = "" if rank is None else f"proc{rank:05d}"
    return torch.load(os.path.join(directory, sub, f"ckpt_{step:08d}.pt"),
                      weights_only=True)


def _walkers(directory, step, world):
    """The global (walkers_cm, tau) of a checkpoint step."""
    if world == 1:
        t = _ckpt(directory, step)["tensors"]
        return t["walkers_cm"], t["tau"]
    parts = [_ckpt(directory, step, r)["tensors"] for r in range(world)]
    return (torch.cat([p["walkers_cm"] for p in parts], dim=1),
            torch.cat([p["tau"] for p in parts]))


def _assert_same_payload(a, b):
    assert a["step"] == b["step"] and a["fingerprint"] == b["fingerprint"]
    for k, t in a["tensors"].items():
        assert torch.equal(t, b["tensors"][k]), k
    for name in ("generator", "device_generator"):
        if name in a:
            assert torch.equal(a[name], b[name]), name


def _copy_step(src, dst, step):
    """A checkpoint directory holding only ``src``'s step ``step``."""
    for root, _, files in os.walk(src):
        name = f"ckpt_{step:08d}.pt"
        if name in files:
            out = os.path.join(dst, os.path.relpath(root, src))
            os.makedirs(out, exist_ok=True)
            shutil.copy(os.path.join(root, name), out)


def test_two_process_ground_state_cli_and_its_resumes(tmp_path):
    """3 iterations as 2 processes and as one: both ranks print the
    bring-up line, rank 0 alone the rows, which sit on the N=3 Z=0.5
    oracle (E about 6) and agree with the one-process rows (rtol 1e-9);
    each rank writes its own procNNNNN files.  Then the resumes from step
    2: 2 -> 2 processes gives the uninterrupted 2-process step-3 shards
    bitwise (every tensor, both generators); 2 -> 1 and 1 -> 2 give the
    one-process run's step-3 walkers and tau bitwise."""
    whole2, whole1 = tmp_path / "whole2", tmp_path / "whole1"
    outs = _pair("ground_state", _gs(3, whole2))
    for rank, out in enumerate(outs):
        assert re.search(rf"torch.distributed: process {rank}/2, backend "
                         r"gloo, device cpu", out), out[-2000:]
    rows = ROW.findall(outs[0])
    assert [int(i) for i, _ in rows] == [1, 2, 3], outs[0][-2000:]
    assert not ROW.search(outs[1]), outs[1][-2000:]
    assert "mesh: 2 ranks over gloo" in outs[0]
    assert sorted(os.listdir(whole2)) == ["proc00000", "proc00001"]
    assert sorted(os.listdir(whole2 / "proc00001")) == [
        f"ckpt_{s:08d}.pt" for s in (1, 2, 3)]

    ground_state.main(_gs(3, whole1) + ["--metrics", str(tmp_path / "m")])
    es1 = [json.loads(line)["E"]
           for line in (tmp_path / "m").read_text().splitlines()]
    for (_, e2), e1 in zip(rows, es1):
        assert 5.0 < e1 < 7.5 and abs(float(e2) - e1) <= 1e-9 * abs(e1)
    want = _walkers(whole1, 3, 1)
    for step in (1, 2, 3):
        for a, b in zip(_walkers(whole2, step, 2), _walkers(whole1, step, 1)):
            assert torch.equal(a, b), step

    # 2 -> 2: the run cut at step 2 resumes to the uninterrupted shards.
    cut = tmp_path / "cut22"
    _copy_step(whole2, cut, 2)
    outs = _pair("ground_state", _gs(3, cut))
    assert "resumed from checkpoint step 2" in outs[0]
    assert [int(i) for i, _ in ROW.findall(outs[0])] == [3]
    for rank in (0, 1):
        _assert_same_payload(_ckpt(cut, 3, rank), _ckpt(whole2, 3, rank))

    # 2 -> 1: the step-2 shards merged into one process.
    cut = tmp_path / "cut21"
    _copy_step(whole2, cut, 2)
    ground_state.main(_gs(3, cut))
    for a, b in zip(_walkers(cut, 3, 1), want):
        assert torch.equal(a, b)

    # 1 -> 2: the one-process step-2 file sliced over two processes.
    cut = tmp_path / "cut12"
    _copy_step(whole1, cut, 2)
    _pair("ground_state", _gs(3, cut))
    for a, b in zip(_walkers(cut, 3, 2), want):
        assert torch.equal(a, b)


def test_two_process_finite_t_cli(tmp_path):
    """Finite T as 2 processes: the coupled state refresh and the
    per-state sums over the global batch; rank 0 alone prints, with the
    21 states of N=3, deltaE=2, and F below E, S_analytical about 2."""
    outs = _pair("finite_t", BETA + ["--metrics", str(tmp_path / "m")])
    assert "total number of states = 21" in outs[0]
    assert "iter:" not in outs[1] and "total number" not in outs[1]
    rows = re.findall(r"iter: \d+ F: ([\d.eE+-]+) .* E: ([\d.eE+-]+) .* "
                      r"S: ([\d.eE+-]+) S_analytical: ([\d.eE+-]+)", outs[0])
    assert len(rows) == 2, outs[0][-2000:]
    for F, E, S, S_an in ((float(v) for v in r) for r in rows):
        assert 5.0 < E < 9.5 and F < E
        assert 0.2 < S_an < 3.05 and abs(S - S_an) < 1.5
    assert len((tmp_path / "m").read_text().splitlines()) == 2
