"""The spans of the training loop's host path (``utils/profiling.py``
``SPANS``): what the CLIs' loop, the metrics logger and the captured chunk
record, that a span opens a ``record_function`` range only while a profiler
runs, that ``--profile-dir`` traces carry them, and the ring's bound.

The captured chunk's spans are held here through the stand-in capture of
``tests/test_torch_graph.py``; the one test marked ``cuda`` replays real
graphs on the card (no JAX needed, hence no conftest there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans.py -q
"""

import json
from collections import Counter

import pytest
import torch

from fermiflow_tpu_torch import train
from fermiflow_tpu_torch.cli import common, ground_state
from fermiflow_tpu_torch.config import Config
from fermiflow_tpu_torch.utils import MetricsLogger
from fermiflow_tpu_torch.utils import profiling
from fermiflow_tpu_torch.utils.profiling import SPANS, PhaseTimer

LOOP = ("loop.chunk", "loop.wait", "loop.fetch", "loop.watchdog",
        "loop.print")
TINY = ["--nup", "3", "--batch", "32", "--Deta", "8", "--Dmu", "8",
        "--ode-steps", "2", "--equilibrium-steps", "5", "--lr", "1e-3"]


def gs_cli(iternum, steps_per_call=1, device="cpu", *flags):
    dtype = "float64" if device == "cpu" else "float32"
    return ground_state.main(TINY + [
        "--iternum", str(iternum), "--steps-per-call", str(steps_per_call),
        "--device", device, "--dtype", dtype, *flags])


def by_name(records):
    out = {}
    for chunk, name, parent, _, seconds in records:
        out.setdefault(name, []).append((chunk, parent, seconds))
    return out


@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_loop_records_each_span_once_a_chunk(steps_per_call):
    """A GS CLI run on the CPU: each loop span once a chunk, numbered from
    1, none inside another; at K = 1 through ``MetricsLogger.log``, at K = 2
    through ``log_many``.  Eager chunks record no ``chunk.*`` span."""
    gs_cli(6, steps_per_call)
    chunks = 6 // steps_per_call
    spans = by_name(SPANS.records)
    assert set(spans) == set(LOOP)
    for name in LOOP:
        assert [c for c, _, _ in spans[name]] == list(range(1, chunks + 1))
        assert all(p is None and s >= 0 for _, p, s in spans[name])
    assert len(SPANS.records) == len(LOOP) * chunks


class Counted:
    """``torch.profiler.record_function`` that counts the ranges opened."""

    def __init__(self):
        self.names = []
        self.real = torch.profiler.record_function

    def __call__(self, name, *args):
        self.names.append(name)
        return self.real(name, *args)


def test_spans_open_record_function_only_under_a_profiler(monkeypatch):
    """Without a profiler the program opens no ``record_function`` range (it
    costs ~10 us a use even then); under one, one range a span."""
    counted = Counted()
    monkeypatch.setattr(torch.profiler, "record_function", counted)
    gs_cli(3)
    assert counted.names == []
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        gs_cli(3)
    assert Counter(counted.names) == Counter(
        name for _, name, _, _, _ in SPANS.records)
    assert set(counted.names) == set(LOOP)


def test_profile_dir_trace_holds_each_span(tmp_path):
    """``--profile-dir`` (chunks 2-4 at K = 1) puts every loop span in the
    Chrome trace as a ``user_annotation`` beside the host's operators."""
    gs_cli(5, 1, "cpu", "--profile-dir", str(tmp_path))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = Counter(e["name"] for e in events
                    if e.get("cat") == "user_annotation")
    # The trace closes after chunk 4's fetch, before its watchdog and rows.
    assert {n: names[n] for n in LOOP} == {
        "loop.chunk": 3, "loop.wait": 3, "loop.fetch": 3,
        "loop.watchdog": 2, "loop.print": 2}


def test_ring_drops_the_oldest_records(monkeypatch):
    monkeypatch.setattr(profiling, "_RING", 4)
    timer = PhaseTimer()
    for chunk in range(1, 4):
        timer.chunk = chunk
        with timer.span("a"):
            pass
        with timer.span("b"):
            pass
    assert [(c, n) for c, n, _, _, _ in timer.records] == [
        (2, "a"), (2, "b"), (3, "a"), (3, "b")]
    timer.reset()
    assert not timer.records and timer.chunk == 0


def test_span_names_its_parent_and_outlives_an_exception():
    """A nested span records the innermost span open around it; a span that
    an exception leaves is recorded and closed, so the next has no
    parent."""
    timer = PhaseTimer()
    with pytest.raises(KeyError):
        with timer.span("outer"):
            with timer.span("inner"):
                raise KeyError
    with timer.span("after"):
        pass
    assert [(n, p) for _, n, p, _, _ in timer.records] == [
        ("inner", "outer"), ("outer", None), ("after", None)]
    assert timer.current is None


def captured_loop(iternum, steps_per_call, device):
    """``run_training_loop`` over the GS chunk with captured chunks (on the
    CPU, through the stand-in capture that the caller installs)."""
    cfg = Config(nup=3, batch=32, d_eta=8, d_mu=8, ode_steps=2,
                 equilibrium_steps=5, iternum=iternum,
                 steps_per_call=steps_per_call, device=device,
                 dtype="float64" if device == "cpu" else "float32")
    model, params = common.build_gs(cfg)
    state = train.init_gs_state(model, params, cfg,
                                params["eta"]["w1"].device)

    def make_chunk(k):
        chunk = (train.make_gs_fused_multi_step(model, cfg, k) if k > 1 else
                 train.make_multi_step(train.make_gs_train_step(model, cfg),
                                       k))
        if device == "cpu":
            chunk._captured = lambda state: True
        return chunk

    rows = []
    common.run_training_loop(state, cfg, make_chunk, MetricsLogger(),
                             rows.append)
    # Each row's metrics reach the host as numbers, the first of them
    # through the logger's wait.
    assert len(rows) == iternum and all(
        type(rec[k]) is float for rec in rows
        for k in ("E", "E_std", "accept_rate", "loss"))
    return by_name(SPANS.records)


def assert_replays_recorded(spans, chunks):
    """Chunk 1 warms up and captures; each later chunk is a replay, with its
    seeds and its launch inside ``loop.chunk``."""
    for name in ("chunk.seeds", "chunk.launch"):
        assert [(c, p) for c, p, _ in spans[name]] == [
            (c, "loop.chunk") for c in range(2, chunks + 1)]
    assert [c for c, _, _ in spans["loop.chunk"]] == list(range(1, chunks + 1))


@pytest.mark.parametrize("steps_per_call", [1, 3])
def test_replays_record_seeds_and_launch_inside_the_chunk(monkeypatch,
                                                          steps_per_call):
    """The captured chunk's host side on the CPU, the capture a stand-in
    that replays by running the body again (``tests/test_torch_graph.py``)."""
    monkeypatch.setattr(train, "_on_side_stream", lambda fn, device: fn())
    monkeypatch.setattr(train, "_capture", lambda fn, device, generators=(): (
        fn, 0.0, 0))
    assert_replays_recorded(
        captured_loop(4 * steps_per_call, steps_per_call, "cpu"), 4)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph replays only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_replays_record_seeds_and_launch_inside_the_chunk(card):
    assert_replays_recorded(captured_loop(4, 1, "cuda"), 4)
