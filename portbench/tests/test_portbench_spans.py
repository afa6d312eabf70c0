"""The "chunk loop" metrics that read the program's spans
(``spanread.py``, ``metrics/loop_*.py`` and ``metrics/chunk_*.py``), in a
traced run of the fresh cell at a tiny size on the CPU, where every chunk
is eager."""

import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

import harness
import spanread

ROOT = Path(harness.__file__).resolve().parent.parent
CELL = "gs_n6.fresh_k1"
LOOP = ["loop_chunk_ms", "loop_wait_ms", "loop_fetch_ms", "loop_watchdog_ms",
        "loop_print_ms"]
CHUNK = ["chunk_seeds_ms", "chunk_launch_ms"]


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    spec = harness.cell_spec(ROOT, CELL)
    spec["conf"] = dict(spec["conf"], nup=3, batch=64, d_eta=4, d_mu=4,
                        ode_steps=1, dtype="float64")
    res = harness.run_cell(spec, 3_000_000_321, 1.0, True, "cpu",
                           time.perf_counter(), tmp_path_factory.mktemp("run"))
    assert res["failure"] is None and res["attempted"] > 0
    return spec, res


def test_the_cell_lists_every_span_metric():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    listed = {m["name"]: m for m in bench["per_layer"]}
    for name in LOOP + CHUNK:
        m = listed[name + ".k1"]
        assert (m["layer"], m["moves"], m["workloads"]) == (
            "chunk loop", "iter_ms.k1", [CELL])
        # The kept-out cells' rehearsal reads the plain-named files.
        assert (ROOT / "portbench" / "metrics" / f"{name}.py").exists()


def test_loop_spans_read_and_eager_chunks_leave_chunk_spans_silent(traced):
    _, res = traced
    read = res["per_layer"]
    assert all(read[m + ".k1"] >= 0 for m in LOOP)
    assert not {m + ".k1" for m in CHUNK} & set(read)


def test_window_is_the_harness_window(traced):
    """The readers' window holds ``attempted`` / K chunks, and they are the
    chunks whose ``loop.chunk`` starts inside the window, as the harness's
    ``chunk_call`` spans do."""
    spec, res = traced
    c = harness.shapes(spec)
    ctx = SimpleNamespace(c=c, wall_ms_per_iter=res["iter_ms"])
    first, last, t_open, t_close = spanread.window(ctx)
    assert first == c["warmup_chunks"] + 1
    assert (last - first + 1) * c["steps_per_call"] == res["attempted"]
    from fermiflow_tpu_torch.utils.profiling import SPANS

    inside = [n for n, name, _, t, _ in SPANS.records
              if name == "loop.chunk" and t_open <= t < t_close]
    assert inside == list(range(first, last + 1))


def test_loop_spans_tile_the_iteration(traced):
    """``loop.chunk`` holds the harness's ``chunk_call`` and its own
    ``record_function``; the five loop spans leave only the loop's glue
    and the harness's wrappers of the logger out of the wall time."""
    _, res = traced
    read = res["per_layer"]
    gap = read["loop_chunk_ms.k1"] - read["chunk_call_ms.k1"]
    assert 0 <= gap < 0.05
    tiled = sum(read[m + ".k1"] for m in LOOP)
    assert 0 <= res["iter_ms"] - tiled < 0.5
