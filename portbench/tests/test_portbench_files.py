"""Every file of the benchmark loads by name, and the yardstick holds the
numbers it was frozen at (CPU only)."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import counts
import harness
import reference

BENCH_DIR = Path(harness.__file__).resolve().parent
ROOT = BENCH_DIR.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    spec = harness.cell_spec(ROOT, cell)
    c = harness.shapes(spec)
    assert spec["limits"] and spec["per_layer"] and spec["end_to_end"]
    rate = "iter_ms.k1" if c["steps_per_call"] == 1 else "iter_ms"
    assert {m["name"] for m in spec["end_to_end"]} == {rate, "setup_s"}
    assert {m["moves"] for m in spec["per_layer"]} == {rate}
    cfg = harness.program_config(spec, 2**32 + 5, "cpu", Path("/nonexistent"))
    assert cfg.batch == c["batch"] and cfg.steps_per_call == c["steps_per_call"]
    assert cfg.seed == 2**32 + 5


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_readers_load_by_name(metric):
    mod = harness.load_module(BENCH_DIR / "metrics" / f"{metric}.py")
    assert callable(mod.read)


def test_every_launch_counter_has_a_kernel_file():
    from fermiflow_tpu_torch.ops import _build

    kernels = harness.kernel_map()
    assert set(kernels) == set(_build.LAUNCHES)
    sources = "".join(p.read_text() for p in
                      (ROOT / "fermiflow_tpu_torch" / "csrc").glob("*.cu"))
    for key, mod in kernels.items():
        name = re.sub(r"\\b", "", mod.SYMBOL)
        assert re.search(rf"\b{name}\(", sources), key


def test_frozen_counts_give_the_recorded_bounds():
    """PERF.md's bounds at N = 6, B = 8192, dopri5 x 4, 30 steps, 10
    segments: the Hessian flow 0.0613 ms, the adjoint 0.121 ms, the
    multi-segment sampler 0.0326 ms."""
    c = harness.shapes(harness.kept_out_spec("gs_n6.persistent_k10"))
    kernels = harness.kernel_map()
    bound = lambda k: counts.bound_ms(*kernels[k].work(c))[0]
    assert bound("hessian_flow") == pytest.approx(0.0613, abs=5e-5)
    assert bound("reinforce_adjoint") == pytest.approx(0.121, abs=5e-4)
    assert bound("metropolis_chains") == pytest.approx(0.0326, abs=5e-5)


def test_reference_tables_match_the_package():
    from fermiflow_tpu_torch.physics.orbitals import HO2D

    orb = HO2D()
    occ, es = orb.fermion_states(6, 0, 2.0)
    mine, mine_es = reference.slater_states(6, 2.0)
    assert mine.shape == (54, 6)
    np.testing.assert_array_equal(mine, occ)
    np.testing.assert_allclose(mine_es, es)
    nx, ny, _ = reference.ho2d_tables()
    np.testing.assert_array_equal(nx, orb.nx)
    np.testing.assert_array_equal(ny, orb.ny)


@pytest.mark.parametrize("name", ["reference.py", "check.py", "counts.py",
                                  "tracesum.py"])
def test_yardstick_imports_nothing_of_the_program(name):
    tree = ast.parse((BENCH_DIR / name).read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    assert not {m.split(".")[0] for m in mods} & {
        "fermiflow_tpu", "fermiflow_tpu_torch", "jax", "jaxlib", "flax"}


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import reference, check; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(BENCH_DIR))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    loaded = set(ast.literal_eval(out))
    assert not loaded & {"fermiflow_tpu", "fermiflow_tpu_torch", "jax",
                         "jaxlib", "flax"}


def test_forbidden_names_compare_whole_top_level_names():
    assert harness.forbidden_modules(["fermiflow_tpu_torch.train", "torch",
                                      "jax_extras"]) == []
    assert harness.forbidden_modules(["fermiflow_tpu.train", "jax.numpy",
                                      "flax"]) == ["fermiflow_tpu", "flax",
                                                   "jax"]
