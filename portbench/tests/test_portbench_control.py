"""On the card (marker ``cuda``): the control, the reference in float32
with TF32 matrix products put in the program's place on the program's own
walkers and parameters (``calibrate.in_place``), comes out not correct at
the cell's size; and a sound run of the program at the cell's size comes
out correct.  Run on the
card with

    python -m pytest -p no:cacheprovider -m cuda portbench/tests
"""

import json
import time
from pathlib import Path

import pytest
import torch

import calibrate
import check
import harness

ROOT = Path(harness.__file__).resolve().parent.parent
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control's TF32 products and "
                    "the program's kernels run there alone")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, card, tmp_path):
    spec = harness.cell_spec(ROOT, cell)
    c = harness.shapes(spec)
    res = harness.run_cell(spec, 977, 1.0, False, "cuda", time.perf_counter(),
                           tmp_path, keep=True)
    assert check.verdict(res["compared"], spec["limits"]), res["compared"]
    numbers = dict(res["compared"], **calibrate.in_place(c, res, card)[
        "control"])
    assert not check.verdict(numbers, spec["limits"]), numbers
