"""The repository's per-test hang guard (``conftest.py`` at the root), run
on a throwaway project in a pytest subprocess under xdist, as the full
command runs: a deliberate hang ends as a failed test within a few times
the guard's limit, the other tests pass, and the stacks file names the hung
frame; with nothing hung, every test passes and nothing is left behind."""

import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HANG_S = 3

TESTS = {
    "test_a.py": ("import time\n\n"
                  "def test_before():\n    pass\n\n"
                  "def test_hang():\n    time.sleep(1000)\n\n"
                  "def test_after():\n    pass\n"),
    "test_b.py": ("def test_b1():\n    pass\n\n"
                  "def test_b2():\n    pass\n"),
}


def run_project(tmp_path, hang: bool):
    proj = tmp_path / "proj"
    (proj / "tests").mkdir(parents=True)
    shutil.copy(ROOT / "conftest.py", proj / "conftest.py")
    (proj / "pyproject.toml").write_text(
        '[tool.pytest.ini_options]\ntestpaths = ["tests"]\n')
    for name, src in TESTS.items():
        if not hang:
            src = src.replace("time.sleep(1000)", "pass")
        (proj / "tests" / name).write_text(src)
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    env = dict(os.environ, FF_TEST_HANG_SECONDS=str(HANG_S), TMPDIR=str(tmp))
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "-q", "-p",
         "no:cacheprovider", "-p", "xdist", "-n", "2", "--dist", "loadfile",
         "-p", "no:randomly", "-rf"],
        cwd=proj, env=env, capture_output=True, text=True, timeout=120)
    return proc, time.monotonic() - t0, tmp


def test_a_hang_fails_one_test_and_leaves_its_stacks(tmp_path):
    proc, wall, tmp = run_project(tmp_path, hang=True)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 1, out
    # One guard limit for the hang, one worker restart, the rest: well
    # inside 10x the limit (xdist's own restart cap would take 8 x T).
    assert wall < 10 * HANG_S + 20, out
    failed = set(re.findall(r"^FAILED (\S+)", out, re.M))
    assert failed == {"tests/test_a.py::test_hang"}, out
    assert re.search(r"\b4 passed\b", out), out
    stacks = [p for p in tmp.glob("fermiflow-hang-guard-*/stacks-*.txt")
              if p.stat().st_size]
    assert len(stacks) == 1, out
    text = stacks[0].read_text()
    assert re.search(r'test_a\.py", line \d+ in test_hang', text), text
    assert f"stacks: {stacks[0]}" in out


def test_nothing_hung_passes_and_leaves_nothing(tmp_path):
    proc, _, tmp = run_project(tmp_path, hang=False)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    assert re.search(r"\b5 passed\b", out), out
    assert not list(tmp.glob("fermiflow-hang-guard-*")), out
