"""A per-test hang guard for every pytest run of this repository.

A test still running after ``FF_TEST_HANG_SECONDS`` (300 by default; 0 or
less turns the guard off) has its process's Python stacks written to a
file and the process ended (``faulthandler.dump_traceback_later`` with
``exit=True``), so a deadlock costs one test and T seconds instead of the
whole run's time limit.  Under pytest-xdist the ended worker shows as a
crash of that test, and the test fails.  xdist hands the crashed test to
the replacement worker again; the guard records each test it arms in the
run's directory (keyed by xdist's ``testrunuid``), and a test handed out
again after it hung fails at once instead of hanging once more.

Files go to ``$TMPDIR/fermiflow-hang-guard-<testrunuid>/``:
``stacks-<worker>-<pid>.txt`` (the stacks; xdist drops a worker's stderr)
and ``armed-<hash>`` (the id of a test that was armed and never finished).
The directory is removed at the end of a run in which nothing hung; else
the terminal summary names it.

This file imports neither jax nor torch, and changes no test's outcome when
nothing hangs.
"""

from __future__ import annotations

import faulthandler
import hashlib
import os
import shutil
import tempfile
import uuid
from pathlib import Path

import pytest

HANG_SECONDS = float(os.environ.get("FF_TEST_HANG_SECONDS", "300"))
_DIR = pytest.StashKey[Path]()
_STACKS = pytest.StashKey[object]()


def _run_dir(uid: str) -> Path:
    return Path(tempfile.gettempdir()) / f"fermiflow-hang-guard-{uid}"


def _marker(config, nodeid: str) -> Path:
    return config.stash[_DIR] / ("armed-" + hashlib.sha1(
        nodeid.encode()).hexdigest()[:16])


def pytest_configure(config):
    if HANG_SECONDS <= 0:
        return
    worker = getattr(config, "workerinput", None)
    uid = worker["testrunuid"] if worker else uuid.uuid4().hex
    config.stash[_DIR] = _run_dir(uid)
    config.stash[_DIR].mkdir(parents=True, exist_ok=True)


@pytest.hookimpl(optionalhook=True)
def pytest_configure_node(node):
    """xdist controller: the workers share the run's testrunuid; keep the
    directory it names (the controller's own uid names an unused one)."""
    if HANG_SECONDS <= 0:
        return
    config = node.config
    run_dir = _run_dir(node.workerinput["testrunuid"])
    if config.stash[_DIR] != run_dir:
        shutil.rmtree(config.stash[_DIR], ignore_errors=True)
        config.stash[_DIR] = run_dir
        run_dir.mkdir(parents=True, exist_ok=True)


def _stacks_file(config):
    fh = config.stash.get(_STACKS, None)
    if fh is None:
        worker = getattr(config, "workerinput", {}).get("workerid", "main")
        fh = config.stash[_STACKS] = open(
            config.stash[_DIR] / f"stacks-{worker}-{os.getpid()}.txt", "w")
    return fh


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    config = item.config
    if HANG_SECONDS <= 0:
        return (yield)
    marker = _marker(config, item.nodeid)
    if marker.exists():
        pytest.fail(f"hung for {HANG_SECONDS:g} s earlier in this run (stacks "
                    f"in {config.stash[_DIR]}); not run again")
    marker.write_text(item.nodeid + "\n")
    faulthandler.dump_traceback_later(HANG_SECONDS, exit=True,
                                      file=_stacks_file(config))
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()
        marker.unlink(missing_ok=True)


def _hung(run_dir: Path):
    """(ids of tests armed and never finished, non-empty stacks files)."""
    ids = [p.read_text().strip() for p in sorted(run_dir.glob("armed-*"))]
    stacks = [p for p in sorted(run_dir.glob("stacks-*"))
              if p.stat().st_size]
    return ids, stacks


def pytest_terminal_summary(terminalreporter, config):
    if HANG_SECONDS <= 0 or getattr(config, "workerinput", None):
        return
    ids, stacks = _hung(config.stash[_DIR])
    if ids or stacks:
        terminalreporter.write_sep("=", "hang guard")
        for nodeid in ids:
            terminalreporter.write_line(f"hung > {HANG_SECONDS:g} s: {nodeid}")
        for p in stacks:
            terminalreporter.write_line(f"stacks: {p}")


def pytest_unconfigure(config):
    if HANG_SECONDS <= 0 or _DIR not in config.stash:
        return
    fh = config.stash.get(_STACKS, None)
    if fh is not None:
        fh.close()
    if not getattr(config, "workerinput", None) and not any(
            _hung(config.stash[_DIR])):
        shutil.rmtree(config.stash[_DIR], ignore_errors=True)
