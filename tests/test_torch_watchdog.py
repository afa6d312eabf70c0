"""The port's divergence watchdog against the JAX CLI's.

One seeded numpy metric stream goes through both packages'
``run_training_loop`` by a fake step that returns its next record: a healthy
trailing window, then a finite spike of the primary metric or of its
per-walker std.  At the default window (50) and threshold (10 sigma) both
loops must stop with the same ``FloatingPointError`` at the same iteration,
at one iteration per call and at two; with ``divergence_nsigma = 0`` both
must run through and print every row.
"""

import argparse
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fermiflow_tpu.cli import common as jcommon
from fermiflow_tpu.config import Config as JConfig
from fermiflow_tpu.utils import MetricsLogger as JLogger

from fermiflow_tpu_torch.cli import common
from fermiflow_tpu_torch.config import Config
from fermiflow_tpu_torch.utils import MetricsLogger

ITERS, SPIKE_AT = 64, 57  # the spike is iteration 57 (1-based)


def stream(key, spike):
    """(metric, metric_std) per iteration: noise around 20 and 1, with the
    spike (if any) at SPIKE_AT."""
    rng = np.random.default_rng(6)
    val = 20.0 + 0.05 * rng.standard_normal(ITERS)
    std = 1.0 + 0.05 * np.abs(rng.standard_normal(ITERS))
    if spike == "metric":
        val[SPIKE_AT - 1] = 21.0  # finite, ~20 window-sigmas above the mean
    elif spike == "std":
        std[SPIKE_AT - 1] = 15.0  # ~15x the window median
    return {key: val, key + "_std": std}


def run_jax(metrics, K, nsigma):
    cfg = JConfig(nup=2, batch=8, iternum=ITERS, steps_per_call=K,
                  dtype="float64", divergence_nsigma=nsigma)
    table = {k: jnp.asarray(v) for k, v in metrics.items()}

    def fake_step(i):
        return i + 1, {k: v[i] for k, v in table.items()}

    seen = []
    args = types.SimpleNamespace(profile_dir=None)
    jcommon.run_training_loop(jnp.asarray(0), 0, cfg, args,
                              lambda jit: fake_step, JLogger(None),
                              primary=True, print_row=seen.append)
    return seen


def run_port(metrics, K, nsigma):
    cfg = Config(nup=2, batch=8, iternum=ITERS, steps_per_call=K,
                 dtype="float64", device="cpu", divergence_nsigma=nsigma)
    table = {k: torch.as_tensor(v) for k, v in metrics.items()}

    def make_chunk(chunk):
        return lambda i: (i + chunk,
                          {k: v[i:i + chunk] for k, v in table.items()})

    seen = []
    common.run_training_loop(0, cfg, make_chunk, MetricsLogger(None),
                             seen.append)
    return seen


def outcome(run, *args):
    """("raised", message) or ("ran", the printed steps)."""
    try:
        seen = run(*args)
    except FloatingPointError as e:
        return "raised", str(e)
    return "ran", [r["step"] for r in seen]


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("key", ["E", "F"])
@pytest.mark.parametrize("spike", ["metric", "std"])
def test_divergence_stops_both_packages_at_the_same_iteration(spike, key, K):
    metrics = stream(key, spike)
    j = outcome(run_jax, metrics, K, 10.0)
    p = outcome(run_port, metrics, K, 10.0)
    assert p[0] == "raised" and p[1].startswith("divergence (")
    # The whole K-iteration chunk is checked: it stops at the chunk's end.
    assert f"at iteration {SPIKE_AT + (K - 1) * (SPIKE_AT % K)} " in p[1]
    assert p == j


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("spike", ["metric", "std"])
def test_divergence_check_off_at_nsigma_zero(spike, K):
    metrics = stream("E", spike)
    j = outcome(run_jax, metrics, K, 0.0)
    p = outcome(run_port, metrics, K, 0.0)
    assert p == j == ("ran", list(range(1, ITERS + 1)))


@pytest.mark.parametrize("K", [1, 2])
def test_healthy_stream_runs_through(K):
    metrics = stream("E", None)
    assert (outcome(run_port, metrics, K, 10.0)
            == outcome(run_jax, metrics, K, 10.0)
            == ("ran", list(range(1, ITERS + 1))))


def test_nonfinite_metric_raises_as_jax_does():
    metrics = stream("E", None)
    metrics["E"][9] = np.nan
    j = outcome(run_jax, metrics, 2, 10.0)
    p = outcome(run_port, metrics, 2, 10.0)
    assert p == j and p[1].startswith("non-finite energy (E=nan) at "
                                      "iteration 10 ")


@pytest.mark.parametrize("finite_t", [False, True])
def test_cli_passes_divergence_flags_to_config(finite_t):
    parser = argparse.ArgumentParser()
    common.add_flags(parser, finite_t)
    extra = ["--beta", "2.0"] if finite_t else []
    d = parser.parse_args(extra)
    assert (d.divergence_window, d.divergence_nsigma) == (
        JConfig().divergence_window, JConfig().divergence_nsigma)
    cfg = common.config_from_args(parser.parse_args(
        extra + ["--divergence-window", "7", "--divergence-nsigma", "3.5"]),
        finite_t)
    assert (cfg.divergence_window, cfg.divergence_nsigma) == (7, 3.5)
