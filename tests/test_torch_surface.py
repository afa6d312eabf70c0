"""The rest of the JAX package's public surface in the port, against the
JAX functions: ``utils.PhaseTimer`` and the orbital set's
``HO2D.eval_all`` and ``HO2D.fermion_states_random``."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fermiflow_tpu.physics import HO2D as JHO2D
from fermiflow_tpu.utils import PhaseTimer as JPhaseTimer

from fermiflow_tpu_torch.physics import HO2D
from fermiflow_tpu_torch.utils import PhaseTimer


@pytest.mark.parametrize("num_shells", [8, 12])
def test_eval_all_matches_jax(num_shells):
    x = np.random.default_rng(num_shells).normal(size=(5, 4, 2))
    got = HO2D(num_shells).eval_all(torch.as_tensor(x))
    want = np.asarray(JHO2D(num_shells).eval_all(jnp.asarray(x)))
    assert got.shape == (5, 4, num_shells * (num_shells + 1) // 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("n,seed", [(5, 0), (3, 1), (10, None)])
def test_fermion_states_random_matches_jax(n, seed):
    idx, Es = HO2D().fermion_states_random(n, seed=seed)
    assert len(set(idx.tolist())) == n and idx.dtype == np.int32
    np.testing.assert_array_equal(Es, HO2D().Es[idx].astype(np.float64))
    if seed is not None:
        jidx, jEs = JHO2D().fermion_states_random(n, seed=seed)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(Es, jEs)


def test_phase_timer_matches_jax_summary():
    """Both timers over the same phases: the same names, counts and summary
    keys; each phase's time covers its body."""
    timers = (PhaseTimer(), JPhaseTimer())
    for timer, sync in zip(timers, (torch.ones(3), jnp.ones(3))):
        for _ in range(2):
            with timer.phase("sample", sync_on={"x": sync}):
                time.sleep(0.01)
        with timer.phase("update"):
            pass
    ours, theirs = (t.summary() for t in timers)
    assert ours.keys() == theirs.keys() == {"sample", "update"}
    for name in ours:
        assert ours[name].keys() == theirs[name].keys()
        assert ours[name]["count"] == theirs[name]["count"]
    assert ours["sample"]["total_s"] >= 0.02
    assert ours["sample"]["mean_ms"] >= 10.0
