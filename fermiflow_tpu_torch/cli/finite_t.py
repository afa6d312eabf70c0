"""Finite-temperature VMC training driver (port of ``fermiflow_tpu/cli/finite_t.py``).

    python -m fermiflow_tpu_torch.cli.finite_t --beta 2.0 --nup 6 --Z 0.5 \
        --deltaE 2.0 --boltzmann --batch 8192 --dtype float32 --persistent \
        --steps-per-call 10

Runs on ``cuda`` (the hand-written kernels) unless ``--device cpu`` asks for
the plain PyTorch versions.  Each iteration is one mixed-state sampler
launch and one kernel-chain update; ``--steps-per-call K`` fetches the
metrics once per K iterations.
"""

from __future__ import annotations

import argparse

from fermiflow_tpu_torch.cli import common
from fermiflow_tpu_torch.train import (
    init_beta_state,
    make_beta_train_step,
    make_multi_step,
)
from fermiflow_tpu_torch.utils import MetricsLogger


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Finite-temperature variational Monte Carlo (PyTorch/CUDA)"
    )
    common.add_flags(parser, finite_t=True)
    args = parser.parse_args(argv)
    cfg = common.config_from_args(args, finite_t=True)

    model, params = common.build_beta(cfg)
    state = init_beta_state(model, params, cfg,
                            params["log_state_weights"].device)
    logger = MetricsLogger(cfg.metrics_path)

    print(f"beta = {cfg.beta:.1f}, nup = {cfg.nup}, ndown = {cfg.ndown}, "
          f"Z = {cfg.Z:.1f}")
    print(f"deltaE = {cfg.deltaE:.1f}, total number of states = {model.Nstates}")
    print("State probabilities initialized with "
          + ("Boltzmann distribution." if cfg.boltzmann else "random Gaussian."))
    print(f"batch = {cfg.batch}, iternum = {cfg.iternum}.")

    def print_row(rec):
        print(
            f"iter: {rec['step']:03d} F: {rec['F']} F_std: {rec['F_std']} "
            f"E: {rec['E']} E_std: {rec['E_std']} "
            f"S: {rec['S']} S_analytical: {rec['S_analytical']} "
            f"accept: {rec['accept_rate']:.3f} "
            f"Instant speed (hours per 100 iters): "
            f"{rec.get('hours_per_100_iters', float('nan'))}"
        )

    try:
        state = common.run_training_loop(
            state, cfg,
            lambda chunk: make_multi_step(make_beta_train_step(model, cfg),
                                          chunk),
            logger, print_row, args.profile_dir,
        )
    finally:
        logger.close()
    return state


if __name__ == "__main__":
    main()
