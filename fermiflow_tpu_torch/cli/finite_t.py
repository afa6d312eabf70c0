"""Finite-temperature VMC training driver (port of ``fermiflow_tpu/cli/finite_t.py``).

    python -m fermiflow_tpu_torch.cli.finite_t --beta 2.0 --nup 6 --Z 0.5 \
        --deltaE 2.0 --boltzmann --batch 8192 --dtype float32 --persistent \
        --steps-per-call 10

Runs on ``cuda`` (the hand-written kernels) unless ``--device cpu`` asks for
the plain PyTorch versions.  Each iteration is one mixed-state sampler
launch and one kernel-chain update; ``--steps-per-call K`` fetches the
metrics once per K iterations.  ``--checkpoint-dir`` saves and resumes,
and ``--coordinator``, ``--num-processes`` and ``--process-id`` run it
data parallel, as the ground-state driver does.
"""

from __future__ import annotations

import argparse

import torch

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
    with common.distributed(args) as primary:
        return _run(args, cfg, primary)


def _run(args, cfg, primary: bool):
    mesh = common.walker_mesh(args, cfg)
    model, params = common.build_beta(cfg)
    state = init_beta_state(model, params, cfg,
                            params["log_state_weights"].device, mesh)
    state, start_step = common.restore(state, cfg, primary)
    logger = MetricsLogger(cfg.metrics_path if primary else None)

    if primary:
        print(f"beta = {cfg.beta:.1f}, nup = {cfg.nup}, ndown = {cfg.ndown}, "
              f"Z = {cfg.Z:.1f}")
        print(f"deltaE = {cfg.deltaE:.1f}, total number of states = "
              f"{model.Nstates}")
        print("State probabilities initialized with "
              + ("Boltzmann distribution." if cfg.boltzmann
                 else "random Gaussian."))
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

    # One captured CUDA graph a chunk where the path allows (train.py), but
    # under --debug-nans.
    graph = False if args.debug_nans else None
    try:
        state = common.run_training_loop(
            state, cfg,
            lambda chunk: make_multi_step(
                make_beta_train_step(model, cfg, mesh, graph=graph), chunk),
            logger, print_row, args.profile_dir, start_step, args.debug_nans,
            primary, mesh,
        )
    finally:
        logger.close()
    if args.movie and primary:
        common.dump_density_movie(
            args.movie, model, state.params["flow"],
            torch.Generator(state.walkers_cm.device).manual_seed(
                common.derived_seed(state.generator, 999)),
            args.movie_frames, args.movie_walkers, cfg,
            state_logits=state.log_state_weights)
    return state


if __name__ == "__main__":
    main()
