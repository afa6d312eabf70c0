"""Ground-state VMC training driver (port of ``fermiflow_tpu/cli/ground_state.py``).

    python -m fermiflow_tpu_torch.cli.ground_state --nup 6 --Z 0.5 \
        --batch 8192 --dtype float32 --persistent --steps-per-call 10

Runs on ``cuda`` (the hand-written kernels) unless ``--device cpu`` asks for
the plain PyTorch versions.
"""

from __future__ import annotations

import argparse

from fermiflow_tpu_torch.cli import common
from fermiflow_tpu_torch.train import (
    init_gs_state,
    make_gs_fused_multi_step,
    make_gs_train_step,
    make_multi_step,
)
from fermiflow_tpu_torch.utils import MetricsLogger


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Ground-state variational Monte Carlo (PyTorch/CUDA)"
    )
    common.add_flags(parser)
    args = parser.parse_args(argv)
    cfg = common.config_from_args(args)

    model, params = common.build_gs(cfg)
    state = init_gs_state(model, params, cfg, params["eta"]["w1"].device)
    logger = MetricsLogger(cfg.metrics_path)

    print(f"nup = {cfg.nup}, ndown = {cfg.ndown}, Z = {cfg.Z:.1f}")
    print(f"batch = {cfg.batch}, iternum = {cfg.iternum}.")

    def print_row(rec):
        print(
            f"iter: {rec['step']:03d} E: {rec['E']} E_std: {rec['E_std']} "
            f"accept: {rec['accept_rate']:.3f} "
            f"Instant speed (hours per 100 iters): "
            f"{rec.get('hours_per_100_iters', float('nan'))}"
        )

    # With K > 1 every chunk is the fused multi-step (one multi-segment
    # sampler launch per chunk); with K = 1 each iteration is one
    # single-chain sampler launch, as the JAX driver's per-iteration step.
    if cfg.steps_per_call > 1:
        make_chunk = lambda chunk: make_gs_fused_multi_step(model, cfg, chunk)
    else:
        make_chunk = lambda chunk: make_multi_step(
            make_gs_train_step(model, cfg), chunk)
    try:
        state = common.run_training_loop(state, cfg, make_chunk, logger,
                                         print_row, args.profile_dir)
    finally:
        logger.close()
    return state


if __name__ == "__main__":
    main()
