"""Single experiment configuration dataclass (port of ``fermiflow_tpu/config.py``).

Same fields and JSON as the JAX package, so one file drives both, and the
same defaults but for the three ``pallas_*`` switches, which here select the
port's CUDA kernels and default to on (the JAX CLI sets them from its
backend).  Added: ``device`` (where entry points run; not written by
``to_json`` so the file it writes loads in both packages) and
``torch_dtype()``.
"""

from __future__ import annotations

import dataclasses
import json

import torch


@dataclasses.dataclass
class Config:
    # physics / model
    nup: int = 6
    ndown: int = 0
    Z: float = 0.5  # Coulomb coupling strength
    beta: float = 2.0  # inverse temperature (finite-T only)
    deltaE: float = 2.0  # excitation-energy cutoff (finite-T only)
    boltzmann: bool = False  # Boltzmann init of state logits (finite-T only)

    # flow network
    d_eta: int = 50  # hidden size of the two-body MLP (reference --Deta)
    d_mu: int | None = 50  # hidden size of the one-body MLP; None = --nomu
    t0: float = 0.0
    t1: float = 1.0

    # ODE solver (fixed dopri5 grid; see the JAX config for the error study)
    ode_steps: int = 4
    ode_method: str = "dopri5"
    ode_solver: str = "fixed"  # fixed | adaptive | adjoint, for CNF.generate
    rtol: float = 1e-6  # adaptive-solver tolerances
    atol: float = 1e-8

    # sampler
    batch: int = 8000
    equilibrium_steps: int = 100  # reference-compat re-equilibration length
    mcmc_steps: int = 30  # steps per iteration with persistent walkers
    tau: float = 0.1
    persistent_walkers: bool = False  # carry chains + per-walker tau adaptation
    tau_target_accept: float = 0.5
    tau_gain: float = 0.1
    pallas_sampler: bool = True  # the sampler kernels (#1, #5, #7); off: plain
    pallas_interpret: bool = False  # JAX-only switch, kept for JSON parity

    # optimization
    lr: float = 1e-2
    iternum: int = 1000
    steps_per_call: int = 1  # iterations per fused sampler launch

    # numerics / runtime
    local_energy: str = "auto"  # auto | hessian_flow | nested_jvp
    pallas_local_energy: bool = True  # VGH and Hessian-flow kernels; off: plain
    pallas_reinforce: bool = True  # the adjoint kernel; off: autograd
    max_restarts: int = 0
    divergence_window: int = 50
    divergence_nsigma: float = 10.0
    laplacian_chunk: int | None = None
    dtype: str = "float64"  # float64 | float32 (bf16 rejected, see torch_dtype)
    seed: int = 42
    checkpoint_every: int = 100
    checkpoint_dir: str | None = None
    metrics_path: str | None = None

    # port only: where entry points run ("cuda" unless told otherwise)
    device: str = "cuda"

    def torch_dtype(self) -> torch.dtype:
        if self.dtype == "bfloat16":
            raise ValueError(
                "dtype='bfloat16' is not supported: the unrolled-GE "
                "determinant and the 2nd/3rd-order derivative chains lose "
                "all signal below float32. Use float32 on the GPU or "
                "float64 on the CPU."
            )
        return {"float64": torch.float64, "float32": torch.float32}[self.dtype]

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d.pop("device")
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls(**json.loads(s))
