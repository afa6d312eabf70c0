"""PyTorch/CUDA port of ``fermiflow_tpu`` (its single-process surface).

The JAX package ``fermiflow_tpu`` stays the reference; this package keeps its
module layout and public function names so each counterpart is easy to find.
Plain tensor code is PyTorch; the Pallas kernels of the JAX package are
hand-written CUDA C++ for Hopper (``csrc/``), built with ``nvcc`` at first
use and bound through ``ctypes`` (``ops/_build.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU and no explicit ``cpu`` they raise instead of falling back.
"""

from __future__ import annotations

import torch

# The JAX code pins Precision.HIGHEST at every contraction feeding the
# Laplacian (nn/mlp.py, vmc/hessian_flow.py); TF32 keeps ~3 decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises rather than dropping quietly to the CPU when CUDA is missing.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --device cpu) "
            "to run the plain PyTorch path on the CPU"
        )
    return dev
