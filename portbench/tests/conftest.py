"""The benchmark's tests import its modules from ``portbench/`` and the
measured package from the root of the checkout."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent.parent)]

import torch  # noqa: E402

# Several test workers share the host: one thread each keeps them apart.
torch.set_num_threads(1)
