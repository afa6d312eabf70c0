"""Kernel #4, the REINFORCE adjoint pass (csrc/reinforce.cu), one launch an
iteration.  Its per-block partials have B / 16 rows (512 at B = 8192,
``ff_reinforce_blocks``); the bound is set by the operations, to which
they add nothing."""
import counts

SYMBOL = r"\breinforce_kernel\b"


def work(c):
    return counts.reinforce_work(c["batch"], c["nup"], c["d_eta"], c["d_mu"],
                                 c["ode_steps"], 6, c["batch"] // 16)
