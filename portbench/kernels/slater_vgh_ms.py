"""Kernel #6, the mixed-state Slater value, gradient and Hessian
(csrc/slater_vgh_ms.cu), one launch an iteration at finite T."""
import counts

SYMBOL = r"\bslater_vgh_ms_kernel\b"


def work(c):
    return counts.vgh_ms_work(c["batch"], c["nup"], c["ms_depth"])
