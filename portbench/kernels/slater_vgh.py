"""Kernel #2, the Slater value, gradient and Hessian (csrc/slater_vgh.cu),
one launch an iteration of the ground state."""
import counts

SYMBOL = r"\bslater_vgh_kernel\b"


def work(c):
    return counts.vgh_work(c["batch"], c["nup"], c["gs_depth"])
