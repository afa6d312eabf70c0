"""Kernel #5, the single-chain sampler: the one-segment case of #1's
kernel (csrc/metropolis.cu, entry ``ff_metropolis_free_fermion``), one
launch an iteration of the ground state at K = 1."""
import counts

SYMBOL = r"\bmetropolis_chains_kernel\b"


def work(c):
    return counts.metropolis_single_work(c["batch"], c["nup"], c["gs_depth"],
                                         c["sampler_steps"])
