"""Kernel #1, the multi-segment sampler (csrc/metropolis.cu, entry
``ff_metropolis_chains``): one launch a chunk of the ground state at K > 1."""
import counts

SYMBOL = r"\bmetropolis_chains_kernel\b"


def work(c):
    return counts.metropolis_work(c["batch"], c["nup"], c["gs_depth"],
                                  c["sampler_steps"], c["steps_per_call"])
