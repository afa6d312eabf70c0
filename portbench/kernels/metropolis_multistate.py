"""Kernel #7, the mixed-state sampler (csrc/metropolis_ms.cu), one launch
an iteration at finite T."""
import counts

SYMBOL = r"\bmetropolis_ms_kernel\b"


def work(c):
    return counts.metropolis_ms_work(c["batch"], c["nup"], c["ms_depth"],
                                     c["sampler_steps"])
