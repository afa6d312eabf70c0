"""Kernel #4b, the block-order sum of the adjoint's partials
(csrc/reinforce.cu), one launch an iteration."""
import counts

SYMBOL = r"\breinforce_reduce_kernel\b"


def work(c):
    return counts.reduce_work(c["batch"] // 16, 3 * (c["d_eta"] + c["d_mu"]))
