"""Kernel #3, the Hessian flow (csrc/hessian_flow.cu), one launch an
iteration: dopri5, 6 stages a step."""
import counts

SYMBOL = r"\bhessian_flow_kernel\b"


def work(c):
    return counts.hflow_work(c["batch"], c["nup"], c["d_eta"], c["d_mu"],
                             c["ode_steps"], 6)
