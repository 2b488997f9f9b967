"""The share of the traced window in which the device ran work launched
inside a Newton step's preconditioner build (``gp.laplace.precond_build``:
the W-weighted Gram of the Nyström factor and its Cholesky): 100 x the
device seconds charged to the span (``spans``) over the window. None where
the trace holds no such span or none of the port's library kernels."""

from gpbench import spans


def read(r):
    return spans.share(r, "device_s", ["gp.laplace.precond_build"])
