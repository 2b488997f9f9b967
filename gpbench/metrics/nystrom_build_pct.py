"""The share of the traced window in which the device ran work launched
inside the Nyström preconditioner's build (``gp.solvers.nystrom_build``:
K_mm, its Cholesky, K_nm, the triangular solve, G and its Cholesky): 100 x
the device seconds charged to the span (``spans``) over the window. None
where the trace holds no such span or none of the port's library
kernels."""

from gpbench import spans


def read(r):
    return spans.share(r, "device_s", ["gp.solvers.nystrom_build"])
