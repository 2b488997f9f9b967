"""The share of the traced window in which the device ran work launched
inside the Nyström preconditioner's apply (``gp.solvers.nystrom_apply``:
the Woodbury solve, once a CG iteration): 100 x the device seconds charged
to the span (``spans``) over the window. None where the trace holds no such
span or none of the port's library kernels."""

from gpbench import spans


def read(r):
    return spans.share(r, "device_s", ["gp.solvers.nystrom_apply"])
