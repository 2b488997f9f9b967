"""The share of the traced window in which the device idled while the host
was in the CG loop and no deeper span was open (``gp.solvers.cg`` and
``gp.solvers.cg_iteration``: the loop's own host work and its stop test's
sync): 100 x the idle seconds charged to them (``spans``) over the window.
None where the trace holds neither span or none of the port's library
kernels."""

from gpbench import spans


def read(r):
    return spans.share(r, "idle_s", ["gp.solvers.cg", "gp.solvers.cg_iteration"])
