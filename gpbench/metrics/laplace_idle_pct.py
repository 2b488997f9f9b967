"""The share of the traced window in which the device idled while the host
was in the Laplace fit or prediction and no deeper span outside it was
open (any ``gp.laplace.*`` span: the fit's and each Newton step's own host
work with the step's error read, the W roots, the preconditioner build,
the prediction): 100 x the idle seconds charged to them (``spans``) over
the window. None where the trace holds none of them or none of the port's
library kernels."""

from gpbench import spans

PREFIX = "gp.laplace."


def read(r):
    c = spans.of(r)
    if c is None:
        return None
    return spans.share(r, "idle_s", [n for n in {**c.counts, **c.idle_s} if n.startswith(PREFIX)])
