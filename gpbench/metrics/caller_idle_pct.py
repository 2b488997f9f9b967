"""The share of the traced window in which the device idled while the host
was in the caller and no deeper span was open (``gp.posterior.query``, a
query's own work; ``gp.training.step``, a step's own work: the objective,
its backward, Adam): 100 x the idle seconds charged to them (``spans``)
over the window. None where the trace holds neither span or none of the
port's library kernels."""

from gpbench import spans


def read(r):
    return spans.share(r, "idle_s", ["gp.posterior.query", "gp.training.step"])
