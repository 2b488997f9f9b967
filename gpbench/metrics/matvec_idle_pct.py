"""The share of the traced window in which the device idled while the host
was in the matvec wrapper (``gp.kernels.matvec``: ``gram_matvec``'s
centring, encoding, the K2/K3 wrappers' host work and the launch): 100 x
the idle seconds charged to the span (``spans``) over the window. None
where the trace holds no such span or none of the port's library
kernels."""

from gpbench import spans


def read(r):
    return spans.share(r, "idle_s", ["gp.kernels.matvec"])
