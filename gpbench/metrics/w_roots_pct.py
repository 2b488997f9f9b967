"""The share of the traced window in which the device ran work launched
inside the per-point square roots of W (``gp.laplace.w_roots``: the W
blocks and their batched eigh, once a Newton step): 100 x the device
seconds charged to the span (``spans``) over the window. None where the
trace holds no such span or none of the port's library kernels."""

from gpbench import spans


def read(r):
    return spans.share(r, "device_s", ["gp.laplace.w_roots"])
