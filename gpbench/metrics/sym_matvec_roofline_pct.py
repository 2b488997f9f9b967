"""The window's K(x, x) V products against their roofline: their least time
on the card (``roofline.sym_matvec_work`` for the product's shape, times
the products the launch counts give) over the device time of the kernels
that computed them (``trace.FORWARD_SWEEP``). None where the profile holds
none of those kernels."""

from gpbench import roofline, trace


def read(r):
    t = r.trace
    if t is None:
        return None
    device_s = sum(t.kernel_seconds.get(k, 0.0) for k in trace.FORWARD_SWEEP)
    count = r.launches.get("gram_matvec_sym", 0) + r.launches.get("gram_matvec_full", 0)
    if device_s <= 0 or count == 0:
        return None
    least = count * roofline.least_seconds(roofline.sym_matvec_work(**r.products))
    return 100.0 * least / device_s
