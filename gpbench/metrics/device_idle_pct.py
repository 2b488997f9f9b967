"""The share of the traced window in which no operation ran on the device:
100 (1 - union of the device's busy intervals / window). None where the
profile holds none of the port's library kernels: such a session missed
the device's main work, and its idle share would read high."""


def read(r):
    t = r.trace
    if t is None or t.library_launches == 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
