"""K(x, x) V products a step or a query: the port's launch counts of the
full sweep (K2) and the symmetric sweep (K3), which count one a call,
over the units the window completed. Solver layer: CG iterations plus the
training step's matvec on [alpha | probes]."""


def read(r):
    if not r.units:
        return None
    return (r.launches.get("gram_matvec_sym", 0) + r.launches.get("gram_matvec_full", 0)) / r.units
