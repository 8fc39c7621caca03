"""PCG iterations per request: the `niter` of the port's PcgResult, summed
over the window's requests by the harness."""


def read(r):
    its = (r.counters or {}).get("pcg_iters")
    return None if its is None or r.units == 0 else its / r.units
