"""NDFT kernel launches per request: the port's launch counters
(ops/packed_ndft.py), summed over its wrappers and shapes, over the window."""


def read(r):
    total = sum(sum(shapes.values()) for shapes in r.launches.values())
    return None if r.units == 0 or total == 0 else total / r.units
