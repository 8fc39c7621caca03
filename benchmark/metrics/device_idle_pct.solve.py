"""The device's idle share of the profiled stretch: 100 (1 - busy / wall),
busy the union of the intervals of every device operation."""


def read(r):
    if r.stretch is None or r.stretch.wall_s <= 0.0:
        return None
    return 100.0 * (1.0 - r.stretch.busy_s / r.stretch.wall_s)
