"""device.idle: the share of the profiled period, from one verdict instant
of the running pipeline to a later one, in which no operation ran on the
card, %: the pack and the service's intake between launches included."""


def read(r):
    p = r.profile
    if p is None or not p.window_s or not p.busy_s:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
