"""setup_s: seconds from the process's start to the window's opening: keys
and pool, the kernel library, the engine's prepare (registry), the
requests, the service's warm-up launch at the cell's width (it builds the
prefix table) and the first launch of the full pipeline after it."""


def read(r):
    return r.setup_s
