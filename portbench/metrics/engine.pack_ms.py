"""engine.pack_ms: the engine's host pack time a launch over the window
(its `hostPackMs` over `hostPackLaunches`, differences at the edges)."""

from portbench.harness.window import per_launch


def read(r):
    return per_launch(r.launches, r.open_i, r.close_i, "hostPackMs", "hostPackLaunches")
