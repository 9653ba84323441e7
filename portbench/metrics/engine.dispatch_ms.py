"""engine.dispatch_ms: the engine's host dispatch time a launch over the
window, staging and eager issue (its `hostDispatchMs` over
`hostDispatchLaunches`, differences at the edges)."""

from portbench.harness.window import per_launch


def read(r):
    return per_launch(r.launches, r.open_i, r.close_i, "hostDispatchMs", "hostDispatchLaunches")
