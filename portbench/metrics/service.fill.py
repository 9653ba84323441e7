"""service.fill: the launches' mean fill (occupied lanes over the launch
width, %) over the window, from the service's fill counters (the parts of
its `launchFillRatio`) read at the window's two edges."""

from portbench.harness.window import per_launch


def read(r):
    fill = per_launch(r.launches, r.open_i, r.close_i, "fill_sum", "fill_launches")
    return None if fill is None else 100.0 * fill
