"""kernels.b1_roofline: kernel B1's share of its roofline over the whole
launches of the profiled period, %: the sum over its calls of each call's
least time (portbench/harness/bounds.py, applied to the columns and limbs
its wrapper counted) over its device time in the trace. The work is the
Montgomery products asked of the wrapper `mont_mul`, whatever kernel
computes them; its kernel is `mont_mul_kernel` in the trace."""

from portbench.harness.bounds import mont_mul_bound_ms

KERNEL = "mont_mul_kernel"


def read(r):
    p = r.profile
    if p is None or "mont_mul" not in p.counters:
        return None
    seconds = sum(s for name, (_n, s) in p.by_name.items() if KERNEL in name)
    rows = p.counters["mont_mul"]["rows"]
    if not seconds or len(rows) != 1:
        return None
    (nlimbs,) = rows
    bound_ms = sum(n * mont_mul_bound_ms(nlimbs, cols)
                   for cols, n in p.counters["mont_mul"]["widths"].items())
    return 100.0 * bound_ms / (seconds * 1e3)
