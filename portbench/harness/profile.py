"""The device trace of whole launch periods, and what the benchmark takes
from it.

`ProfilerThread` runs `torch.profiler` on a thread of its own: the
profiler's state belongs to the thread that starts it, and the service
issues its launches from worker threads that change from launch to launch.
Only device activity is recorded (CUPTI sees every kernel of the process,
whichever thread launched it), and the raw records are read from
`kineto_results`: the parsed event list costs minutes for a launch's half
a million records.

The profiler runs in the pipeline as it serves (harness/drive.py): it is
started once the window has closed (that takes seconds) and read over the
period from the first verdict instant after it is up to a later one. The
card is idle at both instants: the launch before has left it and the next
is still being packed. So the period holds the launches fetched at its
end whole, with every gap between them.

`reduce` turns the records into a `Profile`: the device's busy seconds
(the union of every activity's interval), kernels by name, and the idle
time labelled by what the host was doing, from the benchmark's own host
spans.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

NOT_KERNELS = ("Memcpy", "Memset")


@dataclass
class Profile:
    """`launches` whole launches fetched in a period of `window_s` seconds
    between two verdict instants, `busy_s` device seconds with an activity
    running, `kernels` kernel launches (copies and sets not counted),
    `by_name` {name: [count, seconds]}, `counters` the program's
    kernel-wrapper counts over the same launches ({wrapper: {"widths":
    {cols: n}, "rows": {limbs: n}}}), `idle_by_label` idle device seconds
    by the host activity they fell in, `align` how the records sat in the
    period (seconds from its start to the first record and from the last
    record to its end, records left out as the launch before it, and
    seconds from the profiler's start to the period's)."""

    launches: int
    window_s: float
    busy_s: float
    kernels: int
    by_name: dict
    counters: dict
    idle_by_label: dict = field(default_factory=dict)
    align: dict = field(default_factory=dict)


class ProfilerThread:
    """Start and stop a device-only torch.profiler from one thread."""

    def __init__(self):
        self._ex = ThreadPoolExecutor(max_workers=1, thread_name_prefix="portbench-profiler")
        self._prof = None

    def start(self):
        """Start on the profiler's thread; returns the start's future (it
        takes seconds on the card, and the service goes on meanwhile)."""

        def go():
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.start()

        return self._ex.submit(go)

    def stop(self) -> list:
        """Stop; returns the device records as (name, start_ns, dur_ns)."""

        def go():
            from torch.autograd import DeviceType

            self._prof.stop()
            return [
                (e.name(), e.start_ns(), e.duration_ns())
                for e in self._prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA
            ]

        try:
            return self._ex.submit(go).result()
        finally:
            self._prof = None

    def close(self) -> None:
        self._ex.shutdown(wait=True)


def merge(intervals) -> list:
    """Sorted, non-overlapping union of (start, end) intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def label_at(t: float, spans) -> str:
    """What the host was doing at trace-clock time `t`: the innermost of the
    benchmark's host spans (label, start, end, depth) that holds it."""
    best = None
    for label, s, e, depth in spans:
        if s <= t < e and (best is None or depth > best[1]):
            best = (label, depth)
    return best[0] if best else "no engine call (service, event loop)"


def reduce(records, launches: int, window, counters: dict, spans=(), end_anchor=None,
           start_s=None) -> Profile:
    """A `Profile` of the period `window`, two verdict instants on the trace
    clock, from the device `records` (name, start ns, duration ns) of a
    profiler that ran from before the first instant to the second.

    `end_anchor` is the trace-clock time of the period's last launch's last
    op (its own CUDA event): the last record is aligned with it. Records
    that start before the period belong to the launch fetched at its first
    instant and are left out; each part of an idle gap in the period is
    labelled by the innermost of `spans` that holds it."""
    h0, h1 = window
    offset = 0.0
    if records and end_anchor is not None:
        offset = end_anchor - max(s + d for _n, s, d in records) / 1e9
    placed = [(n, s / 1e9 + offset, d / 1e9) for n, s, d in records]
    kept = [r for r in placed if r[1] >= h0] if end_anchor is not None else placed
    by_name: dict = {}
    kernels = 0
    for name, _s, dur in kept:
        entry = by_name.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += dur
        if not name.startswith(NOT_KERNELS):
            kernels += 1
    busy = merge((s, s + d) for _n, s, d in kept)
    busy_s = sum(e - s for s, e in busy)
    idle: dict = {}
    align = {"armed_s": start_s, "records_before_period": len(placed) - len(kept)}
    if busy and end_anchor is not None:
        align.update(lead_s=busy[0][0] - h0, tail_s=h1 - busy[-1][1])
        edges = [(h0, h0)] + busy + [(h1, h1)]
        spans = sorted((sp for sp in spans if sp[2] > h0 and sp[1] < h1), key=lambda x: x[1])
        for (_s0, e0), (s1, _e1) in zip(edges, edges[1:]):
            if s1 <= e0:
                continue
            # a long gap spans several host activities: each part of it
            # goes to the span it fell in
            cuts = sorted({x for sp in spans for x in sp[1:3] if e0 < x < s1} | {e0, s1})
            for a, b in zip(cuts, cuts[1:]):
                label = label_at(a, spans)
                idle[label] = idle.get(label, 0.0) + (b - a)
    return Profile(
        launches=launches, window_s=h1 - h0, busy_s=busy_s, kernels=kernels,
        by_name=by_name, counters=counters, idle_by_label=idle, align=align,
    )
