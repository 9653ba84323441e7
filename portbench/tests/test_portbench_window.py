"""The whole-launch window: the rate is exact wherever the clock's edges
fall, and a stall inside the window lowers it."""

from __future__ import annotations

import pytest

from portbench.harness import profile
from portbench.harness.window import Launch, close_index, per_launch, percentile, rate


def steady(period: float, k: int, count: int, t0: float = 0.0, stall_at=None, stall=0.0):
    out, t = [], t0
    for i in range(count):
        t += period + (stall if i == stall_at else 0.0)
        out.append(Launch(t, k, {"ms": 10.0 * (i + 1), "n": float(i + 1)}))
    return out


@pytest.mark.parametrize("seconds", [25.0, 36.0, 36.5, 47.9, 48.0, 51.0])
@pytest.mark.parametrize("phase", [0.0, 0.375, 5.5, 11.75])
def test_rate_is_exact_wherever_the_edges_fall(seconds, phase):
    period, k = 12.0, 4096
    launches = steady(period, k, 12, t0=phase)
    i1 = close_index(launches, 0, seconds)
    assert launches[i1].t - launches[0].t <= seconds
    assert rate(launches, 0, i1) == pytest.approx(k / period, rel=1e-12)


def test_a_window_shorter_than_a_launch_takes_the_next_one():
    launches = steady(12.0, 16, 3)
    assert close_index(launches, 0, 1.0) == 1
    assert close_index(launches[:1], 0, 1.0) is None


def test_a_stall_inside_the_window_lowers_the_rate():
    period, k = 12.0, 4096
    base = steady(period, k, 8)
    stalled = steady(period, k, 8, stall_at=2, stall=3.0)
    r0 = rate(base, 0, close_index(base, 0, 51.0))
    i1 = close_index(stalled, 0, 51.0)
    r1 = rate(stalled, 0, i1)
    assert r1 < r0
    # all the work and all the time of the window, stall included
    assert r1 == pytest.approx(k * i1 / (period * i1 + 3.0))


def test_counters_are_read_as_differences_at_the_edges():
    launches = steady(12.0, 16, 6)
    assert per_launch(launches, 1, 4, "ms", "n") == pytest.approx(10.0)
    assert per_launch(launches, 1, 4, "absent", "n") is None


def test_percentile_is_nearest_rank():
    vals = list(range(1, 101))
    assert percentile(vals, 95) == 95
    assert percentile([7.0], 95) == 7.0
    assert percentile([], 95) is None


def test_a_profiled_period_counts_every_gap_and_labels_it_from_the_end():
    """Records on the device's clock (ns), a period between two verdict
    instants on the host's (s): once the last record is aligned with the
    last launch's own end, the records before the period (the launch
    fetched at its start) are left out, busy is the union of the rest,
    idle the rest of the period, and each gap takes the host span it fell
    in."""
    base = 7_000_000_000  # the device clock's origin is not the host's
    records = [
        ("k0", base - 2_000_000_000, 1_500_000_000),  # -2.0 - -0.5 s: before
        ("k1", base + 1_000_000_000, 2_000_000_000),  # 1.0 - 3.0 s
        ("k2", base + 2_500_000_000, 1_000_000_000),  # overlaps: to 3.5 s
        ("Memcpy DtoH", base + 4_000_000_000, 500_000_000),  # 4.0 - 4.5 s
    ]
    host0 = 100.0  # device s + 100 = host s
    spans = [("pack", host0 + 0.2, host0 + 1.0, 2), ("stage b", host0 + 3.4, host0 + 4.0, 2)]
    p = profile.reduce(records, 1, (host0 + 0.0, host0 + 5.0), {}, spans=spans,
                       end_anchor=host0 + 4.5)
    assert p.window_s == pytest.approx(5.0)
    assert p.busy_s == pytest.approx(3.0)
    assert p.kernels == 2 and p.launches == 1 and "k0" not in p.by_name
    # the first gap (0 - 1.0 s) is split: 0.2 s before the pack, 0.8 in it
    assert p.idle_by_label["pack"] == pytest.approx(0.8)
    assert p.idle_by_label["stage b"] == pytest.approx(0.5)
    assert p.idle_by_label["no engine call (service, event loop)"] == pytest.approx(0.7)
    assert p.align["lead_s"] == pytest.approx(1.0) and p.align["tail_s"] == pytest.approx(0.5)
    assert p.align["records_before_period"] == 1
