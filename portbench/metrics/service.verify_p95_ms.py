"""service.verify_p95_ms: 95th percentile, over the window's requests, of
the time from the `verify` call to its verdicts, on the benchmark's own
clock (each request is one node's batch of candidates)."""

from portbench.harness.window import percentile


def read(r):
    return percentile(r.latencies_ms, 95)
