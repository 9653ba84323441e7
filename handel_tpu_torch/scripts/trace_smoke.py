"""Observability gate: a 16-node traced LocalCluster — counterpart of
scripts/trace_smoke.py.

Runs a traced in-process cluster of the port (fake crypto, seconds on any
machine) and asserts the reference smoke's checks: the trace export is
non-empty with every pipeline stage present, the contribution chains
attributable, the flow links resolvable, and the critical-path walk from
the first `threshold_reached` instant one causal chain covering at least
90% of the time to threshold, across at least one network hop, with
bounded clock offsets. Then runs the trace CLI's analysis and writes
`trace_report.json`. Nothing here touches the card.

    python -m handel_tpu_torch.scripts.trace_smoke [--artifact-dir DIR] [--nodes N]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import tempfile

from handel_tpu_torch.core.test_harness import run_cluster
from handel_tpu_torch.core.trace import FlightRecorder, merge_traces
from handel_tpu_torch.sim import trace_cli


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--artifact-dir", default="",
        help="keep the trace dump + trace_report.json here",
    )
    ap.add_argument("--nodes", type=int, default=16)
    args = ap.parse_args(argv)

    rec = FlightRecorder(capacity=1 << 17)
    finals = asyncio.run(run_cluster(args.nodes, recorder=rec))
    assert len(finals) == args.nodes, (
        f"only {len(finals)}/{args.nodes} nodes reached threshold"
    )

    events = rec.export()["traceEvents"]
    assert events, "trace export is empty"
    names = {e["name"] for e in events}
    missing = {"recv", "queue", "verify", "merge", "send",
               "level_complete", "threshold_reached"} - names
    assert not missing, f"missing pipeline spans: {missing}"

    with tempfile.TemporaryDirectory() as tmp:
        d = args.artifact_dir or tmp
        os.makedirs(d, exist_ok=True)
        rec.dump(os.path.join(d, "trace_0.json"))
        exports = trace_cli.load_exports([d])
        loaded = merge_traces(exports)["traceEvents"]

        chains = trace_cli.contribution_chains(loaded)
        assert chains, "no contribution chains reconstructed"
        best = max(c["coverage"] for c in chains.values())
        assert best >= 0.95, f"best chain coverage {best:.1%} < 95%"

        # one causal chain over >= 90% of the time to threshold
        cp = trace_cli.critical_path(loaded)
        assert cp is not None, "no threshold_reached anchor in trace"
        assert cp["chain"], "critical path is empty"
        assert cp["wall_ms"] > 0, "zero wall time-to-threshold"
        assert cp["coverage"] >= 0.90, (
            f"critical path covers {cp['coverage']:.1%} of "
            f"time-to-threshold < 90%"
        )
        assert cp["hops"] >= 1, "critical path crossed no network hop"

        frac, linked, total = trace_cli.flow_linkage(loaded)
        assert total > 0, "no trace-context-bearing recvs"
        assert frac >= 0.95, f"flow linkage {frac:.1%} ({linked}/{total})"

        # each export carries its clock offset: in one process about zero,
        # and a broken estimate trips this bound
        offsets = [float(ex.get("clockOffset", 0.0) or 0.0) for ex in exports]
        assert all(abs(o) < 1.0 for o in offsets), (
            f"unbounded clock offsets: {offsets}"
        )

        report_path = os.path.join(d, "trace_report.json")
        trace_cli.main([d, "--top", "5", "--critical-path", "--report", report_path])
        with open(report_path) as f:
            report = json.load(f)
        assert report["backend"] == "trace"
        assert report["critical_path_coverage"] >= 0.90

    print(
        f"\ntrace smoke OK: {len(events)} events, {len(chains)} chains, "
        f"best coverage {best:.1%}; critical path {cp['wall_ms']:.1f} ms "
        f"over {cp['hops']} hops at {cp['coverage']:.1%} coverage, "
        f"flow linkage {frac:.1%}"
        + (f"; artifacts -> {args.artifact_dir}" if args.artifact_dir else "")
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
