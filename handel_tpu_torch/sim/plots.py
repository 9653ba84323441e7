"""Result plotting over the monitor's CSV schema — a copy of
handel_tpu/sim/plots.py.

Reference: simul/plots/*.py (~12 matplotlib scripts — comparison_time.py,
reallike.py, sigchecked.py, lib.py …) reading the stats CSVs
(simul/plots/csv/*.csv) whose columns the monitor writes
(`sigen_wall_avg`, `net_sentBytes_avg`, `sigs_sigCheckedCt_avg`, run/nodes/
threshold extras).

One module replaces the script pile: each plot function takes CSV paths as
produced by `Stats.write_csv` (sim/monitor.py) and writes a PNG. CLI:
`python -m handel_tpu_torch.sim.plots <kind> out.png run1.csv [run2.csv ...]`.

The plots need `matplotlib`, imported inside each plot function: where it
is missing, a plot raises an ImportError naming it (`read_rows` and the
series need nothing but the standard library).
"""

from __future__ import annotations

import csv
import functools


def read_rows(path: str) -> list[dict[str, float]]:
    """CSV -> list of {column: float} rows (plots/lib.py read_csv)."""
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        return [
            {k: float(v) for k, v in row.items() if v not in (None, "")}
            for row in reader
        ]


def _series(rows, xcol, ycol):
    import math

    # NaN cells come from declared-but-unsampled stats keys (sim/monitor.py
    # schema stability): skip the point, keep the rest of the series
    pts = sorted(
        (r[xcol], r[ycol])
        for r in rows
        if xcol in r
        and ycol in r
        and not (math.isnan(r[xcol]) or math.isnan(r[ycol]))
    )
    return [p[0] for p in pts], [p[1] for p in pts]


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or an ImportError naming the
    package."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "the plots need the `matplotlib` package"
        ) from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _plot_xy(series, xlabel, ylabel, out, logx=False, logy=False):
    plt = _pyplot()

    fig, ax = plt.subplots(figsize=(7, 4.5))
    for label, xs, ys in series:
        ax.plot(xs, ys, marker="o", label=label)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    if logx:
        ax.set_xscale("log")
    if logy:
        ax.set_yscale("log")
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    return out


def plot_time_vs_nodes(csvs: dict[str, str], out: str):
    """Completion time vs committee size, one line per protocol/config
    (plots/comparison_time.py). csvs: label -> path."""
    series = []
    for label, path in csvs.items():
        xs, ys = _series(read_rows(path), "nodes", "sigen_wall_avg")
        series.append((label, xs, ys))
    return _plot_xy(series, "nodes", "aggregation time (s)", out, logx=True)


def plot_network_vs_nodes(csvs: dict[str, str], out: str):
    """Per-node bytes sent vs committee size (plots/comparison_net.py)."""
    series = []
    for label, path in csvs.items():
        xs, ys = _series(read_rows(path), "nodes", "net_sentBytes_avg")
        series.append((label, xs, [y / 1024.0 for y in ys]))
    return _plot_xy(series, "nodes", "KB sent / node", out, logx=True, logy=True)


def plot_sigs_checked(csvs: dict[str, str], out: str):
    """Signatures checked per node vs committee size (plots/sigchecked.py)."""
    series = []
    for label, path in csvs.items():
        xs, ys = _series(read_rows(path), "nodes", "sigs_sigCheckedCt_avg")
        series.append((label, xs, ys))
    return _plot_xy(series, "nodes", "signatures checked / node", out, logx=True)


def plot_failing(csvs: dict[str, str], out: str):
    """Completion time vs number of failing nodes (plots/reallike.py)."""
    series = []
    for label, path in csvs.items():
        xs, ys = _series(read_rows(path), "failing", "sigen_wall_avg")
        series.append((label, xs, ys))
    return _plot_xy(series, "failing nodes", "aggregation time (s)", out)


def plot_sweep(csvs: dict[str, str], out: str, *, xcol: str = "period_ms"):
    """Protocol-knob sweep: completion time (left axis) and signatures
    checked per node (right axis) vs the swept parameter (`period_ms` |
    `timeout_ms` | `update_count`, columns the platforms embed per run) —
    the periodInc/timeoutInc/updateCount figures of
    simul/confgenerator/confgenerator.go. Twin axes because the two
    metrics live on different scales (~1 s vs ~60 sigs)."""
    import sys

    plt = _pyplot()

    fig, ax_t = plt.subplots(figsize=(7, 4.5))
    ax_s = ax_t.twinx()
    plotted = False
    for label, path in csvs.items():
        rows = read_rows(path)
        xs, ys = _series(rows, xcol, "sigen_wall_avg")
        if not xs:
            # pre-knob-column captures would silently vanish from a
            # comparison figure otherwise
            print(
                f"plot_sweep: '{label}' has no '{xcol}' column, skipped",
                file=sys.stderr,
            )
            continue
        ax_t.plot(xs, ys, marker="o", label=f"{label}: time (s)")
        xs, ys = _series(rows, xcol, "sigs_sigCheckedCt_avg")
        ax_s.plot(
            xs, ys, marker="s", linestyle="--", label=f"{label}: sigs checked"
        )
        plotted = True
    if not plotted:
        raise ValueError(f"no '{xcol}' sweep columns in the given CSVs")
    ax_t.set_xlabel(xcol)
    ax_t.set_ylabel("aggregation time (s)")
    ax_s.set_ylabel("signatures checked / node")
    ax_t.grid(True, alpha=0.3)
    h1, l1 = ax_t.get_legend_handles_labels()
    h2, l2 = ax_s.get_legend_handles_labels()
    ax_t.legend(h1 + h2, l1 + l2, fontsize=8)
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    return out


def plot_batch_plane(csvs: dict[str, str], out: str):
    """Batch-plane telemetry vs committee size: shared-launch occupancy,
    device wall time per launch, and host G2 subgroup-check time — the
    columns sim/node.py's `device` CounterIO records. Attributes where a
    large-N run's time goes (host unmarshal vs device launches)."""
    series = []
    for label, path in csvs.items():
        rows = read_rows(path)
        for col, tag in (
            ("device_verifier_verifierOccupancy_avg", "occupancy"),
            ("device_launch_launchTimeMs_avg", "launch ms"),
            ("device_subgroup_g2SubgroupCheckTimeMs_avg", "subgroup ms"),
        ):
            xs, ys = _series(rows, "nodes", col)
            if xs:
                series.append((f"{label}: {tag}", xs, ys))
    if not series:
        raise ValueError("no batch-plane columns in the given CSVs")
    return _plot_xy(series, "nodes", "batch plane (ratio / ms)", out, logx=True)


def plot_trace_timeline(wave: dict[int, tuple[float, float, float]], out: str):
    """The aggregation wave from a traced run (sim/trace_cli.py
    level_timeline): per level, the first -> last completion window across
    nodes with the median marked — the per-run, per-level form of the
    paper's logarithmic completion-time claim."""
    plt = _pyplot()

    if not wave:
        raise ValueError("no level_complete events in the trace")
    fig, ax = plt.subplots(figsize=(7, 4.5))
    levels = sorted(wave)
    for lvl in levels:
        first, med, last = wave[lvl]
        ax.plot([first, last], [lvl, lvl], lw=4, alpha=0.4, color="C0")
        ax.plot([med], [lvl], marker="o", color="C0")
    ax.set_xlabel("time since first event (s)")
    ax.set_ylabel("level completed")
    ax.set_yticks(levels)
    ax.grid(True, alpha=0.3)
    ax.set_title("aggregation wave: first-median-last completion per level")
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    return out


KINDS = {
    "time": plot_time_vs_nodes,
    "network": plot_network_vs_nodes,
    "sigchecked": plot_sigs_checked,
    "failing": plot_failing,
    "batchplane": plot_batch_plane,
    "period": functools.partial(plot_sweep, xcol="period_ms"),
    "timeout": functools.partial(plot_sweep, xcol="timeout_ms"),
    "updatecount": functools.partial(plot_sweep, xcol="update_count"),
}


def main(argv) -> int:
    if len(argv) < 3 or argv[0] not in KINDS:
        print(
            "usage: python -m handel_tpu_torch.sim.plots "
            f"{{{'|'.join(KINDS)}}} out.png run1.csv [run2.csv ...]"
        )
        return 2
    kind, out, *paths = argv
    csvs: dict[str, str] = {}
    for p in paths:
        label = p.rsplit("/", 1)[-1].removesuffix(".csv")
        if label in csvs:  # basename collision: fall back to the full path
            label = p
        csvs[label] = p
    KINDS[kind](csvs, out)
    print(out)
    return 0


if __name__ == "__main__":
    import sys

    raise SystemExit(main(sys.argv[1:]))
