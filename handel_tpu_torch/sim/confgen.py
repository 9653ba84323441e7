"""Experiment-matrix TOML generator — a copy of handel_tpu/sim/confgen.py.

Reference: simul/confgenerator/confgenerator.go:18-469 — programmatic
generation of the paper's scenario files (node-count sweeps 100->4000,
failing-node grids, threshold increments, update-period/timeout sweeps,
baseline nsquare/libp2p matrices), each emitted as a simulation TOML.

Each scenario function returns a SimConfig; `generate(outdir)` writes the
whole matrix. The device additions ride the same knobs: scheme selects the
device path ("bn254-jax", which the port's registry maps to its
`bn254-cuda` scheme, models/registry.py), `batch_size` the launch width,
`shared_verifier` the fused many-node device service.

The TOML text is the JAX package's, byte for byte, for every scenario, and
the port runs every one of them: the baselines through the sim (sim/node.py
builds the gossip aggregators), the swarm through `sim swarm`.
"""

from __future__ import annotations

import os

from handel_tpu_torch.sim.config import (
    AdversaryParams,
    HandelParams,
    RunConfig,
    ScenarioParams,
    SimConfig,
    SoakParams,
    SwarmParams,
    dump_config,
)

# the reference's standard sweep (confgenerator.go nodesCount scenarios)
NODE_SWEEP = [100, 300, 500, 1000, 2000, 4000]

# ceiling on generated worker processes: the uncapped n//500 rule was an
# AWS-fleet assumption — at swarm scale it emits configs asking one host
# for 131 Python processes (65536 nodes), which fork-bombs a laptop and
# adds nothing once processes exceed cores. Above this, use the swarm
# runtime (scenario_swarm) which multiplexes identities as vnodes instead.
MAX_PROCESSES = 16


def default_processes(n: int) -> int:
    """Process count for an n-node run: the reference's one-per-500 rule,
    capped at MAX_PROCESSES."""
    return min(max(1, n // 500), MAX_PROCESSES)


def _runs(nodes_list, threshold_of, failing_of=lambda n: 0, processes_of=None, **hp):
    if processes_of is None:
        processes_of = default_processes
    return [
        RunConfig(
            nodes=n,
            threshold=threshold_of(n),
            failing=failing_of(n),
            processes=processes_of(n),
            handel=HandelParams(**hp),
        )
        for n in nodes_list
    ]


def scenario_node_count(scheme: str = "bn254-jax") -> SimConfig:
    """Completion time vs committee size at 99% threshold (the headline
    curve, confgenerator.go nodeCount scenario)."""
    return SimConfig(
        network="udp",
        scheme=scheme,
        runs=_runs(NODE_SWEEP, lambda n: n * 99 // 100),
    )


def scenario_threshold_inc(nodes: int = 2000) -> SimConfig:
    """Threshold sweep 51/75/90/99% at fixed N (thresholdInc scenario)."""
    return SimConfig(
        network="udp",
        scheme="bn254-jax",
        runs=[
            RunConfig(nodes=nodes, threshold=nodes * pct // 100,
                      processes=default_processes(nodes))
            for pct in (51, 75, 90, 99)
        ],
    )


def scenario_failing(nodes: int = 4000) -> SimConfig:
    """Failing-node grid at fixed N: up to 49% dead, threshold 51%
    (confgenerator.go failing scenario / handel_4000_failing.csv)."""
    return SimConfig(
        network="udp",
        scheme="bn254-jax",
        runs=[
            RunConfig(
                nodes=nodes,
                threshold=nodes * 51 // 100,
                failing=f,
                processes=default_processes(nodes),
            )
            for f in (0, nodes // 10, nodes // 4, nodes * 49 // 100)
        ],
    )


def scenario_period(nodes: int = 2000) -> SimConfig:
    """Update-period sweep (periods scenario)."""
    return SimConfig(
        network="udp",
        scheme="bn254-jax",
        runs=[
            r
            for ms in (10.0, 20.0, 50.0, 100.0)
            for r in _runs([nodes], lambda n: n * 99 // 100, period_ms=ms)
        ],
    )


def scenario_timeout(nodes: int = 2000) -> SimConfig:
    """Level-timeout sweep (timeout scenario)."""
    return SimConfig(
        network="udp",
        scheme="bn254-jax",
        runs=[
            r
            for ms in (50.0, 100.0, 200.0, 500.0)
            for r in _runs([nodes], lambda n: n * 99 // 100, timeout_ms=ms)
        ],
    )


def scenario_update_count(nodes: int = 2000) -> SimConfig:
    """Per-tick update fanout sweep: how many peers each node refreshes per
    period (confgenerator.go:135-162 updateCountScenario, updates 1/10/20
    at N=2000)."""
    return SimConfig(
        network="udp",
        scheme="bn254-jax",
        runs=[
            r
            for uc in (1, 10, 20)
            for r in _runs([nodes], lambda n: n * 99 // 100, update_count=uc)
        ],
    )


def scenario_nsquare() -> SimConfig:
    """Full-diffusion gossip baseline matrix (nsquare scenario)."""
    return SimConfig(
        network="udp",
        scheme="bn254",
        baseline="nsquare",
        runs=_runs(NODE_SWEEP[:4], lambda n: n * 51 // 100),
    )


def scenario_gossipsub() -> SimConfig:
    """Gossipsub baseline matrix (libp2p scenario): per-topic meshes,
    GRAFT/PRUNE, IHAVE/IWANT — baselines/gossipsub.py."""
    return SimConfig(
        network="udp",
        scheme="bn254",
        baseline="gossipsub",
        runs=_runs(NODE_SWEEP[:4], lambda n: n * 51 // 100),
    )


def scenario_practical(nodes: int = 4000) -> SimConfig:
    """The README headline run: N=4000, 99% threshold, real crypto on the
    device path with the shared verifier fusing co-located nodes' batches."""
    return SimConfig(
        network="udp",
        scheme="bn254-jax",
        shared_verifier=True,
        batch_size=128,
        runs=_runs([nodes], lambda n: n * 99 // 100),
    )


def scenario_evaluator(nodes: int = 2000) -> SimConfig:
    """Verification-strategy A/B at fixed N: store-scored vs verify-everything
    vs arrival-order FIFO (confgenerator.go evaluator scenario)."""
    return SimConfig(
        network="udp",
        scheme="bn254-jax",
        runs=[
            RunConfig(
                nodes=nodes,
                threshold=nodes * 99 // 100,
                processes=default_processes(nodes),
                handel=HandelParams(evaluator=ev),
            )
            for ev in ("store", "eval1", "fifo")
        ],
    )


def scenario_swarm(identities: int = 65536, processes: int = 1) -> SimConfig:
    """Virtual-node swarm run (swarm/; `sim swarm`): identities
    beyond what per-node processes can carry, multiplexed as vnodes on a
    shared event loop. Gossip is set sparse — the in-memory router is
    lossless and the id-staggered fast-path cascade covers every level
    deterministically, so each gossip round only costs CPU (roughly
    identities x active-levels deliveries per period on one core)."""
    return SimConfig(
        trace=True,
        trace_capacity=1 << 22,
        swarm=SwarmParams(
            identities=identities,
            processes=processes,
            period_ms=120000.0,
            timeout_ms=50.0,
            fast_path=3,
            timeout_s=5400.0,
        ),
    )


def _scenario_base(nodes: int, scenario: ScenarioParams,
                   churner: int = 0, churn_after_ms: float = 300.0) -> SimConfig:
    """Shared shape for the WAN scenario engine configs (`sim scenario`):
    fake scheme (the WAN model, not pairings, is under test), tracing on
    for region attribution, and a short [soak] section so the same TOML is
    directly runnable as a `sim soak` workload too."""
    return SimConfig(
        scheme="fake",
        trace=True,
        trace_capacity=1 << 18,
        max_timeout_s=60.0,
        scenario=scenario,
        soak=SoakParams(duration_s=20.0, nodes=min(nodes, 32)),
        runs=[
            RunConfig(
                nodes=nodes,
                processes=1,
                adversaries=AdversaryParams(
                    churner=churner, churn_after_ms=churn_after_ms
                ),
                handel=HandelParams(period_ms=10.0, timeout_ms=50.0),
            )
        ],
    )


def scenario_geo(nodes: int = 32) -> SimConfig:
    """Geo-latency planet run: 3 regions, seeded per-link WAN delays,
    region-tagged spans (`sim scenario --config geo.toml`)."""
    return _scenario_base(
        nodes,
        ScenarioParams(
            name="geo", planet="planet-3region-fast", jitter_ms=1.0,
            geo_seed=7,
        ),
    )


def scenario_churn(nodes: int = 32) -> SimConfig:
    """Dynamic-membership run: ~10% of the committee departs mid-round on
    a deterministic staggered schedule; survivors re-level and the
    threshold stays reachable."""
    return _scenario_base(
        nodes,
        ScenarioParams(name="churn", joins=2, geo_seed=7),
        churner=max(1, nodes // 10),
    )


def scenario_weighted(nodes: int = 32) -> SimConfig:
    """Stake-weighted run: heavy-tailed pareto weights, completion gated
    on 60% of total stake instead of a contribution count."""
    return _scenario_base(
        nodes,
        ScenarioParams(
            name="weighted", weight_profile="pareto",
            weight_threshold_frac=0.6, weight_seed=7,
        ),
    )


def scenario_geo_weighted(nodes: int = 128) -> SimConfig:
    """The capture shape: 5-region planet + >=10% churn + non-uniform
    stake, all axes at once (results/geo_weighted_report.json)."""
    return _scenario_base(
        nodes,
        ScenarioParams(
            name="geo_weighted", planet="planet-5region", jitter_ms=3.0,
            geo_seed=7, joins=4, weight_profile="pareto",
            weight_threshold_frac=0.55, weight_seed=7,
        ),
        churner=max(1, nodes // 10),
        churn_after_ms=400.0,
    )


SCENARIOS = {
    "node_count": scenario_node_count,
    "threshold_inc": scenario_threshold_inc,
    "evaluator": scenario_evaluator,
    "failing": scenario_failing,
    "period": scenario_period,
    "timeout": scenario_timeout,
    "update_count": scenario_update_count,
    "nsquare": scenario_nsquare,
    "gossipsub": scenario_gossipsub,
    "practical": scenario_practical,
    "swarm": scenario_swarm,
    "geo": scenario_geo,
    "churn": scenario_churn,
    "weighted": scenario_weighted,
    "geo_weighted": scenario_geo_weighted,
}


def generate(outdir: str, names=None) -> list[str]:
    """Write every (or the named) scenario TOMLs; returns the paths."""
    os.makedirs(outdir, exist_ok=True)
    paths = []
    for name in names or SCENARIOS:
        cfg = SCENARIOS[name]()
        path = os.path.join(outdir, f"{name}.toml")
        with open(path, "w") as f:
            f.write(dump_config(cfg))
        paths.append(path)
    return paths


if __name__ == "__main__":
    import sys

    outdir = sys.argv[1] if len(sys.argv) > 1 else "configs"
    for p in generate(outdir):
        print(p)
