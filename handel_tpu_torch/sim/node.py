"""Per-process simulation node entry point — the localhost run path of
handel_tpu/sim/node.py.

Reference: simul/node/main.go:33-144 — connect the monitor sink, load config
+ registry CSV, build K Handel instances (one per -id), signal the START
barrier, run until threshold, record `sigen`/`net`/`sigs` measures, verify
the final signature against the registry, signal END.

Run as: python -m handel_tpu_torch.sim.node --config C --registry R
        --master M --monitor MON --run I --ids 1,2,3

All logical nodes in this process share one asyncio loop and one socket per
node; with `shared_verifier` and a device scheme they share one
`BatchVerifierService` over one engine, whose launches run on the device
that $HANDEL_TORCH_DEVICE names (`cuda` unless it says `cpu`;
utils/torchenv.py). The service has no host fallback: a failing device
fails the run instead of degrading into host verification (ROADMAP §C,
deviation 4). `--serve-verifier PORT` serves that service to other
processes over TCP, and `--verifier HOST:PORT` makes a process without an
engine verify through such a server (parallel/rpc_verifier.py): that
process builds its scheme on the CPU without a warmup, so it holds no CUDA
context, launches no kernel, and folds its merges on the host (the
remote platform's chip-less hosts, sim/remote.py).

Transports, faults and observability, as in the reference: `network`
picks UDP, TCP or the TLS stream transport (`"quic"`, network/quic.py,
which needs the `cryptography` package), `[scenario]`'s planet wraps each
node's transport in a seeded `GeoNetwork` (network/geo.py) and tags its
spans with its region, `[chaos]` wraps each node's transport in a seeded
`ChaosNetwork` (the `GeoNetwork` applies both when both are set),
`[runs.adversaries]` seats byzantine roles (sim/adversary.py),
`--trace-dir` records a flight recorder per process and dumps it as
`trace_<first id>.json` after the END barrier, and
`metrics = true` with `--metrics-port` serves /metrics, /healthz, /readyz
and /debug/profile (core/metrics.py, parallel/telemetry.py).

`[scenario]`'s stake weights set each node's weights and weighted
threshold, and `[runs.adversaries] churner = K` seats churners that leave
after `churn_after_ms` and tell their co-located survivors
(`Handel.mark_departed`); survivors in other processes see the departure
as silence, as in the reference.

Cut from the reference, each raising NotImplementedError naming its ROADMAP
item (`check_ported`): the comparison baselines and a mesh wider than one
device.
The node ignores `[service]`, as the reference's does: its `batch_check` is
for the `serve` and `load` paths, and a node's verifier checks per
candidate.

Beyond the reference: a device-scheme process prints one `node process
kernels:` line (JSON) before `finished OK`: its kernel launch counts, over
the whole process and between the START and END barriers, B1's launches by
column count, its peak device memory, whether it initialised CUDA at all,
the calls and seconds of the store's device combines, which run on the
event loop beside the service's dispatches, and its shared verifier's
launches, and under `weighted` the stake gate, each honest node's final
stake and the departures it marked. Its nodes stay in the round until the END barrier
(`serve_until_end`, ROADMAP §C deviation 5).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys

from handel_tpu_torch.core.crypto import verify_multisignature
from handel_tpu_torch.core.handel import Handel
from handel_tpu_torch.core.report import SUBGROUP_CHECKS, KernelTimer, ReportAggregator
from handel_tpu_torch.core.trace import FlightRecorder
from handel_tpu_torch.models.registry import is_device_scheme, new_scheme
from handel_tpu_torch.network.chaos import ChaosNetwork
from handel_tpu_torch.network.encoding import CounterEncoding
from handel_tpu_torch.network.quic import QUICNetwork
from handel_tpu_torch.network.tcp import TCPNetwork
from handel_tpu_torch.network.udp import UDPNetwork
from handel_tpu_torch.sim import keys as simkeys
from handel_tpu_torch.sim.adversary import (
    ROLE_CHURNER,
    adversary_roles,
    build_adversary,
    check_threshold_reachable,
)
from handel_tpu_torch.sim.allocator import new_allocator
from handel_tpu_torch.sim.config import SimConfig, load_config
from handel_tpu_torch.sim.monitor import CounterIO, HistogramIO, Sink, TimeMeasure
from handel_tpu_torch.sim.sync import STATE_END, STATE_START, SyncSlave

MSG = b"handel-tpu simulation message"
# how long a verifier-serving process waits, after the END barrier, for its
# RPC clients to close their links before it stops serving (C4)
RPC_CLIENTS_CLOSE_S = 10.0


def check_ported(cfg: SimConfig) -> None:
    """Raise NotImplementedError for the first part of `cfg` that the port
    does not have yet, naming its ROADMAP item."""
    parts = [
        (bool(cfg.baseline), f"baseline = {cfg.baseline!r}", "9"),
        (cfg.mesh_devices > 1, f"mesh_devices = {cfg.mesh_devices}", "7"),
    ]
    for on, what, item in parts:
        if on:
            raise NotImplementedError(
                f"{what} is not ported to handel_tpu_torch yet (ROADMAP item {item})"
            )


def stall_timeout_s(max_timeout_s: float) -> float:
    """How long a process waits for its honest nodes' final signatures:
    a little under the platform's END wait (the same `max_timeout_s`), so
    that a stalled process prints its STALLED lines and exits before the
    platform kills it."""
    return max(0.5 * max_timeout_s, max_timeout_s - 5.0)


async def serve_until_end(handels, threshold, timeout_s, on_finals, end_barrier):
    """Run a process's nodes to the END of the whole fleet.

    Waits up to `timeout_s` for the final signature of every honest node of
    the process (adversarial roles never emit one), printing each node's
    progress as a STALLED line when it runs out; hands {id: final} to
    `on_finals` (the measures and the final check); then keeps every node
    of the process in the protocol until `end_barrier()` returns, and only
    then stops them (ROADMAP §C, deviation 5). The reference stops a
    process's nodes as soon as its own honest nodes are done
    (handel_tpu/sim/node.py:466-476): a node of another process that still
    misses a contribution lost on the wire then never gets it, because
    Handel sends each signature to each peer once and re-sends only when
    it improves (core/handel.py `Level.active`).
    """
    honest = [
        (nid, h, net)
        for nid, h, net in handels
        if getattr(h, "role", None) is None
    ]
    try:
        finals = await asyncio.wait_for(
            asyncio.gather(*(h.final_signatures.get() for _, h, _ in honest)),
            timeout=timeout_s,
        )
    except asyncio.TimeoutError:
        # stall diagnostics: per-node progress is the only evidence a
        # multi-process deadlock leaves behind
        for nid, h, net in handels:
            best = h.store.full_signature()
            card = best.cardinality() if best else 0
            vals = net.values()
            print(
                f"node {nid}: STALLED at {card}/{threshold} "
                f"(sent={vals.get('sentPackets')} rcvd={vals.get('rcvdPackets')} "
                f"dropped={vals.get('droppedPackets')})",
                file=sys.stderr,
            )
        raise
    on_finals(dict(zip((nid for nid, _, _ in honest), finals)))
    try:
        await end_barrier()
    finally:
        for _, h, net in handels:
            h.stop()
            net.stop()
    return finals


def _kernel_counts() -> dict[str, int]:
    from handel_tpu_torch.kernels.fp_mont import mont_mul
    from handel_tpu_torch.kernels.rns_mont import rns_mul_resident

    return {"fp_mont_mul": mont_mul.launches,
            "rns_mont_mul_resident": rns_mul_resident.launches}


def _b1_widths() -> dict[str, int]:
    """Kernel B1's launches in this process by column count."""
    from handel_tpu_torch.kernels.fp_mont import mont_mul

    return {str(cols): n for cols, n in sorted(mont_mul.widths.items())}


async def run_node_process(args) -> int:
    cfg = load_config(args.config)
    run = cfg.runs[args.run]
    check_ported(cfg)

    # live telemetry plane (core/metrics.py): the HTTP endpoint comes up
    # BEFORE the scheme builds, so /healthz answers during a long prepare
    # while /readyz stays 503 until the readiness probes pass — scheme
    # warmed, breaker not open, monitor sink connected. `metrics = false`
    # (or no --metrics-port from the platform) keeps the plane fully off:
    # zero threads, zero sockets.
    mreg = mserver = None
    sink = None
    ready_state = {"scheme_warmed": False, "service": None}
    if cfg.metrics and args.metrics_port >= 0:
        from handel_tpu_torch.core.metrics import MetricsRegistry, MetricsServer

        mreg = MetricsRegistry()
        mreg.add_readiness("scheme_warmed", lambda: ready_state["scheme_warmed"])
        mreg.add_readiness(
            "breaker_closed",
            lambda: (
                ready_state["service"] is None
                or ready_state["service"].breaker.state != "open"
            ),
        )
        mreg.add_readiness("monitor_sink", lambda: bool(sink) or not args.monitor)
        mserver = MetricsServer(mreg, port=args.metrics_port).start()
        # the BOUND port is authoritative (--metrics-port 0 = ephemeral):
        # drop it next to the config so scrapers can discover manual runs
        addr_path = os.path.join(
            os.path.dirname(os.path.abspath(args.config)),
            f"metrics_{args.ids.split(',')[0]}.addr",
        )
        try:
            with open(addr_path, "w") as f:
                f.write(mserver.address + "\n")
        except OSError:
            pass
        print(f"metrics: serving on http://{mserver.address}", flush=True)

    device_scheme = is_device_scheme(cfg.scheme)
    dev = None
    scheme_kw = {}
    if device_scheme:
        from handel_tpu_torch.utils.torchenv import device_from_env

        # a chip-less process (`--verifier`) keeps its scheme on the host:
        # its candidates verify on the card host's engine, and its merges
        # fold on the host (device_combine declines before prepare)
        dev = device_from_env() if not args.verifier else None
        scheme_kw = {
            "batch_size": cfg.batch_size,
            "fp_backend": cfg.fp_backend,
            # residency only means something on the rns backend; None
            # lets the pairing layer decide (and avoids the
            # explicit-True-on-cios error)
            "rns_resident": (
                cfg.rns_resident if cfg.fp_backend == "rns" else None
            ),
            "device": dev,
        }
        if args.verifier:
            scheme_kw.update(device="cpu", warmup=False)
    scheme = new_scheme(cfg.scheme, **scheme_kw)
    ids = [int(x) for x in args.ids.split(",") if x != ""]
    threshold = run.resolved_threshold()

    # span flight recorder (core/trace.py): one ring per process, every
    # logical node recording under its id as the Chrome-trace tid; dumped
    # as trace_<first-id>.json into --trace-dir after the END barrier
    recorder = None
    if args.trace_dir:
        recorder = FlightRecorder(capacity=cfg.trace_capacity, pid=os.getpid())

    if args.monitor:
        sink = Sink(args.monitor)
    # process-wide batch-plane telemetry: G2 subgroup-check cost (which
    # starts accruing at registry load, right below), shared launch fill
    # ratio and launch wall time added once the service exists. Snapshot
    # BEFORE the registry unmarshals so startup cost is attributed.
    plane = device_meas = None
    if sink:
        plane = ReportAggregator(subgroup=SUBGROUP_CHECKS)
        device_meas = CounterIO(sink, "device", plane)

    records = simkeys.read_registry_csv(args.registry)
    registry = simkeys.registry_from_records(records, scheme)

    # WAN scenario plane: geo placement, stake weights and the weighted
    # threshold, derived identically in every process from the shared TOML
    scen = cfg.scenario
    geo_base = scen.geo_config() if scen.geo_enabled() else None
    weights = scen.make_weights(run.nodes) if scen.weights_enabled() else None
    weight_threshold = (
        scen.weight_threshold(threshold, run.nodes, weights)
        if weights is not None
        else 0.0
    )

    # byzantine roles (sim/adversary.py): recompute the allocator's offline
    # set locally so every process derives the SAME id -> role mapping
    roles: dict[int, str] = {}
    if run.adversaries.total():
        alloc = new_allocator(cfg.allocator).allocate(
            run.nodes, 1, run.processes, run.failing
        )
        offline = {nid for nid, slot in alloc.items() if not slot.active}
        roles = adversary_roles(run.adversaries.counts(), run.nodes, offline)
        check_threshold_reachable(
            threshold,
            run.nodes,
            run.failing,
            roles,
            weights=weights,
            weight_threshold=weight_threshold,
        )

    # one transport per logical node, bound to its registry address
    handels = []
    shared_service = None
    combine_timer = None
    rpc_client = None
    rpc_server = None
    if device_scheme:
        # set before the Handels exist: each node's CombineShim binds the
        # constructor's `device_combine` when it is built
        combine_timer = KernelTimer(scheme.constructor.device_combine, name="combine")
        scheme.constructor.device_combine = combine_timer
    if args.verifier:
        # a process without an engine: ship candidate batches to the card's
        # host instead of preparing a device (parallel/rpc_verifier.py)
        from handel_tpu_torch.parallel.rpc_verifier import RPCVerifier

        rpc_client = RPCVerifier(args.verifier)
        if plane is not None:
            plane.add("rpc", rpc_client)
    elif cfg.shared_verifier and hasattr(scheme.constructor, "Device"):
        from handel_tpu_torch.parallel.batch_verifier import BatchVerifierService

        # prepare() builds the engine for the registry (and warms it), and
        # caches it on the constructor, so per-node device combines reuse
        # the same registry upload
        device = scheme.constructor.prepare(registry.public_keys())
        # launch-time counters on the monitor plane: the service's lanes
        # call the engine's dispatch (host prep + enqueue) and fetch
        # (verdict arrival) directly, so the timers wrap those
        launch_timer = KernelTimer(device.fetch, name="launch")
        device.fetch = launch_timer
        dispatch_timer = KernelTimer(device.dispatch, name="dispatch")
        device.dispatch = dispatch_timer
        # no host fallback: a failing device fails the run (module docstring)
        shared_service = BatchVerifierService(
            device, fallback=None, recorder=recorder
        )
        ready_state["service"] = shared_service
        if plane is not None:
            plane.add("verifier", shared_service)
            plane.add("launch", launch_timer)
            plane.add("dispatch", dispatch_timer)
        if args.serve_verifier:
            # this is the fleet's card host: serve the batch plane to every
            # process without an engine BEFORE the START barrier, so remote
            # clients never race the bind
            from handel_tpu_torch.parallel.rpc_verifier import VerifierServer

            rpc_server = VerifierServer(
                shared_service, scheme.constructor, port=args.serve_verifier
            )
            await rpc_server.start()
            if plane is not None:
                plane.add("rpcserve", rpc_server)
    # scheme construction and prepare() run the device's first-use work
    # (models/bn254_torch.py); fake/host schemes are warm by definition
    ready_state["scheme_warmed"] = True

    for nid in ids:
        rec = records[nid]
        enc = CounterEncoding()
        if cfg.network == "tcp":
            net = TCPNetwork(rec.address, encoding=enc)
        elif cfg.network == "quic":
            net = QUICNetwork(rec.address, encoding=enc)
        else:
            net = UDPNetwork(rec.address, encoding=enc)
        if geo_base is not None:
            # geo-latency planet model (network/geo.py): region-pair WAN
            # delay, chaos faults composed on top when any rate is set
            from handel_tpu_torch.network.geo import GeoNetwork

            net = GeoNetwork(
                net,
                geo_base.for_node(nid),
                chaos=cfg.chaos.for_node(nid) if cfg.chaos.any() else None,
            )
        elif cfg.chaos.any():
            # fault-injection plane (network/chaos.py): same transport
            # underneath, seeded per-link faults on top
            net = ChaosNetwork(net, cfg.chaos.for_node(nid))
        await net.start()
        sk = simkeys.secret_of(rec, scheme)
        hconf = run.handel.to_config(threshold, seed=nid)
        hconf.batch_size = cfg.batch_size
        hconf.recorder = recorder
        if geo_base is not None:
            hconf.region = geo_base.region_of(nid)
        if weights is not None:
            hconf.weights = weights
            hconf.weight_threshold = weight_threshold
        if shared_service is not None:
            hconf.verifier = shared_service.verify
        elif rpc_client is not None:
            hconf.verifier = rpc_client.verify
        if nid in roles:
            h = build_adversary(
                roles[nid],
                net,
                registry,
                registry.identity(nid),
                scheme.constructor,
                MSG,
                sk,
                hconf,
                flood_pps=run.adversaries.flood_pps,
                leave_after_s=run.adversaries.churn_after_ms / 1000.0,
            )
        else:
            h = Handel(
                net,
                registry,
                registry.identity(nid),
                scheme.constructor,
                MSG,
                sk.sign(MSG),
                hconf,
            )
        handels.append((nid, h, net))

    # churn: a departing node notifies its co-located survivors directly
    # (Handel.mark_departed -> re-level + threshold re-evaluation).
    # Survivors in other processes see the departure as silence, exactly
    # like a `failing` node: the callback is a process-local accelerant,
    # not a consensus channel.
    churners = [h for _, h, _ in handels if getattr(h, "role", None) == ROLE_CHURNER]
    if churners:
        survivors = [h for _, h, _ in handels]

        def _on_depart(departed_id: int, _peers=survivors) -> None:
            for p in _peers:
                md = getattr(p, "mark_departed", None)
                if md is not None:
                    md(departed_id)

        for ch in churners:
            ch.on_depart = _on_depart

    # registry-backed scrape surfaces: every logical node's protocol (sigs),
    # transport (net) and peer-penalty planes under a node label, the
    # process-wide verifier under device_verifier, the card's state under
    # device, host crypto counters under host (naming: handel_<plane>_<key>)
    if mreg is not None:
        for nid, h, net in handels:
            lbl = {"node": str(nid)}
            mreg.register_values("sigs", h, labels=lbl)
            mreg.register_histograms("sigs", h, labels=lbl)
            mreg.register_values("net", net, labels=lbl)
            if hasattr(net, "histograms"):
                mreg.register_histograms("net", net, labels=lbl)
            mreg.register_values("penalty", h.scorer, labels=lbl)
        if shared_service is not None:
            mreg.register_values("device_verifier", shared_service)
        if plane is not None:
            mreg.register_values("host", plane)
        if recorder is not None:
            mreg.register_values("trace", recorder)
        if device_scheme:
            from handel_tpu_torch.parallel.telemetry import DeviceTelemetry

            telemetry = DeviceTelemetry(
                service=shared_service,
                device=dev,
                trace_dir=args.trace_dir
                or os.path.dirname(os.path.abspath(args.config)),
            )
            mreg.register_values("device", telemetry)
            mserver.set_profiler(telemetry.profile)

    # barrier: ready to start (one slave per logical node id)
    slaves = []
    for nid, _, _ in handels:
        s = SyncSlave(args.master, nid)
        await s.start()
        slaves.append(s)
    await asyncio.gather(
        *(s.signal_and_wait(STATE_START, cfg.max_timeout_s) for s in slaves)
    )
    kernels_at_start = _kernel_counts() if device_scheme else None
    if recorder is not None and slaves:
        # best (min-RTT) offset-vs-master estimate from the START handshake
        # (sim/sync.py): carried in the trace export so merge_traces aligns
        # this process's timeline with the rest of the fleet
        best_slave = min(slaves, key=lambda s: s.clock_rtt)
        if best_slave.clock_rtt != float("inf"):
            recorder.clock_offset = best_slave.clock_offset

    measures = []
    for nid, h, net in handels:
        if sink:
            ms = [TimeMeasure(sink, "sigen"), CounterIO(sink, "net", net),
                  CounterIO(sink, "sigs", h), HistogramIO(sink, "sigs", h)]
            if hasattr(net, "histograms"):
                # chaos/geo delay distribution -> net_delayMs_p50/_p90/_p99
                ms.append(HistogramIO(sink, "net", net))
            measures.append(tuple(ms))
        else:
            measures.append(None)
        h.start()

    ok = True
    # each final's stake (its cardinality on a count run), for the kernels
    # line below
    final_stakes: dict[int, float] = {}

    def on_finals(finals_by_nid):
        nonlocal ok
        for (nid, h, net), m in zip(handels, measures):
            if m:
                for meas in m:
                    meas.record()
            ms = finals_by_nid.get(nid)
            if ms is not None:
                final_stakes[nid] = (
                    ms.bitset.weight_sum(weights) if weights is not None
                    else float(ms.cardinality())
                )
            if ms is not None and not verify_multisignature(
                MSG, ms, registry, scheme.constructor
            ):
                print(f"node {nid}: FINAL SIGNATURE INVALID", file=sys.stderr)
                ok = False

    async def end_barrier():
        await asyncio.gather(
            *(s.signal_and_wait(STATE_END, cfg.max_timeout_s) for s in slaves)
        )

    await serve_until_end(
        handels, threshold, stall_timeout_s(cfg.max_timeout_s), on_finals,
        end_barrier,
    )
    # every node everywhere is done: stop serving and verifying before the
    # batch-plane record and the trace dump, so that both hold the same
    # launches (a launch still in flight would land between them). A
    # verifier-serving process answers other processes' RPC batches until
    # here, and keeps their links open until their clients have recorded
    # and closed them (ROADMAP §C C4). The master's monitor stays up until
    # it has collected the process exits, so this record still lands
    if rpc_server is not None:
        rpc_server.stop()
        await rpc_server.wait_clients_closed(RPC_CLIENTS_CLOSE_S)
    if shared_service is not None:
        shared_service.stop()
    if device_meas is not None:
        device_meas.record()
    if rpc_client is not None:
        # after its record, so that the serving process's exit cannot put
        # a link error on it; the server waits for this close
        rpc_client.stop()
    if recorder is not None:
        recorder.dump(
            os.path.join(args.trace_dir, f"trace_{ids[0] if ids else 0}.json")
        )
    if mserver is not None:
        # keep the endpoint up briefly so scrapers catch the final counter
        # state of a short run (default 0)
        if cfg.metrics_linger_s > 0:
            await asyncio.sleep(cfg.metrics_linger_s)
        mserver.stop()
    if device_scheme:
        import torch

        at_end = _kernel_counts()
        print("node process kernels: " + json.dumps({
            "ids": len(ids),
            "device": str(dev),
            "initialized_cuda": torch.cuda.is_initialized(),
            "launches": at_end,
            "launches_in_round": {
                k: v - kernels_at_start[k] for k, v in at_end.items()
            },
            "fp_mont_mul_widths": _b1_widths(),
            "max_memory_allocated": (
                torch.cuda.max_memory_allocated(dev)
                if dev is not None and dev.type == "cuda"
                else None
            ),
            "device_combine": combine_timer.values(),
            "verifier_launches": (
                shared_service.launches if shared_service is not None else None
            ),
            # the weighted gate (None on a count run), each honest node's
            # final stake and the departures it marked (its process's
            # churners)
            "weighted": {
                "gate": weight_threshold if weights is not None else None,
                "final_stakes": {str(k): v for k, v in sorted(final_stakes.items())},
                "departures": {
                    str(nid): len(h.departed) for nid, h, _ in handels
                    if getattr(h, "role", None) is None
                },
            },
        }, sort_keys=True), flush=True)
    for s in slaves:
        s.stop()
    if sink:
        sink.close()
    if ok:
        print(f"node process finished OK ids={ids}")
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--registry", required=True)
    ap.add_argument("--master", required=True)
    ap.add_argument("--monitor", default="")
    ap.add_argument("--run", type=int, default=0)
    ap.add_argument("--ids", required=True)
    # run-scoping marker only: never read, but present in argv so the
    # orchestrator's cleanup pkill can match THIS run's node processes
    # without killing other simulations on a shared host (sim/remote.py)
    ap.add_argument("--tag", default="")
    # batch-plane RPC (parallel/rpc_verifier.py): serve the local shared
    # verifier on this port / verify through the card host's server
    ap.add_argument("--serve-verifier", type=int, default=0)
    ap.add_argument("--verifier", default="")
    # span tracing: record a flight recorder (core/trace.py) and dump its
    # Chrome trace_event JSON into this directory at run end
    ap.add_argument("--trace-dir", default="")
    # live telemetry (core/metrics.py): serve /metrics+/healthz+/readyz on
    # this port (0 = ephemeral, bound port written next to the config);
    # absent (-1) or `metrics = false` in the TOML = plane fully off
    ap.add_argument("--metrics-port", type=int, default=-1)
    args = ap.parse_args()
    return asyncio.run(run_node_process(args))


if __name__ == "__main__":
    sys.exit(main())
