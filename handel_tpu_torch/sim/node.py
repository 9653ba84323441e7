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
deviation 4).

Cut from the reference, each raising NotImplementedError naming its ROADMAP
item (`check_ported`): the metrics endpoint (`metrics`, `--metrics-port`),
span tracing, the comparison baselines, adversaries, chaos, the geo model,
stake weights, the TLS transport, the verifier RPC (`--verifier`,
`--serve-verifier`) and a mesh wider than one device. The node ignores
`[service]`, as the reference's does: its `batch_check` is for the `serve`
and `load` paths, and a node's verifier checks per candidate.

Beyond the reference: a device-scheme process prints one `node process
kernels:` line (JSON) before `finished OK`: its kernel launch counts, over
the whole process and between the START and END barriers, its peak device
memory, the calls and seconds of the store's device combines, which run on
the event loop beside the service's dispatches, and its shared verifier's
launches.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from handel_tpu_torch.core.crypto import verify_multisignature
from handel_tpu_torch.core.handel import Handel
from handel_tpu_torch.core.report import SUBGROUP_CHECKS, KernelTimer, ReportAggregator
from handel_tpu_torch.models.registry import is_device_scheme, new_scheme
from handel_tpu_torch.network.encoding import CounterEncoding
from handel_tpu_torch.network.tcp import TCPNetwork
from handel_tpu_torch.network.udp import UDPNetwork
from handel_tpu_torch.sim import keys as simkeys
from handel_tpu_torch.sim.config import SimConfig, load_config
from handel_tpu_torch.sim.monitor import CounterIO, HistogramIO, Sink, TimeMeasure
from handel_tpu_torch.sim.sync import STATE_END, STATE_START, SyncSlave

MSG = b"handel-tpu simulation message"


def check_ported(cfg: SimConfig, args=None) -> None:
    """Raise NotImplementedError for the first part of `cfg` (or of the
    node's arguments) that the port does not have yet, naming its ROADMAP
    item."""
    run_parts = [
        (r.adversaries.total() > 0, "adversaries ([runs.adversaries])", "4 (6f)")
        for r in cfg.runs
    ]
    parts = [
        (cfg.metrics, "metrics = true (core/metrics.py)", "4"),
        (cfg.trace or bool(getattr(args, "trace_dir", "")),
         "trace = true (the flight recorder)", "4 (6g)"),
        (bool(cfg.baseline), f"baseline = {cfg.baseline!r}", "9"),
        *run_parts,
        (cfg.chaos.any(), "[chaos] (network/chaos.py ChaosNetwork)", "4"),
        (cfg.scenario.geo_enabled(), "the geo planet model (network/geo.py)", "4"),
        (cfg.scenario.weights_enabled(), "stake weights", "8 (6h)"),
        (cfg.network == "quic", 'network = "quic"', "4"),
        (bool(getattr(args, "verifier", "")),
         "--verifier (parallel/rpc_verifier.py)", "4"),
        (bool(getattr(args, "serve_verifier", 0)),
         "--serve-verifier (parallel/rpc_verifier.py)", "4"),
        (getattr(args, "metrics_port", -1) >= 0,
         "--metrics-port (core/metrics.py)", "4"),
        (cfg.mesh_devices > 1, f"mesh_devices = {cfg.mesh_devices}", "7"),
    ]
    for on, what, item in parts:
        if on:
            raise NotImplementedError(
                f"{what} is not ported to handel_tpu_torch yet (ROADMAP item {item})"
            )


def _kernel_counts() -> dict[str, int]:
    from handel_tpu_torch.kernels.fp_mont import mont_mul
    from handel_tpu_torch.kernels.rns_mont import rns_mul_resident

    return {"fp_mont_mul": mont_mul.launches,
            "rns_mont_mul_resident": rns_mul_resident.launches}


async def run_node_process(args) -> int:
    cfg = load_config(args.config)
    run = cfg.runs[args.run]
    check_ported(cfg, args)

    device_scheme = is_device_scheme(cfg.scheme)
    dev = None
    if device_scheme:
        from handel_tpu_torch.utils.torchenv import device_from_env

        dev = device_from_env()  # raises for cuda on a host without a card
    scheme = new_scheme(
        cfg.scheme,
        **(
            {
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
            if device_scheme
            else {}
        ),
    )
    ids = [int(x) for x in args.ids.split(",") if x != ""]
    threshold = run.resolved_threshold()

    sink = Sink(args.monitor) if args.monitor else None
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

    # one transport per logical node, bound to its registry address
    handels = []
    shared_service = None
    combine_timer = None
    if device_scheme:
        # set before the Handels exist: each node's CombineShim binds the
        # constructor's `device_combine` when it is built
        combine_timer = KernelTimer(scheme.constructor.device_combine, name="combine")
        scheme.constructor.device_combine = combine_timer
    if cfg.shared_verifier and hasattr(scheme.constructor, "Device"):
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
        shared_service = BatchVerifierService(device, fallback=None)
        if plane is not None:
            plane.add("verifier", shared_service)
            plane.add("launch", launch_timer)
            plane.add("dispatch", dispatch_timer)

    for nid in ids:
        rec = records[nid]
        enc = CounterEncoding()
        if cfg.network == "tcp":
            net = TCPNetwork(rec.address, encoding=enc)
        else:
            net = UDPNetwork(rec.address, encoding=enc)
        await net.start()
        sk = simkeys.secret_of(rec, scheme)
        hconf = run.handel.to_config(threshold, seed=nid)
        hconf.batch_size = cfg.batch_size
        if shared_service is not None:
            hconf.verifier = shared_service.verify
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

    measures = []
    for nid, h, net in handels:
        if sink:
            measures.append((
                TimeMeasure(sink, "sigen"),
                CounterIO(sink, "net", net),
                CounterIO(sink, "sigs", h),
                HistogramIO(sink, "sigs", h),
            ))
        else:
            measures.append(None)
        h.start()

    try:
        finals = await asyncio.wait_for(
            asyncio.gather(*(h.final_signatures.get() for _, h, _ in handels)),
            timeout=cfg.max_timeout_s,
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

    ok = True
    for (nid, h, net), m, ms in zip(handels, measures, finals):
        if m:
            for meas in m:
                meas.record()
        if not verify_multisignature(MSG, ms, registry, scheme.constructor):
            print(f"node {nid}: FINAL SIGNATURE INVALID", file=sys.stderr)
            ok = False
        h.stop()
        net.stop()

    await asyncio.gather(
        *(s.signal_and_wait(STATE_END, cfg.max_timeout_s) for s in slaves)
    )
    # batch-plane record (once per process) AFTER the fleet-wide END
    # barrier; the master's monitor stays up until it has collected the
    # process exits, so this record still lands
    if device_meas is not None:
        device_meas.record()
    if shared_service is not None:
        shared_service.stop()
    if device_scheme:
        import torch

        at_end = _kernel_counts()
        print("node process kernels: " + json.dumps({
            "ids": len(ids),
            "device": str(dev),
            "launches": at_end,
            "launches_in_round": {
                k: v - kernels_at_start[k] for k, v in at_end.items()
            },
            "max_memory_allocated": (
                torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
            ),
            "device_combine": combine_timer.values(),
            "verifier_launches": (
                shared_service.launches if shared_service is not None else None
            ),
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
    # the reference's verifier RPC, span tracing and metrics endpoint: not
    # ported (check_ported raises when one is set)
    ap.add_argument("--serve-verifier", type=int, default=0)
    ap.add_argument("--verifier", default="")
    ap.add_argument("--trace-dir", default="")
    ap.add_argument("--metrics-port", type=int, default=-1)
    args = ap.parse_args()
    return asyncio.run(run_node_process(args))


if __name__ == "__main__":
    sys.exit(main())
