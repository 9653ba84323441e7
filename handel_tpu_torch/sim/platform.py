"""Simulation platforms: configure -> deploy -> start -> collect — the
localhost platform of handel_tpu/sim/platform.py.

Reference: simul/platform/platform.go:15-89 (lifecycle), localhost.go:16-266
(keygen + registry CSV + allocation + process spawning + barriers + stats
CSV). Each node process gets its own /metrics port (`metrics_port_plan`,
written to `metrics_ports.json`) when the config sets `metrics = true`, and
its own trace file under the run's `trace_<run>/` when it sets
`trace = true`. The multi-host platform is sim/remote.py
(`--platform remote`).

Beyond the reference: for a device scheme on the card, the parent builds the
CUDA kernels (kernels/build.py `build_all`) before it spawns the node
processes, so no two of them compile the same library at once; the node
processes' pipes are read while the run goes, and one that exits non-zero
fails the run at once instead of after `max_timeout_s`; and each node
process's output is kept in the run directory as `node_<run>_<process>.out`
and `.err`.
"""

from __future__ import annotations

import asyncio
import os
import socket
import sys

from handel_tpu_torch.models.registry import (
    host_scheme_name,
    is_device_scheme,
    new_scheme,
)
from handel_tpu_torch.sim import keys as simkeys
from handel_tpu_torch.sim.allocator import new_allocator
from handel_tpu_torch.sim.config import SimConfig, dump_config
from handel_tpu_torch.sim.monitor import Monitor
from handel_tpu_torch.sim.sync import STATE_END, STATE_START, SyncMaster


# the kernel's ephemeral source-port range: ports returned by bind(0) live
# here, so a released probe port can be re-grabbed as the SOURCE port of any
# connected socket (sync slaves, monitor sinks) before its intended process
# binds it — at 256+ node sockets per run that race is near-certain. Probing
# sequentially OUTSIDE the range closes it.
def _probe_window() -> tuple[int, int] | None:
    """(lo, hi) port window disjoint from the ephemeral range, or None when
    the configured range leaves no usable window (degrade to bind(0))."""
    eph_lo, eph_hi = 32768, 60999
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            eph_lo, eph_hi = (int(x) for x in f.read().split()[:2])
    except (OSError, ValueError):
        pass
    if eph_lo - 10000 >= 4096:  # enough room below the range
        return (max(10000, eph_lo - 22768), eph_lo)
    if 65536 - (eph_hi + 1) >= 2048:  # room above it
        return (eph_hi + 1, 65536)
    return None


_WINDOW = _probe_window()
# offset the start per process so concurrent runs on one host don't probe
# the same sequence (each still verifies by binding)
_probe_cursor = [
    _WINDOW[0] + (os.getpid() * 37) % ((_WINDOW[1] - _WINDOW[0]) // 2)
    if _WINDOW
    else 0
]


def free_ports(n: int) -> list[int]:
    """simul/lib/net.go:13-52, hardened for single-host scale: sequential
    ports outside the ephemeral range, each probed as BOTH udp and tcp so the
    result is usable by either transport family. All probe sockets are held
    until the full set is allocated. Falls back to kernel-chosen ports when
    the ephemeral range covers everything (pathological sysctl)."""
    socks, ports = [], []
    port = _probe_cursor[0]
    probes = 0
    max_probes = (_WINDOW[1] - _WINDOW[0]) if _WINDOW else 0
    while len(ports) < n:
        if _WINDOW is not None and probes >= max_probes + n:
            # one full pass over the window without filling the request:
            # every port is occupied (or n exceeds the window) — fail with a
            # diagnosable error instead of spinning forever
            for s in socks:
                s.close()
            raise OSError(
                f"free_ports: no {n} free ports in window {_WINDOW} "
                f"after {probes} probes ({len(ports)} found)"
            )
        u = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        t = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            if _WINDOW is None:  # no disjoint window: old bind(0) behavior
                u.bind(("127.0.0.1", 0))
                t.bind(("127.0.0.1", u.getsockname()[1]))
            else:
                if port >= _WINDOW[1]:
                    port = _WINDOW[0]  # wrap
                u.bind(("127.0.0.1", port))
                t.bind(("127.0.0.1", port))
        except OSError:  # something holds it: try the next port
            u.close()
            t.close()
            port += 1
            probes += 1
            continue
        socks += [u, t]
        ports.append(u.getsockname()[1])
        port += 1
    _probe_cursor[0] = port  # successive allocations advance, not reuse
    for s in socks:
        s.close()
    return ports


def port_plan(cfg, nodes: int) -> tuple[list[int], int, int, int]:
    """The fleet's port layout, shared by both platforms: node i at
    base_port + i, master at -2, monitor at -1, verifier RPC at -3.
    With base_port unset, ports are probed (free_ports holds-and-releases
    to guarantee availability; the verifier slot returns 0 — the caller
    probes one on demand). Returns (node_ports, master, monitor, verifier).
    """
    base = cfg.base_port
    if not base:
        ports = free_ports(nodes + 2)
        return ports[:nodes], ports[nodes], ports[nodes + 1], 0
    if base < 4 or base + nodes > 65536:
        raise ValueError(
            f"base_port {base} with {nodes} nodes leaves no room for the "
            f"master/monitor/verifier slots (need 4 <= base_port and "
            f"base_port + nodes <= 65536)"
        )
    return [base + i for i in range(nodes)], base - 2, base - 1, base - 3


def preflight_ports(ports: list[int]) -> None:
    """Fail fast if any fixed-plan port is already taken on this host:
    a silent bind failure inside one node process otherwise surfaces only
    as a full max_timeout_s barrier stall. Binds and immediately closes
    (sequential, so no fd accumulation at 16k ports)."""
    for p in ports:
        for fam in (socket.SOCK_DGRAM, socket.SOCK_STREAM):
            s = socket.socket(socket.AF_INET, fam)
            try:
                s.bind(("127.0.0.1", p))
            except OSError as e:
                raise OSError(
                    f"fixed port {p} is already in use ({e}); pick a "
                    f"different base_port"
                ) from e
            finally:
                s.close()


def metrics_port_plan(cfg, nodes: int, nprocs: int) -> list[int]:
    """Per-process metrics ports: one /metrics
    endpoint per node process, so multi-process runs on one host never
    collide. With base_port set the plan is fixed ABOVE the node block
    (base_port + nodes + 1 + i — the master/monitor/verifier slots live
    below base, the node block ends at base + nodes); otherwise ports are
    probed like the node ports. Empty when `metrics = false` — the plane
    then costs zero sockets and zero threads."""
    if not cfg.metrics or nprocs <= 0:
        return []
    if cfg.base_port:
        lo = cfg.base_port + nodes + 1
        if lo + nprocs > 65536:
            raise ValueError(
                f"base_port {cfg.base_port} with {nodes} nodes leaves no "
                f"room for {nprocs} metrics ports above the node block"
            )
        return [lo + i for i in range(nprocs)]
    return free_ports(nprocs)


def write_metrics_ports(
    workdir: str, run_index: int, by_proc_ports: dict[int, int]
) -> str:
    """Persist the run's metrics endpoints (the scrapers' discovery file):
    {"run": i, "addresses": {"<process>": "127.0.0.1:<port>"}}."""
    import json

    path = os.path.join(workdir, "metrics_ports.json")
    with open(path, "w") as f:
        json.dump(
            {
                "run": run_index,
                "addresses": {
                    str(p): f"127.0.0.1:{port}"
                    for p, port in sorted(by_proc_ports.items())
                },
            },
            f,
            indent=1,
        )
    return path


def keep_node_outputs(workdir: str, run_index: int, names, outs) -> None:
    """Each node process's (stdout, stderr) as node_<run>_<name>.out/.err
    in the run directory: the only diagnostics a failed or stalled process
    leaves, and the `node process kernels` lines of a device run."""
    for name, (out, err) in zip(names, outs):
        for ext, data in (("out", out), ("err", err)):
            with open(os.path.join(workdir, f"node_{run_index}_{name}.{ext}"), "wb") as f:
                f.write(data)


class LocalhostPlatform:
    """Spawn every node process on this machine (localhost.go:16-266)."""

    def __init__(self, cfg: SimConfig, workdir: str):
        self.cfg = cfg
        self.dir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.config_path = os.path.join(workdir, "sim.toml")
        with open(self.config_path, "w") as f:
            f.write(dump_config(cfg))

    async def start_run(self, run_index: int) -> "RunResult":
        cfg = self.cfg
        run = cfg.runs[run_index]
        scheme_kw = {}
        # a baseline's nodes verify on the host (sim/node.py, deviation 8)
        scheme_name = host_scheme_name(cfg.scheme) if cfg.baseline else cfg.scheme
        if is_device_scheme(scheme_name):
            from handel_tpu_torch.utils.torchenv import device_type_from_env

            if device_type_from_env() == "cuda":
                from handel_tpu_torch.kernels.build import build_all

                build_all()
            # the parent only generates keys, which is host work: its scheme
            # holds no CUDA context while the node processes run
            scheme_kw = {"device": "cpu", "warmup": False}
        scheme = new_scheme(scheme_name, **scheme_kw)

        # ports: node addresses + master + monitor. With base_port set the
        # fixed plan applies (probing holds 2 fds per port simultaneously,
        # which blows the fd limit at committee sizes like 16384) — with a
        # fail-fast probe of the range, since a taken port would otherwise
        # surface only as a barrier stall after max_timeout_s
        node_ports, master_p, monitor_p, _ = port_plan(cfg, run.nodes)
        if cfg.base_port:
            preflight_ports(node_ports + [master_p, monitor_p])
        addresses = [f"127.0.0.1:{p}" for p in node_ports]
        master_addr = f"127.0.0.1:{master_p}"
        monitor_port = cfg.monitor_port or monitor_p

        # keygen -> registry CSV (localhost.go:79-92)
        records = simkeys.generate_nodes(scheme, addresses)
        registry_path = os.path.join(self.dir, f"registry_{run_index}.csv")
        simkeys.write_registry_csv(registry_path, records)

        # allocation (localhost.go:82-120): offline nodes never launch
        alloc = new_allocator(cfg.allocator).allocate(
            run.nodes, 1, run.processes, run.failing
        )
        by_proc: dict[int, list[int]] = {}
        for nid, slot in alloc.items():
            if slot.active:
                by_proc.setdefault(slot.process, []).append(nid)
        active = sum(len(v) for v in by_proc.values())

        # master services. Declared keys pin the CSV schema: a degraded run
        # (every honest node timed out / adversarial-only reporters) emits
        # NaN columns with a warning instead of silently narrowing the CSV
        # the plots are keyed on (sim/monitor.py Stats.declare).
        monitor = Monitor(
            monitor_port,
            expected_keys=("sigen_wall", "sigs_sigCheckedCt", "net_sentPackets"),
        )
        await monitor.start()
        sync = SyncMaster(int(master_addr.rsplit(":", 1)[1]), active)
        await sync.start()

        # span tracing: each node process dumps its flight recorder into the
        # run's trace dir; `python -m handel_tpu_torch.sim trace <dir>`
        # analyzes it
        trace_dir = ""
        if cfg.trace:
            trace_dir = os.path.join(self.dir, f"trace_{run_index}")
            os.makedirs(trace_dir, exist_ok=True)

        # live telemetry: one /metrics endpoint per node process, plan
        # written to the run dir BEFORE spawning so a scraper can attach
        # from the first scrape
        metrics_ports = metrics_port_plan(cfg, run.nodes, len(by_proc))
        metrics_by_proc: dict[int, int] = {}
        if metrics_ports:
            if cfg.base_port:
                preflight_ports(metrics_ports)
            metrics_by_proc = dict(
                zip((p for p, _ in sorted(by_proc.items())), metrics_ports)
            )
            write_metrics_ports(self.dir, run_index, metrics_by_proc)

        procs = []
        try:
            for pidx, ids in sorted(by_proc.items()):
                cmd = [
                    sys.executable,
                    "-m",
                    "handel_tpu_torch.sim.node",
                    "--config",
                    self.config_path,
                    "--registry",
                    registry_path,
                    "--master",
                    master_addr,
                    "--monitor",
                    f"127.0.0.1:{monitor_port}",
                    "--run",
                    str(run_index),
                    "--ids",
                    ",".join(map(str, ids)),
                ]
                if trace_dir:
                    cmd += ["--trace-dir", trace_dir]
                if pidx in metrics_by_proc:
                    cmd += ["--metrics-port", str(metrics_by_proc[pidx])]
                procs.append(
                    await asyncio.create_subprocess_exec(
                        *cmd,
                        stdout=asyncio.subprocess.PIPE,
                        stderr=asyncio.subprocess.PIPE,
                    )
                )

            comms = [asyncio.ensure_future(p.communicate()) for p in procs]
            timed_out = not await self._barriers(sync, procs, comms)
            if timed_out:
                # a node died or stalled before signaling: kill the tree but
                # REAP the children and keep their output — the only
                # diagnostics a multi-process stall leaves behind
                for p in procs:
                    if p.returncode is None:
                        p.kill()
            outs = await asyncio.gather(*comms)
            rcs = [p.returncode for p in procs]
        finally:
            for p in procs:
                if p.returncode is None:
                    p.kill()
            sync.stop()
            monitor.stop()

        keep_node_outputs(self.dir, run_index, sorted(by_proc), outs)

        # stats CSV (localhost.go:201-206)
        monitor.stats.extra = run.stats_extra(run_index)
        csv_path = os.path.join(self.dir, f"results_{run_index}.csv")
        monitor.stats.write_csv(csv_path)
        ok = (
            not timed_out
            and all(rc == 0 for rc in rcs)
            and all(b"finished OK" in out for out, _ in outs)
        )
        return RunResult(
            ok=ok,
            csv_path=csv_path,
            outputs=outs,
            returncodes=rcs,
            trace_dir=trace_dir,
        )

    async def _barriers(self, sync, procs, comms) -> bool:
        """Wait for the START and END barriers. False when one times out, or
        when a node process exits non-zero before the END barrier."""

        async def both():
            await sync.wait_all(STATE_START, self.cfg.max_timeout_s)
            await sync.wait_all(STATE_END, self.cfg.max_timeout_s)

        async def a_node_failed():
            for fut in asyncio.as_completed(comms):
                await fut
                if any(p.returncode not in (None, 0) for p in procs):
                    return
            await asyncio.Event().wait()  # all exited 0: the barriers decide

        barriers = asyncio.ensure_future(both())
        failed = asyncio.ensure_future(a_node_failed())
        try:
            done, _ = await asyncio.wait(
                {barriers, failed}, return_when=asyncio.FIRST_COMPLETED
            )
        finally:
            barriers.cancel()
            failed.cancel()
        return barriers in done and barriers.exception() is None


class RunResult:
    def __init__(self, ok, csv_path, outputs, returncodes, trace_dir=""):
        self.ok = ok
        self.csv_path = csv_path
        self.outputs = outputs
        self.returncodes = returncodes
        self.trace_dir = trace_dir


def new_platform(name: str, cfg: SimConfig, workdir: str):
    """Platform dispatch (simul/platform/platform.go:59 NewPlatform)."""
    if name == "localhost":
        return LocalhostPlatform(cfg, workdir)
    if name == "remote":
        from handel_tpu_torch.sim.remote import RemotePlatform

        return RemotePlatform(cfg, workdir)
    raise ValueError(f"unknown platform {name!r} (available: localhost, remote)")


async def run_simulation(
    cfg: SimConfig, workdir: str, platform: str = "localhost"
) -> list[RunResult]:
    """Orchestrator: run every RunConfig sequentially (simul/main.go:24-68)."""
    plat = new_platform(platform, cfg, workdir)
    results = []
    for i in range(len(cfg.runs)):
        res = None
        for attempt in range(cfg.retrials):
            try:
                res = await plat.start_run(i)
            except asyncio.TimeoutError:
                # barrier never released (a node died before signaling):
                # that's exactly what retrials exist for (config.go Retrials)
                res = RunResult(
                    ok=False, csv_path="", outputs=[], returncodes=[]
                )
            if res.ok:
                break
        results.append(res)
    return results
