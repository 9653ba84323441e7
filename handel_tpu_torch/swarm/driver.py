"""Swarm driver: thousands of virtual nodes per process, one committee — a
copy of handel_tpu/swarm/driver.py.

The orchestration layer. `SwarmHost` owns one process's
contiguous ID block: a shared fake registry, ONE `TimerWheel`, ONE
`SwarmRouter`, ONE `BatchVerifierService` over a paged host device, and a
`VirtualNode` per local identity. `run_swarm` is the `sim swarm` entry —
processes = 1 runs the whole committee inline (tests, smoke), otherwise M
worker processes (swarm/worker.py) each run their block behind a UDP sync
barrier and the parent merges their summaries, traces and rollups into
`<workdir>/swarm_summary.json`.

Completion is observed, not awaited: a per-vnode `final_signatures.get()`
would be one more task per vnode, so a single wheel callback scans the
block every `SCAN_PERIOD_S` and stamps first-threshold times at scan
granularity (the trace's `threshold_reached` instants carry exact stamps
for the critical-path report).
"""

from __future__ import annotations

import asyncio
import json
import os
import random
import sys
import time

from handel_tpu_torch.core.config import (
    DEFAULT_CONTRIBUTIONS_PERC,
    percentage_to_contributions,
)
from handel_tpu_torch.core.identity import ArrayRegistry, Identity
from handel_tpu_torch.core.timeout import TimerWheel
from handel_tpu_torch.core.trace import FlightRecorder
from handel_tpu_torch.parallel.batch_verifier import BatchVerifierService
from handel_tpu_torch.service.driver import HostDevice, _split
from handel_tpu_torch.swarm.mem import deep_size, process_rss_bytes
from handel_tpu_torch.swarm.pager import PagedDevice, RegistryPager
from handel_tpu_torch.swarm.router import SwarmRouter
from handel_tpu_torch.swarm.vnode import VirtualNode, build_vnode

SCAN_PERIOD_S = 0.25
MEM_SAMPLE_VNODES = 16


def fake_committee(n: int):
    """One shared registry + per-identity secrets for the whole committee.

    Identity/pubkey objects are built ONCE and shared by every co-resident
    vnode (the registry is most of what `deep_size` excludes as shared)."""
    from handel_tpu_torch.models.fake import FakePublic, FakeSecret

    idents = [Identity(i, f"swarm-{i}", FakePublic(True)) for i in range(n)]
    secrets = [FakeSecret(i) for i in range(n)]
    return ArrayRegistry(idents), secrets


class SwarmHost:
    """One process's share of the committee: vnodes for ids [lo, hi)."""

    def __init__(
        self,
        total: int,
        lo: int,
        hi: int,
        *,
        threshold: int = 0,
        msg: bytes = b"swarm",
        update_period: float = 2.0,
        level_timeout: float = 0.050,
        fast_path: int = 3,
        tick_s: float = 0.010,
        batch_size: int = 64,
        max_pending: int = 256,
        chunk_bits: int = 12,
        page_budget: int = 64,
        block: int = 0,
        ports=None,
        proc_index: int = 0,
        trace: bool = False,
        trace_capacity: int = 1 << 16,
        rollup_top_k: int = 8,
    ):
        self.total = total
        self.lo, self.hi = lo, hi
        self.msg = msg
        self.update_period = update_period
        self.fast_path = fast_path
        self._level_timeout = level_timeout
        self._max_pending = max_pending
        self.proc_index = proc_index
        self.ports = list(ports or [])
        self.threshold = threshold or percentage_to_contributions(
            DEFAULT_CONTRIBUTIONS_PERC, total
        )

        from handel_tpu_torch.models.fake import FakeConstructor

        self.registry, self._secrets = fake_committee(total)
        self.registry.public_keys()  # build the shared cache once, up front
        self.constructor = FakeConstructor()
        self.wheel = TimerWheel(tick_s=tick_s)
        self.router = SwarmRouter(block or total, ports=self.ports)
        self.pager = RegistryPager(
            chunk_bits=chunk_bits, budget_chunks=page_budget
        )
        self.device = PagedDevice(
            HostDevice(self.constructor, batch_size=batch_size), self.pager
        )
        self.recorder = (
            FlightRecorder(capacity=trace_capacity, pid=proc_index)
            if trace
            else None
        )
        self.service = BatchVerifierService(
            self.device, recorder=self.recorder
        )
        # one Mersenne state for the whole block (vnode.py: with shuffling
        # disabled nothing draws from it, and 65k defaults would be ~160 MB)
        self._rand = random.Random(proc_index)
        self.vnodes: list[VirtualNode] = []
        self._all_done = asyncio.Event()
        self._completed = 0
        self._wall_s = 0.0
        self._scan_handle = None
        self.host_rollup = self._build_host_rollup(rollup_top_k)

    def _build_host_rollup(self, top_k: int):
        """O(key-union) digest over this block's O(N) vnode surfaces
        (obs/rollup.py): the master sees one bounded digest per process,
        never a reporter row per identity. The local DetectorBank rides
        the _scan cadence so the digest's top-K carries real z-scores."""
        from handel_tpu_torch.obs.detect import counter_rate
        from handel_tpu_torch.obs.rollup import HostRollup

        hr = HostRollup(f"proc{self.proc_index}", top_k=top_k)

        def vnode_fold():
            gk = (
                frozenset(self.vnodes[0].handel.gauge_keys())
                if self.vnodes else frozenset()
            )
            return ((v.handel.values(), gk) for v in self.vnodes)

        hr.attach_fold("swarm", vnode_fold)
        hr.attach_reporter("router", self.router)
        hr.attach_reporter("wheel", self.wheel)
        hr.attach_reporter("pager", self.pager)
        hr.attach_fold("service", lambda: [({
            "launchesCt": float(self.service.launches),
            "candidatesCt": float(self.service.candidates),
            "dedupHitsCt": float(self.service.cache.hits),
            "completedSize": float(self._completed),
        }, frozenset({"completedSize"}))])
        if self.recorder is not None:
            hr.set_trace(lambda: self.recorder.export()["traceEvents"])
        hr.watch("swarm-completed", lambda: float(self._completed))
        hr.watch("swarm-udp-rate", counter_rate(
            lambda: self.router.values().get("swarmUdpSent")
        ))
        hr.watch("swarm-launch-rate", counter_rate(
            lambda: float(self.service.launches)
        ))
        return hr

    # -- build / lifecycle -------------------------------------------------

    def build(self) -> None:
        """Instantiate the block's vnodes (registers their listeners — call
        before the start barrier so early packets find a recipient)."""
        for nid in range(self.lo, self.hi):
            self.vnodes.append(
                build_vnode(
                    self.registry.identity(nid),
                    self._secrets[nid],
                    self.registry,
                    self.constructor,
                    self.msg,
                    self.router,
                    self.wheel,
                    self.service,
                    threshold=self.threshold,
                    update_period=self.update_period,
                    level_timeout=self._level_timeout,
                    fast_path=self.fast_path,
                    shared_rand=self._rand,
                    batch_size=self.device.batch_size,
                    max_pending=self._max_pending,
                    recorder=self.recorder,
                )
            )

    async def run(self, timeout: float = 120.0, *, teardown: bool = True) -> dict:
        """Start everything, wait until every local vnode holds a threshold
        signature (or the deadline), tear down, and return the summary.

        Workers pass teardown=False: a finished block must keep its router,
        wheel, and vnodes serving until EVERY block is done (the END
        barrier), or other blocks' unfinished vnodes lose their only source
        of this block's contributions mid-wave."""
        t0 = time.perf_counter()
        if len(self.ports) > 1 and self.router._transport is None:
            # the worker binds before the start barrier; this path is for
            # hosts driven directly (tests) that skipped that step
            await self.router.open(self.ports[self.proc_index])
        if not self.vnodes:
            self.build()
        self.wheel.start()
        n = len(self.vnodes)
        stagger = min(self.update_period, 1.0)
        for i, v in enumerate(self.vnodes):
            # phase-stagger the gossip rounds so a block's periodic burst
            # spreads over many wheel ticks — but cap the spread: with the
            # sparse-gossip default period the stagger would otherwise delay
            # the last vnode's START (and the whole wave) by seconds
            v.start(self.wheel, phase_s=(i / n) * stagger)
        self._scan_handle = self.wheel.schedule_periodic(
            SCAN_PERIOD_S, self._scan
        )
        try:
            await asyncio.wait_for(self._all_done.wait(), timeout)
        except asyncio.TimeoutError:
            pass  # partial completion is a reportable outcome, not a crash
        self._wall_s = time.perf_counter() - t0
        self._scan()  # final stamp pass before teardown
        if teardown:
            self.stop()
        return self.summary()

    def _scan(self) -> None:
        done = 0
        now = time.monotonic()
        for v in self.vnodes:
            if v.done_ts:
                done += 1
            elif v.reached_threshold:
                v.done_ts = now
                done += 1
        self._completed = done
        self.host_rollup.tick()
        if done == len(self.vnodes):
            self._all_done.set()

    def stop(self) -> None:
        if self._scan_handle is not None:
            self._scan_handle.cancel()
        for v in self.vnodes:
            v.stop()
        self.wheel.stop()
        self.service.stop()
        self.router.close()

    # -- reporting ---------------------------------------------------------

    def _ttt(self) -> list[float]:
        return sorted(
            v.time_to_threshold() for v in self.vnodes if v.done_ts
        )

    def _mem_sample(self) -> tuple[float, int]:
        """Mean deep-walk bytes over a sample of vnodes, excluding the
        structures shared across the block (mem.py docstring)."""
        if not self.vnodes:
            return 0.0, 0
        shared = [
            self.registry,
            self._secrets,
            self.constructor,
            self.wheel,
            self.router,
            self.service,
            self.device,
            self.msg,
            self._rand,
        ]
        if self.recorder is not None:
            shared.append(self.recorder)
        step = max(1, len(self.vnodes) // MEM_SAMPLE_VNODES)
        sample = self.vnodes[::step][:MEM_SAMPLE_VNODES]
        total = sum(deep_size(v, shared=shared) for v in sample)
        return total / len(sample), len(sample)

    def summary(self) -> dict:
        ttt = self._ttt()

        def q(p: float) -> float:
            return ttt[min(len(ttt) - 1, int(p * len(ttt)))] if ttt else 0.0

        vnode_bytes, sample_n = self._mem_sample()
        stale = sum(
            getattr(v.handel.store, "stale_retired_ct", 0)
            for v in self.vnodes
        )
        retired = sum(
            len(getattr(v.handel.store, "retired", ()))
            for v in self.vnodes
        )
        return {
            "proc_index": self.proc_index,
            "identities": len(self.vnodes),
            "completed": self._completed,
            "threshold": self.threshold,
            "wall_s": round(self._wall_s, 3),
            "ttt_p50_s": round(q(0.50), 4),
            "ttt_p90_s": round(q(0.90), 4),
            "ttt_max_s": round(ttt[-1] if ttt else 0.0, 4),
            "rss_bytes": process_rss_bytes(),
            "vnode_bytes_mean": round(vnode_bytes, 1),
            "vnode_bytes_sample_n": sample_n,
            "stale_retired_ct": stale,
            "retired_level_ct": retired,
            "verifier_launches": self.service.launches,
            "verifier_candidates": self.service.candidates,
            "dedup_hits": self.service.cache.hits,
            **self.router.values(),
            **self.wheel.values(),
            **self.pager.values(),
        }

    def rollup(self, top_k: int = 16) -> dict:
        """Per-process hierarchical rollup of the block's vnode reporters
        (sim/monitor.py Rollup): fleet counters once, not 65k CSV rows."""
        from handel_tpu_torch.sim.monitor import Rollup

        r = Rollup(top_k=top_k)
        gauge_keys = (
            self.vnodes[0].handel.gauge_keys() if self.vnodes else set()
        )
        for v in self.vnodes:
            r.add(
                v.id,
                v.handel.values(),
                gauge_keys=gauge_keys,
                slow_value=v.time_to_threshold(),
            )
        return r.record()


def merge_summaries(parts: list[dict]) -> dict:
    """Fleet record from per-process summaries. The three bench-gated
    metrics (the JAX package's scripts/bench_check.py SIDE_METRICS): `swarm_identities`
    (scale proof, higher is better), `mem_bytes_per_identity` (summed RSS
    over the committee — the extrapolation basis), and
    `swarm_time_to_threshold_s` (wall until the LAST member held a
    threshold signature — the whole-committee completion wave)."""
    identities = sum(p["identities"] for p in parts)
    rss = sum(p["rss_bytes"] for p in parts)
    out = {
        "swarm_identities": identities,
        "processes": len(parts),
        "completed": sum(p["completed"] for p in parts),
        "threshold": parts[0]["threshold"] if parts else 0,
        "wall_s": max((p["wall_s"] for p in parts), default=0.0),
        "swarm_time_to_threshold_s": max(
            (p["ttt_max_s"] for p in parts), default=0.0
        ),
        "ttt_p50_s": max((p["ttt_p50_s"] for p in parts), default=0.0),
        "ttt_p90_s": max((p["ttt_p90_s"] for p in parts), default=0.0),
        "rss_bytes_total": rss,
        "mem_bytes_per_identity": round(rss / identities, 1)
        if identities
        else 0.0,
        "vnode_bytes_mean": max(
            (p["vnode_bytes_mean"] for p in parts), default=0.0
        ),
        "stale_retired_ct": sum(p["stale_retired_ct"] for p in parts),
        "retired_level_ct": sum(p["retired_level_ct"] for p in parts),
        "verifier_launches": sum(p["verifier_launches"] for p in parts),
        "verifier_candidates": sum(p["verifier_candidates"] for p in parts),
        "dedup_hits": sum(p["dedup_hits"] for p in parts),
        "udp_sent": sum(p["swarmUdpSent"] for p in parts),
        "local_delivered": sum(p["swarmLocalDelivered"] for p in parts),
        "pages_committed": sum(p["pagesCommitted"] for p in parts),
        "page_hits": sum(p["pageHits"] for p in parts),
    }
    out["ok"] = out["completed"] == out["swarm_identities"]
    return out


def host_from_params(
    p, lo: int, hi: int, *, block: int, ports, proc_index: int,
    trace: bool, trace_capacity: int, rollup_top_k: int = 8,
) -> SwarmHost:
    """Build one SwarmHost from a SwarmParams section (sim/config.py)."""
    host = SwarmHost(
        p.identities,
        lo,
        hi,
        threshold=p.threshold,
        update_period=p.period_ms / 1000.0,
        level_timeout=p.timeout_ms / 1000.0,
        fast_path=p.fast_path,
        tick_s=p.tick_ms / 1000.0,
        batch_size=p.batch_size,
        max_pending=p.max_pending,
        chunk_bits=p.chunk_bits,
        page_budget=p.page_budget,
        block=block,
        ports=ports,
        proc_index=proc_index,
        trace=trace,
        trace_capacity=trace_capacity,
        rollup_top_k=rollup_top_k,
    )
    return host


def _merge_host_digests(cfg, workdir: str, parts: list[dict]) -> dict:
    """Master-side FleetRollup over the per-process host digests: the
    O(hosts) summary keys plus fleet_rollup.json for `sim watch` / CI.
    Missing digest files degrade to an empty block, never a failure."""
    from handel_tpu_torch.obs.rollup import FleetRollup

    al = getattr(cfg, "alerts", None)
    fleet = FleetRollup(
        top_k=al.rollup_top_k if al is not None else 8,
        stale_after_s=al.rollup_stale_s if al is not None else 5.0,
    )
    hosts = 0
    for i in range(len(parts)):
        path = os.path.join(workdir, f"host_digest_{i}.json")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            fleet.ingest_digest(json.load(f))
        hosts += 1
    if not hosts:
        return {}
    merged = fleet.merged()
    wall = max((float(p.get("wall_s", 0.0)) for p in parts), default=0.0)
    bytes_per_host = sum(
        float(p.get("rollup_bytes", 0.0)) for p in parts
    ) / hosts
    out = {
        "fleet_hosts": hosts,
        "fleet_series_count": merged["series"],
        "rollup_bytes_per_host_s": round(
            bytes_per_host / wall if wall else 0.0, 1
        ),
        "fleet_eval_ms": round(fleet.last_merge_ms, 3),
    }
    with open(os.path.join(workdir, "fleet_rollup.json"), "w") as f:
        json.dump({**out, "fleet": fleet.fleet_payload()}, f, indent=1)
        f.write("\n")
    return out


async def run_swarm(cfg, workdir: str, config_path: str = "") -> dict:
    """The `sim swarm` orchestrator: one committee over M processes."""
    from handel_tpu_torch.sim.config import dump_config

    p = cfg.swarm
    if not p.enabled():
        raise ValueError("no [swarm] section (swarm.identities must be > 0)")
    os.makedirs(workdir, exist_ok=True)
    timeout = p.timeout_s or cfg.max_timeout_s
    procs_n = max(1, p.processes)
    shares = _split(p.identities, procs_n)
    block = shares[0]  # contiguous blocks; the first ones carry the remainder
    bounds = []
    lo = 0
    for share in shares:
        bounds.append((lo, lo + share))
        lo += share

    al = getattr(cfg, "alerts", None)
    rollup_top_k = al.rollup_top_k if al is not None else 8
    trace_paths: list[str] = []
    if procs_n == 1:
        host = host_from_params(
            p, 0, p.identities, block=block, ports=[], proc_index=0,
            trace=cfg.trace, trace_capacity=cfg.trace_capacity,
            rollup_top_k=rollup_top_k,
        )
        part = await host.run(timeout)
        with open(os.path.join(workdir, "swarm_rollup_0.json"), "w") as f:
            json.dump(host.rollup(), f)
        digest = host.host_rollup.digest()
        part["rollup_bytes"] = host.host_rollup.emit()
        with open(os.path.join(workdir, "host_digest_0.json"), "w") as f:
            json.dump(digest, f)
        if host.recorder is not None:
            trace_paths.append(
                host.recorder.dump(
                    os.path.join(workdir, "swarm_trace_0.json")
                )
            )
        parts = [part]
    else:
        if not config_path:
            config_path = os.path.join(workdir, "swarm.toml")
            with open(config_path, "w") as f:
                f.write(dump_config(cfg))
        from handel_tpu_torch.sim.platform import free_ports
        from handel_tpu_torch.sim.sync import STATE_START, SyncMaster

        ports = free_ports(procs_n + 1)
        sync_port, swarm_ports = ports[0], ports[1:]
        with open(os.path.join(workdir, "swarm_ports.json"), "w") as f:
            json.dump({"sync": sync_port, "swarm": swarm_ports}, f)
        master = SyncMaster(sync_port, procs_n)
        await master.start()
        workers = []
        for i in range(procs_n):
            cmd = [
                sys.executable,
                "-m",
                "handel_tpu_torch.swarm.worker",
                "--config",
                config_path,
                "--index",
                str(i),
                "--workdir",
                workdir,
            ]
            workers.append(
                await asyncio.create_subprocess_exec(
                    *cmd,
                    stdout=asyncio.subprocess.PIPE,
                    stderr=asyncio.subprocess.PIPE,
                )
            )
        try:
            # every worker binds + builds before any starts gossiping
            await master.wait_all(STATE_START, timeout=timeout)
            outs = await asyncio.wait_for(
                asyncio.gather(*(w.communicate() for w in workers)),
                # build + run + teardown; generous vs the run deadline
                timeout=timeout * 2 + 120,
            )
        finally:
            master.stop()
            for w in workers:
                if w.returncode is None:
                    w.kill()
        parts = []
        for i, (w, (out, err)) in enumerate(zip(workers, outs)):
            if w.returncode != 0:
                sys.stderr.write(err.decode(errors="replace"))
                raise RuntimeError(f"swarm worker {i} failed (rc={w.returncode})")
            for line in out.decode().splitlines():
                if line.startswith("SWARM_RESULT "):
                    parts.append(json.loads(line[len("SWARM_RESULT "):]))
            tp = os.path.join(workdir, f"swarm_trace_{i}.json")
            if os.path.exists(tp):
                trace_paths.append(tp)
        if len(parts) != procs_n:
            raise RuntimeError(
                f"{len(parts)}/{procs_n} swarm workers reported a summary"
            )

    summary = merge_summaries(parts)
    summary["per_process"] = parts
    summary.update(_merge_host_digests(cfg, workdir, parts))
    if trace_paths:
        # streamed critical-path + level-wave report over the per-process
        # trace files (sim/trace_cli.py; never loads all files at once)
        from handel_tpu_torch.sim.trace_cli import stream_report

        report = stream_report(trace_paths)
        with open(os.path.join(workdir, "swarm_trace_report.json"), "w") as f:
            json.dump(report, f, indent=1)
            f.write("\n")
        summary["trace_report"] = {
            k: report[k]
            for k in ("time_to_threshold_s", "level_wave", "critical_path_len")
            if k in report
        }
    with open(os.path.join(workdir, "swarm_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
        f.write("\n")
    return summary
