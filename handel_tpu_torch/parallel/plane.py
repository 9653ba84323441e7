"""Device plane: K device engines behind one verifier service — a copy of
handel_tpu/parallel/plane.py.

A `DevicePlane` owns K device engines (cards, or host-math engines for the
CPU tests) and gives each one a `DeviceLane`: its own dispatch hand-off
cell, in-flight fetch window, circuit breaker, and occupancy counters.
`BatchVerifierService` schedules launch groups onto lanes
least-loaded-first, so fetch latency on one card never idles the others; a
lane whose breaker opens simply stops receiving work until its cooldown
probe succeeds (degrade to K-1 cards, not to zero).

The plane is also the fleet's reporter surface: `values()` sums the
per-engine host pack/dispatch costs, and `labeled_values()` exposes one row
per device for a `device`-labeled metrics dimension beside `session`.

This module imports no torch at module level: the host-engine planes of the
protocol tests never touch a card. The BN254 builder (`bn254_plane`)
imports lazily. Each lane carries its flight-recorder thread id
(`trace_tid`) and the stamp of the group handed to it (`queued_ts`), which
the service's launch-lifecycle spans read (parallel/batch_verifier.py).
"""

from __future__ import annotations

import asyncio

from handel_tpu_torch.utils.breaker import CircuitBreaker

__all__ = ["DeviceLane", "DevicePlane", "bn254_plane", "host_plane"]

#: breaker state -> exposition value (shared with BatchVerifierService)
BREAKER_CODE = {"closed": 0.0, "half-open": 0.5, "open": 1.0}


class DeviceLane:
    """One chip of the plane: an engine plus everything the scheduler needs
    to route around it — hand-off cell, in-flight window, breaker, and
    per-device counters. The asyncio queues are created by the service at
    start() (they must bind to its event loop) and torn down at stop().

    `dispatching` holds the launch group from the moment the scheduler
    hands it to this lane until its handle reaches `fetch_q` (or it fails
    over): while set, the lane's dispatch slot is occupied AND stop() can
    fail the group's futures. `fetching` mirrors it for the fetch stage.
    """

    __slots__ = (
        "index", "engine", "breaker", "q", "fetch_q", "dispatching",
        "fetching", "launches", "candidates", "fill_sum", "last_fill",
        "retries", "fetched", "queued_ts", "draining", "tasks", "mesh",
    )

    def __init__(self, index: int, engine, breaker: CircuitBreaker | None = None,
                 mesh: bool = False):
        self.index = index
        self.engine = engine
        self.breaker = breaker or CircuitBreaker()
        # latency plane (parallel/mesh_plane.py): a mesh lane's engine
        # spans the WHOLE device mesh for one launch. pick() skips it —
        # only latency-mode groups routed via pick_mesh() land here.
        self.mesh = mesh
        self.q: asyncio.Queue | None = None
        self.fetch_q: asyncio.Queue | None = None
        self.dispatching: list | None = None
        self.fetching: list | None = None
        self.launches = 0
        self.candidates = 0
        self.fill_sum = 0.0
        self.last_fill = 0.0
        self.retries = 0
        self.fetched = 0
        # trace stamp: when the launch group currently in `q` was handed to
        # this lane (the launch_queued span's start, batch_verifier.py)
        self.queued_ts = 0.0
        # elasticity (the reference's lifecycle/autoscaler.py): a draining
        # lane finishes its in-flight launches but the scheduler stops
        # routing to it — the graceful half of drain_lane/remove_lane
        self.draining = False
        # the lane's dispatcher/fetcher task pair while the service runs
        # (BatchVerifierService start()/attach_lane(); drain cancels them)
        self.tasks: tuple = ()

    @property
    def trace_tid(self) -> int:
        """Chrome-trace thread id for this lane's launch-lifecycle spans:
        negative ids keep lanes clear of node tids, below SERVICE_TID."""
        return -(2 + self.index)

    def free(self) -> bool:
        """Can accept a launch group right now (dispatch slot empty)."""
        return self.dispatching is None

    def inflight(self) -> int:
        """Launches dispatched to the device whose verdicts haven't landed."""
        n = 1 if self.fetching is not None else 0
        if self.fetch_q is not None:
            n += self.fetch_q.qsize()
        return n

    def load(self) -> int:
        """Launches this lane is responsible for right now — the scheduling
        key: queued/dispatching + awaiting fetch."""
        return (1 if self.dispatching is not None else 0) + self.inflight()

    def values(self) -> dict[str, float]:
        """One `device`-labeled metrics row."""
        st = getattr(self.engine, "rlc_stats", None)
        return {
            # scheduling mode of this row: 1 = whole-mesh latency lane,
            # 0 = per-chip throughput lane (`sim watch` mode column)
            "mode": 1.0 if self.mesh else 0.0,
            # batch-check mode of the engine (models/rlc.py): 1 = rlc
            # combined check, 0 = per-candidate (`sim watch` check column)
            "checkMode": (
                1.0 if getattr(self.engine, "batch_check", "per_candidate")
                == "rlc" else 0.0
            ),
            # RLC plane: top-level combined checks, post-failure bisection
            # rechecks, deepest recheck level this engine ever reached
            "rlcLaunches": float(st.rlc_launches) if st else 0.0,
            "bisectionCt": float(st.bisection_ct) if st else 0.0,
            "bisectionDepthMax": float(st.bisection_depth_max) if st else 0.0,
            "launches": float(self.launches),
            "candidates": float(self.candidates),
            "fillRatio": (
                self.fill_sum / self.launches if self.launches else 0.0
            ),
            "lastFill": self.last_fill,
            "inflight": float(self.inflight()),
            "load": float(self.load()),
            "retries": float(self.retries),
            "breakerState": BREAKER_CODE[self.breaker.state],
            "breakerOpenCt": float(self.breaker.open_count),
        }


class DevicePlane:
    """K `DeviceLane`s and the least-loaded-first pick over them.

    `pick()` returns the least-loaded FREE lane among those whose breaker
    admits work, or None when every admissible lane is occupied (the
    caller waits) — so an idle chip is always preferred over queueing
    behind a busy one. `sched_picks`/`idle_violations` audit exactly the
    acceptance property "no device idles while another has ≥ 2 queued
    launches": a violation is counted iff an idle admissible lane existed,
    some lane carried ≥ 2 launches, and the pick was NOT idle — impossible
    under min-load, so the bench asserts the counter stays 0.
    """

    def __init__(self, engines, breakers=None):
        engines = list(engines)
        if not engines:
            raise ValueError("DevicePlane needs at least one device engine")
        if breakers is not None and len(breakers) != len(engines):
            raise ValueError("breakers must match engines 1:1")
        self.lanes = [
            DeviceLane(i, eng, breakers[i] if breakers else None)
            for i, eng in enumerate(engines)
        ]
        self.sched_picks = 0
        self.idle_violations = 0
        # elasticity counters (the reference's lifecycle/autoscaler.py) +
        # a monotonically increasing index source so a replacement lane
        # never reuses a retired lane's metrics row
        self._next_index = len(self.lanes)
        self.lanes_added = 0
        self.lanes_removed = 0
        # dual-mode scheduling audit (parallel/mesh_plane.py): latency-mode
        # picks taken off the mesh lane(s)
        self.mesh_picks = 0

    def __len__(self) -> int:
        return len(self.lanes)

    @property
    def batch_size(self) -> int:
        # the THROUGHPUT batch width: a mesh lane's engine is typically a
        # small-batch shape and must not set the collector's drain size
        for l in self.lanes:
            if not l.mesh:
                return l.engine.batch_size
        return self.lanes[0].engine.batch_size

    def add_lane(self, engine, breaker: CircuitBreaker | None = None,
                 mesh: bool = False) -> DeviceLane:
        """Grow the plane by one lane (verify-plane elasticity, or a
        latency-plane mesh lane when `mesh=True`). The caller
        (BatchVerifierService.attach_lane) wires the asyncio plumbing; a
        bare plane user just gets a new schedulable lane."""
        lane = DeviceLane(self._next_index, engine, breaker, mesh=mesh)
        self._next_index += 1
        self.lanes.append(lane)
        self.lanes_added += 1
        return lane

    def remove_lane(self, lane: DeviceLane) -> None:
        """Retire one lane. The last lane is irremovable — a plane with no
        engine cannot serve, and `batch_size`/`device` aliases would
        dangle. Likewise the last THROUGHPUT lane while mesh lanes remain:
        bulk groups don't fit a small-batch mesh engine, so a mesh-only
        plane (unless built that way outright) cannot serve them."""
        others = [l for l in self.lanes if l is not lane]
        if not others:
            raise ValueError("cannot remove the last lane of a DevicePlane")
        if not lane.mesh and all(l.mesh for l in others):
            raise ValueError(
                "cannot remove the last throughput lane of a DevicePlane"
            )
        self.lanes.remove(lane)
        self.lanes_removed += 1

    def allowed(self) -> list[DeviceLane]:
        """Lanes whose breaker currently admits launches (a draining lane
        admits nothing — it only finishes what it already carries)."""
        return [l for l in self.lanes if not l.draining and l.breaker.allow()]

    def throughput_pool(self) -> list[DeviceLane]:
        """Admissible lanes a THROUGHPUT pick may return: the non-mesh
        lanes. A plane built purely of mesh lanes (degenerate, but must not
        deadlock the collector) falls back to the whole admissible set —
        there a "bulk" group is whatever fits the mesh engine."""
        allowed = self.allowed()
        if any(not l.mesh for l in self.lanes):
            return [l for l in allowed if not l.mesh]
        return allowed

    def mesh_lanes(self) -> list[DeviceLane]:
        return [l for l in self.lanes if l.mesh]

    def pick(self) -> DeviceLane | None:
        """Least-loaded free admissible THROUGHPUT lane; None when none is
        free. Mesh lanes are never returned here — only latency-mode
        groups, routed via `pick_mesh`, may occupy the whole mesh."""
        pool = self.throughput_pool()
        free = [l for l in pool if l.free()]
        if not free:
            return None
        lane = min(free, key=lambda l: (l.load(), l.index))
        self.sched_picks += 1
        if (
            lane.load() > 0
            and any(l.load() == 0 for l in pool)
            and any(l.load() >= 2 for l in self.lanes if not l.mesh)
        ):
            self.idle_violations += 1
        return lane

    def pick_mesh(self) -> DeviceLane | None:
        """Free admissible mesh lane for a latency-mode group (least-loaded
        when several), or None — the caller falls back to the throughput
        path and counts a mesh fallback. A mesh lane whose breaker is open
        simply makes latency mode unavailable; it never fails the group."""
        free = [
            l for l in self.mesh_lanes()
            if not l.draining and l.breaker.allow() and l.free()
        ]
        if not free:
            return None
        lane = min(free, key=lambda l: (l.load(), l.index))
        self.mesh_picks += 1
        return lane

    def inflight_launches(self) -> int:
        return sum(l.inflight() for l in self.lanes)

    def host_cost(self) -> dict[str, float]:
        """Per-launch host accounting SUMMED over the fleet's engines (the
        service used to read the counters off device 0 only)."""
        out = {"pack_ms": 0.0, "pack_launches": 0.0,
               "dispatch_ms": 0.0, "dispatch_launches": 0.0}
        for lane in self.lanes:
            eng = lane.engine
            out["pack_ms"] += float(getattr(eng, "host_pack_ms", 0.0))
            out["pack_launches"] += float(
                getattr(eng, "host_pack_launches", 0)
            )
            out["dispatch_ms"] += float(
                getattr(eng, "host_dispatch_ms", 0.0)
            )
            out["dispatch_launches"] += float(
                getattr(eng, "host_dispatch_launches", 0)
            )
        return out

    def values(self) -> dict[str, float]:
        """Fleet aggregates (folded into the service's values())."""
        mesh = self.mesh_lanes()
        stats = [
            st for l in self.lanes
            if (st := getattr(l.engine, "rlc_stats", None)) is not None
        ]
        return {
            # RLC batch-check plane (models/rlc.py): counters SUM over the
            # fleet, the depth high-water mark is a MAX (a per-engine
            # maximum summed across lanes would mean nothing)
            "rlcLaunches": float(sum(s.rlc_launches for s in stats)),
            "bisectionCt": float(sum(s.bisection_ct for s in stats)),
            "bisectionDepthMax": float(max(
                (s.bisection_depth_max for s in stats), default=0
            )),
            "checkMode": (
                1.0 if any(
                    getattr(l.engine, "batch_check", "per_candidate") == "rlc"
                    for l in self.lanes
                ) else 0.0
            ),
            "devicesTotal": float(len(self.lanes)),
            "devicesAvailable": float(len(self.allowed())),
            "schedPicks": float(self.sched_picks),
            "schedIdleViolations": float(self.idle_violations),
            "lanesAdded": float(self.lanes_added),
            "lanesRemoved": float(self.lanes_removed),
            # latency plane (parallel/mesh_plane.py): mesh lane census +
            # the launches that actually rode the whole mesh
            "meshLanes": float(len(mesh)),
            "meshLanesAvailable": float(sum(
                1 for l in mesh if not l.draining and l.breaker.allow()
            )),
            "meshPicks": float(self.mesh_picks),
            "meshLaunches": float(sum(l.launches for l in mesh)),
        }

    def labeled_values(self) -> dict[str, dict[str, float]]:
        """Per-device rows for the `device` label dimension
        (core/metrics.py register_labeled_values(label="device"))."""
        return {str(l.index): l.values() for l in self.lanes}

    def labeled_gauge_keys(self) -> set[str]:
        return {
            "fillRatio", "lastFill", "inflight", "load", "breakerState",
            "mode",
        }


def host_plane(constructor, devices: int, batch_size: int = 64,
               launch_ms: float = 0.0,
               batch_check: str = "per_candidate") -> DevicePlane:
    """A plane of K host-math engines (service/driver.py HostDevice) — the
    CPU test shape: real scheduling + breakers, no kernels."""
    from handel_tpu_torch.service.driver import HostDevice

    return DevicePlane([
        HostDevice(constructor, batch_size=batch_size, launch_ms=launch_ms,
                   batch_check=batch_check)
        for _ in range(max(1, devices))
    ])


def bn254_plane(registry_pubkeys, devices: int, batch_size: int = 16,
                placement=None, warmup: bool = True) -> DevicePlane:
    """A plane of K BN254 engines, one on each of the cards cuda:0 ..
    cuda:K-1, or on each device of `placement` (a list of K devices that
    may repeat one, e.g. `["cpu"] * 8` for a CPU rehearsal), the engines of
    a device sharing one `BN254Curves`. Each engine commits the registry to
    its device once and, with `warmup`, builds its first-use state (the
    kernel library, the prefix table, the combine classes) before the plane
    is returned, as a service over it needs (models/bn254_torch.py).
    Raises when fewer than K cards are visible."""
    import torch

    from handel_tpu_torch.models.bn254_torch import BN254Device
    from handel_tpu_torch.ops.curve import BN254Curves
    from handel_tpu_torch.utils.torchenv import resolve_device

    k = max(1, devices)
    if placement is None:
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if k > visible:
            raise ValueError(f"requested {k} cards but only {visible} visible")
        placement = [torch.device("cuda", i) for i in range(k)]
    elif len(placement) != k:
        raise ValueError(f"{len(placement)} placements for {k} engines")
    curves: dict = {}
    engines = []
    for d in map(resolve_device, placement):
        if d not in curves:
            curves[d] = BN254Curves(device=d)
        eng = BN254Device(registry_pubkeys, batch_size=batch_size, curves=curves[d])
        if warmup:
            eng.warmup()
        engines.append(eng)
    return DevicePlane(engines)
