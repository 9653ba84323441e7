"""One run of a cell: the program under test driven by a closed loop of
clients through its shared verifier, timed over whole launches.

The system under test is `handel_tpu_torch`'s `BatchVerifierService` over
one engine (the configuration's constructor, `prepare`d on the pool's keys),
with `fallback=None`, so every verdict comes from the engine. The benchmark
wraps two of the engine's entry points, on the instance, from outside:

  * `fetch`: the verdict instant of each launch (when its fetch returns),
    its candidate count, and the program's counters read at that instant;
    in a traced run the profiler's start and stop at two verdict instants;
  * `dispatch`: each launch's host seconds (wall, and the dispatching
    thread's CPU); in a traced run the kernel wrappers' counts around each
    launch and the host spans (pack, the launch's stages, fetch) that label
    the device's idle gaps; once the window (and the profile) is over, no
    further launch.

The window opens at the verdict instant of the second launch: the first
is the warm-up at the cell's width, and the launch after it is the first
that the full pipeline issues. A traced run then profiles the running
pipeline, with nothing drained, from the first verdict instant after the
window at which the profiler is up (its start takes seconds) to the
PROFILE_LAUNCHES-th after it. At a verdict instant the card is idle (the
launch has left it, and the next one is still being packed), so the
period holds whole launches and every gap between them.

Clients: one task a request of the pool, each sending its request again,
under a fresh session name, as soon as its verdicts are back (the service
dedups per session, so every pass is real work). The pool holds
`in_flight_launches` launches of candidates, so the queue never runs dry.
"""

from __future__ import annotations

import asyncio
import gc
import importlib
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np

from portbench.harness import profile as prof
from portbench.harness.window import Launch, close_index

# how long past the window's close the run waits for a request that was
# due in the window
GRACE_S = 60.0
# the launch whose verdict instant opens the window (0 is the warm-up)
OPEN_LAUNCH = 1
# whole launch periods a traced run profiles after its window
PROFILE_LAUNCHES = 1
# stage methods of a launch whose host spans label idle gaps in a traced
# run: (owner, attribute, label); owner "engine" or "pairing"
STAGES = (
    ("engine", "_pack_requests", "pack"),
    ("engine", "_range_aggregate", "range aggregation"),
    ("engine", "_dense_aggregate", "dense aggregation"),
    ("engine", "_pairing_lanes", "affine step"),
    ("pairing", "_miller_loop_res", "miller loop"),
    ("pairing", "check_product", "product and final exponentiation"),
)


def kernel_counters() -> dict:
    """The program's kernel-wrapper counts: {wrapper: {"widths", "rows"}}."""
    out = {}
    for mod_name in ("fp_mont", "rns_mont"):
        mod = importlib.import_module(f"handel_tpu_torch.kernels.{mod_name}")
        for name, obj in vars(mod).items():
            widths = getattr(obj, "widths", None)
            if name.startswith("_") or not hasattr(widths, "items"):
                continue
            out[name] = {"widths": dict(widths), "rows": dict(obj.rows)}
    return out


def counter_diff(a: dict, b: dict) -> dict:
    """`kernel_counters` b less a, the entries that moved."""
    out = {}
    for name, cur in b.items():
        old = a.get(name, {})
        d = {
            key: {k: v - old.get(key, {}).get(k, 0) for k, v in hist.items()
                  if v != old.get(key, {}).get(k, 0)}
            for key, hist in cur.items()
        }
        if any(d.values()):
            out[name] = d
    return out


@dataclass
class Trace:
    """What the wrappers record. `launches` in fetch order; in a traced
    run `spans` (label, start, end, depth) on the trace clock."""

    launches: list = field(default_factory=list)
    spans: list = field(default_factory=list)
    # each dispatch: (start, wall s, the dispatching thread's CPU s); each
    # pass of the interpreter's cycle collector: (start, s, generation)
    dispatches: list = field(default_factory=list)
    collections: list = field(default_factory=list)
    profile: prof.Profile | None = None
    profile_error: str | None = None


class Instrument:
    """The benchmark's wrappers on one engine (module docstring)."""

    def __init__(self, engine, service_ref, trace: bool):
        self.engine = engine
        self.service_ref = service_ref  # () -> the service, for its counters
        self.trace = trace
        self.out = Trace()
        self._lock = threading.Lock()
        self._state = "idle"  # idle -> starting -> on -> done
        self._prof_start = None  # the profiler's start, a future
        self._prof_t_arm = None
        self._prof_first = None  # the fetch index that opens the period
        self._prof_t0 = None  # its verdict instant, trace clock
        self._prof_start_s = None  # arm to that verdict instant
        # traced: kernel_counters() before and after each dispatch, in
        # dispatch order (= fetch order: one lane, first in first out)
        self._dispatch_counters: list = []
        self.profile_done = threading.Event()
        # set once the window (and a traced run's profile) is over: a
        # dispatch that starts later waits for the run's end and issues
        # nothing, so the run never waits out a launch it does not read
        self._hold = False
        self._released = threading.Event()
        self._profiler = prof.ProfilerThread() if trace else None
        self._gc_t0 = None
        gc.callbacks.append(self._on_gc)
        self._orig_dispatch, self._orig_fetch = engine.dispatch, engine.fetch
        engine.dispatch, engine.fetch = self._dispatch, self._fetch
        if trace:
            for owner, attr, label in STAGES:
                obj = engine if owner == "engine" else engine.pairing
                setattr(obj, attr, self._spanned(getattr(obj, attr), label, 2))

    # -- wrappers ---------------------------------------------------------------

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            t = time.perf_counter()
            self.out.collections.append((self._gc_t0, t - self._gc_t0, info["generation"]))
            self._gc_t0 = None

    def _spanned(self, fn, label, depth):
        def call(*args, **kw):
            t0 = time.time()
            try:
                return fn(*args, **kw)
            finally:
                with self._lock:
                    self.out.spans.append((label, t0, time.time(), depth))

        return call

    def _counters(self) -> dict:
        svc = self.service_ref()
        hc = svc.plane.host_cost()
        return {
            "fill_sum": svc.fill_sum, "fill_launches": svc.fill_launches,
            "hostPackMs": hc["pack_ms"], "hostPackLaunches": hc["pack_launches"],
            "hostDispatchMs": hc["dispatch_ms"],
            "hostDispatchLaunches": hc["dispatch_launches"],
        }

    def _fetch(self, handle):
        t0 = time.time()
        out = self._orig_fetch(handle)
        t_trace, t = time.time(), time.perf_counter()
        launch = Launch(t, len(out), self._counters())
        with self._lock:
            i = len(self.out.launches)
            self.out.launches.append(launch)
            if self.trace:
                self.out.spans.append(("fetch wait", t0, t_trace, 0))
        if self._state == "starting" and self._prof_start.done():
            self._on_profile(i, t_trace)
        elif self._state == "on" and i == self._prof_first + PROFILE_LAUNCHES:
            self._stop_profile(i, handle, t_trace)
        return out

    def _dispatch(self, msg, requests):
        if self._hold:
            self._released.wait()
            raise RuntimeError("the run is over")
        c0 = kernel_counters() if self.trace else None
        w0, t0, cpu0 = time.perf_counter(), time.time(), time.thread_time()
        handle = self._orig_dispatch(msg, requests)
        self.out.dispatches.append(
            (w0, time.perf_counter() - w0, time.thread_time() - cpu0)
        )
        if self.trace:
            self._dispatch_counters.append((c0, kernel_counters()))
            with self._lock:
                self.out.spans.append(("dispatch: staging and other issue", t0, time.time(), 1))
        return handle

    # -- the traced launches ------------------------------------------------------

    def arm_profile(self) -> None:
        """Start the profiler; the profiled period opens at the first
        verdict instant after it is up (module docstring)."""
        self._prof_t_arm = time.perf_counter()
        if self.engine.device.type == "cuda":
            self._prof_start = self._profiler.start()
        else:
            self._prof_start = Future()
            self._prof_start.set_result(None)
        self._state = "starting"

    def _on_profile(self, i: int, t_trace: float) -> None:
        error = self._prof_start.exception()
        if error is not None:  # the run goes on; the readers then find nothing
            self.out.profile_error = repr(error)
            self._hold = True
            self._state = "done"
            self.profile_done.set()
            return
        self._prof_first, self._prof_t0 = i, t_trace
        self._prof_start_s = time.perf_counter() - self._prof_t_arm
        self._state = "on"

    def _stop_profile(self, i: int, handle, t_trace: float) -> None:
        self._hold = True
        try:
            records = self._profiler.stop() if self.engine.device.type == "cuda" else []
            first = self._prof_first
            counters = counter_diff(self._dispatch_counters[first + 1][0],
                                    self._dispatch_counters[i][1])
            span = self.engine.device_span(handle)
            with self._lock:
                spans = list(self.out.spans)
            self.out.profile = prof.reduce(
                records, i - first, (self._prof_t0, t_trace), counters, spans=spans,
                end_anchor=span[1] if span else None, start_s=self._prof_start_s,
            )
        except Exception as e:  # the run goes on; the readers then find nothing
            self.out.profile_error = repr(e)
        finally:
            self._state = "done"
            self.profile_done.set()

    def hold(self) -> None:
        """Issue no launch from now on (see `_hold`)."""
        self._hold = True

    def close(self) -> None:
        self._released.set()
        if self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)
        if self._profiler is not None:
            self._profiler.close()


@dataclass
class RunResult:
    trace: Trace
    records: list  # (request, t_submit, t_done, verdicts or None, error or None)
    pending: dict  # request -> t_submit, unanswered at the stop
    open_i: int
    close_i: int
    t_start_open: float  # perf_counter at the window's opening
    memory_peak_bytes: int
    dedup_hits: int


def build(config: dict, pool, device):
    """The configuration's constructor `prepare`d on the pool's keys (the
    registry commit; the prefix table is built by the first launch).
    Returns (engine, public keys, requests, {part: seconds})."""
    from handel_tpu_torch.core.bitset import BitSet

    t0 = time.perf_counter()
    mod_name, cls_name = config["constructor"].split(":")
    cons_cls = getattr(importlib.import_module(mod_name), cls_name)
    # no warm-up launch: the service's first launch, at the cell's width, is
    # the warm-up (set-up ends after the launch that follows it), and the
    # combine classes that `prepare` would warm serve no request of a
    # verify mix
    cons = cons_cls(
        batch_size=pool.lanes, device=device, warmup=False,
        batch_check=config["batch_check"], fp_backend=config["fp_backend"],
    )
    Device = cons_cls.Device
    pubkeys = [Device.PublicKey(pt) for pt in pool.pks]
    engine = cons.prepare(pubkeys)
    t1 = time.perf_counter()
    nlimbs = engine.curves.F.nlimbs
    if nlimbs != config["limbs"]:
        raise ValueError(f"the engine runs {nlimbs} limbs, the configuration states {config['limbs']}")
    R = pool.request_candidates
    requests = [
        [
            (BitSet(pool.n, pool.words[j].copy()), Device.Signature(pool.sigs[j]))
            for j in range(r * R, (r + 1) * R)
        ]
        for r in range(pool.requests)
    ]
    return engine, pubkeys, requests, {
        "engine_prepare": t1 - t0, "requests": time.perf_counter() - t1,
    }


async def drive(engine, pubkeys, requests, pool, config, seconds: float,
                trace: bool, pending_limit: int, grace_s: float = GRACE_S,
                wrap=None) -> RunResult:
    """Serve the pool's requests in a closed loop, open the window at
    launch OPEN_LAUNCH's verdict instant, close it at the last verdict
    instant within `seconds`; in a traced run then profile
    PROFILE_LAUNCHES whole launch periods. `pending_limit` is the service's
    admission bound a session (the mix's `max_pending_per_session`).
    `wrap(engine, pool, requests)`, when given, is applied after the
    benchmark's own wrappers (the control and the fault tests plant their
    verdicts there)."""
    import torch

    from handel_tpu_torch.parallel.batch_verifier import BatchVerifierService

    share = pool.request_candidates * -(-pool.requests // pool.sessions)
    if pending_limit < share:
        raise ValueError(f"a session holds up to {share} candidates at once, over the "
                         f"mix's max_pending_per_session of {pending_limit}")
    svc_box: list = []
    inst = Instrument(engine, lambda: svc_box[0], trace)
    if wrap is not None:
        wrap(engine, pool, requests)
    svc = BatchVerifierService(
        engine, max_inflight=int(config["max_inflight"]), fallback=None,
        max_pending_per_session=pending_limit,
    )
    svc_box.append(svc)
    records: list = []
    pending: dict = {}
    stopping = False

    async def client(r: int):
        p = 0
        while not stopping:
            t0 = time.perf_counter()
            pending[r] = t0
            try:
                v = await svc.verify(pool.message, pubkeys, requests[r],
                                     session=f"{p}.{pool.session_of(r)}")
            except RuntimeError as e:
                if stopping:
                    return
                records.append((r, t0, time.perf_counter(), None, str(e)))
            else:
                records.append((r, t0, time.perf_counter(), v, None))
            del pending[r]
            p += 1

    dev = engine.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    # the set-up's objects (the pool, the requests, the engine) live to the
    # end: the cycle collector need not walk them at every full pass
    gc.collect()
    gc.freeze()
    tasks = [asyncio.create_task(client(r)) for r in range(len(requests))]
    launches = inst.out.launches

    def stalled() -> bool:
        """No launch fetched for `grace_s` past the longest gap between
        launches yet: one was lost, and no window will close."""
        if not launches:
            return False
        ts = [l.t for l in launches]
        gap = max((b - a for a, b in zip(ts, ts[1:])), default=0.0)
        return time.perf_counter() - ts[-1] > grace_s + gap

    try:
        while len(launches) <= OPEN_LAUNCH and not stalled():
            await asyncio.sleep(0.005)
        open_i = min(OPEN_LAUNCH, len(launches) - 1)
        t_open = launches[open_i].t
        await asyncio.sleep(max(0.0, t_open + seconds - time.perf_counter()))
        while close_index(launches, open_i, seconds) is None and not stalled():
            await asyncio.sleep(0.005)
        # a stalled run closes at its opening: no rate, and what was sent
        # before it is missing
        close_i = close_index(launches, open_i, seconds) or open_i
        t_close = launches[close_i].t
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        if trace and close_i > open_i:
            inst.arm_profile()
            while not inst.profile_done.is_set() and not stalled():
                await asyncio.sleep(0.01)
        inst.hold()
        # every request sent before the opening was due in the window
        deadline = t_close + grace_s
        while any(t <= t_open for t in pending.values()) and time.perf_counter() < deadline:
            await asyncio.sleep(0.01)
    finally:
        stopping = True
        svc.stop()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        inst.close()
        gc.unfreeze()
    dedup = svc.cache.hits + sum(svc.tenant_dedup_hits.values())
    return RunResult(
        trace=inst.out, records=records, pending=dict(pending), open_i=open_i,
        close_i=close_i, t_start_open=t_open, memory_peak_bytes=int(peak),
        dedup_hits=int(dedup),
    )


def window_requests(result: RunResult) -> list:
    """The records answered by the window's launches: each answer belongs
    to the last launch whose verdict instant is at or before it."""
    ts = np.array([l.t for l in result.trace.launches])
    out = []
    for rec in result.records:
        i = int(np.searchsorted(ts, rec[2], side="right")) - 1
        if result.open_i < i <= result.close_i:
            out.append(rec)
    return out
