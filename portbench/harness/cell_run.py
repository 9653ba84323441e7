"""One run of one cell, from the seed to the result's dictionary.

Set-up (counted in `setup_s`, from the process's start to the window's
opening): the keys and the candidate pool from the seed, the kernel
library's build or load, the engine's `prepare` (registry commit), the
requests, the service's first launch (the warm-up at the cell's width,
which builds the prefix table) and the launch after it, the first that
the full pipeline issues. Then the window (drive.py), then, with the
program's state freed, the plain reference over every candidate answered.
"""

from __future__ import annotations

import asyncio
import os
import subprocess
import sys
import time
from dataclasses import dataclass

from portbench.harness import checks, drive, spec
from portbench.harness.profile import Profile
from portbench.harness.window import rate
from portbench.reference import curves, verdicts

BREAKDOWN_ENTRIES = 10


@dataclass
class Readings:
    """What a metric's reader reads (portbench/metrics/<name>.py). Times in
    seconds on the host's clock; `latencies_ms` are the window's requests'
    times from their `verify` call to their verdicts; `profile` the device
    trace of whole launch periods in the running pipeline (traced runs on
    the card only)."""

    launches: list
    open_i: int
    close_i: int
    setup_s: float
    latencies_ms: list
    profile: Profile | None

    def rate(self) -> float:
        return rate(self.launches, self.open_i, self.close_i)


def _log(what: str, **kw) -> None:
    print(f"portbench {what}: " + " ".join(f"{k}={v}" for k, v in kw.items()),
          file=sys.stderr, flush=True)


def host_summary(trace, t0: float, t1: float) -> dict:
    """The window's dispatches (wall and the dispatching thread's CPU
    seconds) and the cycle collector's passes: whether a slow launch was
    a slow host or a wait."""
    ds = [d for d in trace.dispatches if t0 <= d[0] <= t1]
    gcs = [c for c in trace.collections if t0 <= c[0] <= t1]
    return {
        "dispatch_wall_s": [round(d[1], 4) for d in ds],
        "dispatch_cpu_s": [round(d[2], 4) for d in ds],
        "gc_s": round(sum(c[1] for c in gcs), 4),
        "gc_passes_by_gen": [sum(1 for c in gcs if c[2] == g) for g in range(3)],
    }


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"not read ({e})"


def use_checkout_caches(root) -> None:
    """Keep the program's compile caches inside the checkout, at fixed
    paths, and keep `transformers` from loading JAX; before torch loads."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / "build" / "portbench" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "portbench" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, grace_s: float = drive.GRACE_S, wrap=None,
             root=spec.ROOT) -> dict:
    """Run `cell` once; returns the result line's dictionary. `device` is
    "cuda" for a measurement; the tests drive the same path on "cpu"."""
    import torch

    cfg, mix = cell.config, cell.mix
    curve = curves.curve(cfg["curve"])
    t = time.perf_counter()
    split = {"imports": t - t_start}
    pool = spec.generator(mix, root).generate(curve, int(cfg["registry"]), mix["params"], seed)
    split["keys_and_pool"] = time.perf_counter() - t
    if device == "cuda":
        from handel_tpu_torch.kernels.build import build_all

        t = time.perf_counter()
        build_all(("fp_mont",))
        split["kernel_build"] = time.perf_counter() - t
    engine, pubkeys, requests, build_split = drive.build(cfg, pool, torch.device(device))
    split.update(build_split)
    t_drive = time.perf_counter()
    loop = asyncio.new_event_loop()
    try:
        res = loop.run_until_complete(drive.drive(
            engine, pubkeys, requests, pool, cfg, seconds, trace,
            int(mix["params"]["max_pending_per_session"]), grace_s=grace_s, wrap=wrap,
        ))
        del engine, requests
        out = _result(cell, res, pool, curve, split, seconds, trace, device, t_start,
                      t_drive, root)
    finally:
        # the launch that was being issued when the window closed finishes
        # in its worker thread while the reference runs
        loop.run_until_complete(loop.shutdown_default_executor())
        loop.close()
    return out


def _result(cell, res, pool, curve, split, seconds, trace, device, t_start, t_drive,
            root) -> dict:
    import torch

    launches = res.trace.launches
    split["warmup_launch"] = launches[0].t - t_drive
    split["pipeline_launch"] = launches[res.open_i].t - launches[0].t
    setup_s = res.t_start_open - t_start
    window = launches[res.close_i].t - launches[res.open_i].t
    _log("setup", seconds=round(setup_s, 3),
         **{k: round(v, 3) for k, v in split.items()},
         rest=round(setup_s - sum(split.values()), 3))
    t0 = launches[res.open_i].t
    _log("window", launches=res.close_i - res.open_i, seconds=round(window, 4),
         asked=seconds, lanes=pool.lanes, launch_candidates=[l.k for l in launches],
         instants=[round(l.t - t0, 4) for l in launches])
    _log("host", **host_summary(res.trace, launches[res.open_i].t, launches[res.close_i].t))
    _log("dedup", hits=res.dedup_hits)
    if device == "cuda":
        _log("card", power=power_limit())
    if res.trace.profile_error:
        _log("profile", error=res.trace.profile_error)

    dev = {
        "platform": "gpu" if device == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": res.memory_peak_bytes,
    }

    # the reference, on the host, once the window and the profile are over
    t = time.perf_counter()
    ref = verdicts.verdicts(curve, pool.n, pool.sks, pool.candidate_messages(),
                            pool.words, pool.sigs)
    R = pool.request_candidates
    mismatched = answered = failed = 0
    for r, _t0, _t1, v, err in res.records:
        if err is not None:
            failed += R
            continue
        answered += len(v)
        mismatched += sum(a != b for a, b in zip(v, ref[r * R : (r + 1) * R]))
    missing = R * sum(1 for t0 in res.pending.values() if t0 <= res.t_start_open)
    _log("reference", seconds=round(time.perf_counter() - t, 3), answered=answered,
         forged_in_pool=int(pool.forged.sum()), rejected_by_reference=ref.count(False))
    correct, table = checks.judge({
        "mismatched": mismatched, "missing": missing, "failed": failed,
        "dedup_hits": res.dedup_hits,
    })

    in_window = drive.window_requests(res)
    readings = Readings(
        launches=launches, open_i=res.open_i, close_i=res.close_i, setup_s=setup_s,
        latencies_ms=[(t1 - t0) * 1e3 for _r, t0, t1, v, _e in in_window if v is not None],
        profile=res.trace.profile,
    )
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.reader(m["name"], root)(readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {
        "correct": correct,
        "attempted": sum(l.k for l in launches[res.open_i + 1 : res.close_i + 1]),
        "failed": failed,
        "metrics": metrics,
        "device": dev,
    }
    prof = res.trace.profile
    if trace and prof is not None:
        dev["busy_s"] = prof.busy_s
        dev["window_s"] = prof.window_s
        ops = sorted(prof.by_name.items(), key=lambda kv: -kv[1][1])[:BREAKDOWN_ENTRIES]
        gaps = sorted(prof.idle_by_label.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
        out["breakdown"] = {
            "device_ops": [[name[:120], s] for name, (_n, s) in ops],
            "idle_gaps": [[label, s] for label, s in gaps],
        }
        _log("profile", launches=prof.launches, kernels=prof.kernels,
             busy_s=prof.busy_s, window_s=prof.window_s, counters=prof.counters,
             **prof.align)
    out["checks"] = table
    return out
