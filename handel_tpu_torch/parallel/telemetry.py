"""Device telemetry: the card's memory, kernel libraries and verify-plane
gauges, plus on-demand profiler capture — the counterpart of
handel_tpu/parallel/telemetry.py.

The verification plane's health questions ("is device memory growing?",
"how deep is the dispatch queue?", "did this process build its kernels
mid-run?") have no monitor-plane answer — the CSV lands after the run. This
collector samples them live into the metrics registry (core/metrics.py,
plane "device"):

    handel_device_mem_bytes_in_use      torch.cuda.memory_stats: allocated
    handel_device_mem_bytes_reserved    ... reserved by the caching allocator
    handel_device_mem_bytes_peak        ... peak allocated
    handel_device_kernel_libs_built     kernel libraries nvcc built here
    handel_device_kernel_libs_loaded    kernel libraries loaded here
    handel_device_kernel_build_time_ms  nvcc seconds spent here, in ms
    handel_device_dispatch_queue_depth  BatchVerifierService pending lane
    handel_device_inflight_launches     dispatched, verdicts not yet fetched
    handel_device_breaker_state         0 closed / 0.5 half-open / 1 open
    handel_device_mesh_lanes            latency-plane mesh lanes (+_available)
    handel_device_mesh_launches         launches that rode the whole mesh

The reference's XLA gauges have the port's own keys in their place: its
compile events (`xlaCompileCt`, `xlaCompileTimeMs`) become the kernel
libraries built and loaded (kernels/build.py `BUILT`, `LOADED`) and the
nvcc time, its live-array gauges (`liveArrays`, `liveArrayBytes`) the
caching allocator's reserved and peak bytes. The memory gauges read the
engine's device: on a card they come from `torch.cuda.memory_stats`, and a
failure to read them raises into the registry's scrape-error counter
instead of reading 0; an engine on the CPU has no device memory, and its
gauges read 0.

`profile(seconds)` is the `POST /debug/profile?seconds=N` handler: captures
a `torch.profiler` trace of the card's activity (the CPU's, for an engine on
the CPU) into the run's trace dir, as `trace.json` (Chrome trace) and
`kernels.json` ({kernel name: [count, device ms]}), and returns the
capture directory.
"""

from __future__ import annotations

import json
import os
import threading
import time

_BREAKER = {"closed": 0.0, "half-open": 0.5, "open": 1.0}


def _engine_device(service):
    """The torch.device of the service's first engine, or None."""
    if service is None:
        return None
    plane = getattr(service, "plane", None)
    engine = plane.lanes[0].engine if plane is not None else service.device
    return getattr(engine, "device", None)


class DeviceTelemetry:
    """Reporter-shaped (`values()` / `gauge_keys()`) device-state sampler.

    service: the process's BatchVerifierService, or None (chip-less node).
    device: the device whose memory is read; default the service's engine's.
    trace_dir: where `profile()` drops its capture ("" = the current
    directory).
    """

    def __init__(self, service=None, trace_dir: str = "", device=None):
        self.service = service
        self.device = device if device is not None else _engine_device(service)
        self.trace_dir = trace_dir
        self.profile_captures = 0
        self._profiling = threading.Lock()

    def _on_card(self) -> bool:
        return self.device is not None and getattr(self.device, "type", "") == "cuda"

    # -- sampling ------------------------------------------------------------

    def values(self) -> dict[str, float]:
        from handel_tpu_torch.kernels import build

        out = {
            "kernelLibsBuilt": float(len(build.BUILT)),
            "kernelLibsLoaded": float(len(build.LOADED)),
            "kernelBuildTimeMs": sum(build.BUILT.values()) * 1000.0,
            "memBytesInUse": 0.0,
            "memBytesReserved": 0.0,
            "memBytesPeak": 0.0,
            "dispatchQueueDepth": 0.0,
            "inflightLaunches": 0.0,
            "breakerState": 0.0,
            "deviceLanes": 0.0,
            "deviceLanesAvailable": 0.0,
            "meshLanes": 0.0,
            "meshLanesAvailable": 0.0,
            "meshLaunches": 0.0,
            "profileCaptures": float(self.profile_captures),
        }
        if self._on_card():
            import torch

            stats = torch.cuda.memory_stats(self.device)
            if not stats:
                raise RuntimeError(f"torch.cuda.memory_stats({self.device}) read nothing")
            out["memBytesInUse"] = float(stats["allocated_bytes.all.current"])
            out["memBytesReserved"] = float(stats["reserved_bytes.all.current"])
            out["memBytesPeak"] = float(stats["allocated_bytes.all.peak"])
        svc = self.service
        if svc is not None:
            out["dispatchQueueDepth"] = float(svc.queue_depth())
            out["inflightLaunches"] = float(svc.inflight_launches())
            out["breakerState"] = _BREAKER[svc.breaker.state]
            plane = svc.plane
            out["deviceLanes"] = float(len(plane.lanes))
            out["deviceLanesAvailable"] = float(len(plane.allowed()))
            mesh = plane.mesh_lanes()
            out["meshLanes"] = float(len(mesh))
            out["meshLanesAvailable"] = float(sum(
                1 for lane in mesh if not lane.draining and lane.breaker.allow()
            ))
            out["meshLaunches"] = float(sum(lane.launches for lane in mesh))
        return out

    def gauge_keys(self) -> set[str]:
        # everything here is point-in-time except the build time and the
        # capture count
        return {
            "kernelLibsBuilt", "kernelLibsLoaded",
            "memBytesInUse", "memBytesReserved", "memBytesPeak",
            "dispatchQueueDepth", "inflightLaunches", "breakerState",
            "deviceLanes", "deviceLanesAvailable",
            "meshLanes", "meshLanesAvailable",
        }

    # -- profiler capture (POST /debug/profile) ------------------------------

    def profile(self, seconds: float) -> str:
        """Capture a torch.profiler trace for `seconds`; returns the capture
        dir. Raises on a failed capture (the HTTP layer turns that into a
        500, never a crash) and refuses concurrent captures."""
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        if not self._profiling.acquire(blocking=False):
            raise RuntimeError("a profile capture is already running")
        try:
            out = os.path.join(
                self.trace_dir or os.getcwd(), f"profile_{int(time.time())}"
            )
            os.makedirs(out, exist_ok=True)
            on_card = self._on_card()
            activity = ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU
            kind = DeviceType.CUDA if on_card else DeviceType.CPU
            with profile(activities=[activity]) as prof:
                time.sleep(seconds)
            prof.export_chrome_trace(os.path.join(out, "trace.json"))
            # the raw records: the parsed event list costs far more host time
            by_name: dict[str, list] = {}
            for e in prof.profiler.kineto_results.events():
                if e.device_type() == kind:
                    entry = by_name.setdefault(e.name(), [0, 0.0])
                    entry[0] += 1
                    entry[1] += e.duration_ns() / 1e6
            with open(os.path.join(out, "kernels.json"), "w") as f:
                json.dump(by_name, f, sort_keys=True)
            if on_card:
                torch.cuda.synchronize(self.device)
            self.profile_captures += 1
            return out
        finally:
            self._profiling.release()

    def profiler(self):
        """The MetricsServer `profiler=` hook: seconds -> capture dir."""
        return self.profile
