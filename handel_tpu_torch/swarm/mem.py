"""Memory accounting for the swarm runtime — a copy of
handel_tpu/swarm/mem.py.

Two measures, deliberately both reported (the swarm's measure is a
bytes-per-identity curve, and either one alone lies):

- `process_rss_bytes()` — the process's resident set from /proc (Linux) or
  the `resource` peak as fallback. Honest about everything (interpreter,
  numpy, allocator slack) but shared across all co-resident vnodes, so
  per-identity RSS *falls* as density rises.
- `deep_size(obj)` — a `sys.getsizeof` walk over one vnode's object graph,
  stopping at objects shared swarm-wide (the registry, identities, pubkeys,
  config singletons) via the caller's `shared` set. This is the marginal
  per-identity footprint the O(active levels) claim is about.
"""

from __future__ import annotations

import sys
from typing import Iterable

import numpy as np


def process_rss_bytes() -> int:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    import resource

    # ru_maxrss is KB on Linux (peak, not current — fallback only)
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def deep_size(obj, shared: Iterable[object] = (), max_objects: int = 500_000) -> int:
    """Recursive getsizeof over `obj`'s reachable graph.

    `shared` objects (and everything below them) are excluded — they are
    amortized across the swarm, not part of one vnode's marginal cost.
    Bounded by `max_objects` so a cycle of unexpected shape degrades to an
    undercount, never a hang.
    """
    seen: set[int] = {id(s) for s in shared}
    total = 0
    stack = [obj]
    visited = 0
    while stack and visited < max_objects:
        o = stack.pop()
        oid = id(o)
        if oid in seen:
            continue
        seen.add(oid)
        visited += 1
        try:
            total += sys.getsizeof(o)
        except TypeError:
            continue
        if isinstance(o, np.ndarray):
            total += o.nbytes
            continue
        if isinstance(o, (str, bytes, bytearray, int, float, bool)):
            continue
        if isinstance(o, dict):
            stack.extend(o.keys())
            stack.extend(o.values())
        elif isinstance(o, (list, tuple, set, frozenset)):
            stack.extend(o)
        if hasattr(o, "__dict__"):
            stack.append(o.__dict__)
        if hasattr(o, "__slots__"):
            for s in o.__slots__:
                v = getattr(o, s, None)
                if v is not None:
                    stack.append(v)
    return total
