"""What decides `correct`, and the result's last lines.

Every number compared has its limit here (PERF.md gives the readings each
limit was set from). All four are exact counts, so each limit is 0:

  mismatched   answered candidates whose verdict differs from the plain
               reference's (portbench/reference/verdicts.py)
  missing      candidates sent before the window opened that were never
               answered, a minute past the close at the most
  failed       candidates whose request raised instead of answering
  dedup_hits   candidates the service answered from its dedup cache: the
               replayed pool must reach the card every time
"""

from __future__ import annotations

import json
import sys

LIMITS = {"mismatched": 0, "missing": 0, "failed": 0, "dedup_hits": 0}
# top-level module names that may not be loaded in a run: JAX and the JAX
# package, compared whole (`handel_tpu_torch` is the port)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "handel_tpu"})


def forbidden_modules(modules) -> list:
    """The loaded modules whose top-level name is forbidden."""
    return sorted({name.split(".", 1)[0] for name in modules} & FORBIDDEN)


def judge(values: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for the compared numbers."""
    table = {k: {"value": values[k], "limit": LIMITS[k]} for k in LIMITS}
    return all(v["value"] <= v["limit"] for v in table.values()), table


def emit(result: dict) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output, `checks` last in it."""
    for name, v in result["checks"].items():
        print(f"check {name} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    ordered = {k: v for k, v in result.items() if k != "checks"}
    ordered["checks"] = result["checks"]
    print(json.dumps(ordered), flush=True)
