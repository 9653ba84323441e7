"""Handel runtime configuration — the part of handel_tpu/core/config.py that
a node of the port reads.

Reference: config.go:12-165 — the `Config` struct with factory-closure
injection points for every pluggable strategy, the defaults
(DefaultContributionsPerc=51, DefaultCandidateCount=10, DefaultUpdatePeriod=10ms,
DefaultUpdateCount=1, config.go:87-97), merge-with-default (:128-165), and
`PercentageToContributions` (:124-126).

Beyond the reference: `batch_size` (max signatures per device verify
launch), `verifier` (an async batch verifier in place of the scheme's own
`batch_verify`), the peer-penalty and flood bounds, and the service's
`session` and `epoch` with its `new_scorer` (service/session.py).
Fields of the JAX package's Config that serve planes the port has not
ported yet (the windowed store and the simulated verify sleep) are not
here, nor are its factory hooks that no caller of the port
sets (bitset and partitioner factories, and the peer-penalty switch): a
node always builds `BitSet` and `BinomialPartitioner`. The evaluator and
processing factories (the sim's `evaluator = "eval1"` / `"fifo"`) and
the geo plane's `region` tag are here. Every field here has the JAX
package's default.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Callable, Optional

from handel_tpu_torch.core.logging import DEFAULT_LOGGER, Logger

DEFAULT_CONTRIBUTIONS_PERC = 51  # config.go:87
DEFAULT_CANDIDATE_COUNT = 10  # FastPath fanout, config.go:90
DEFAULT_UPDATE_PERIOD = 0.010  # seconds, config.go:93
DEFAULT_UPDATE_COUNT = 1  # config.go:97
DEFAULT_LEVEL_TIMEOUT = 0.050  # seconds, timeout.go:31
DEFAULT_BATCH_SIZE = 16  # verify batch per launch
DEFAULT_MAX_PENDING = 4096  # inbound verification queue bound (flood defense)


def percentage_to_contributions(perc: int, n: int) -> int:
    """Exact contribution count for a percentage threshold (config.go:124-126)."""
    return math.ceil(n * perc / 100.0)


@dataclass
class Config:
    """Runtime knobs + factories for pluggable strategies."""

    # minimum contributions in an output multisignature (config.go:19)
    contributions: int = 0
    # seconds between periodic update gossip rounds (config.go:23)
    update_period: float = DEFAULT_UPDATE_PERIOD
    # peers contacted per periodic update per level (config.go:27)
    update_count: int = DEFAULT_UPDATE_COUNT
    # peers contacted when a level completes — the fast path (config.go:31)
    fast_path: int = DEFAULT_CANDIDATE_COUNT
    # seconds between successive level starts (timeout.go:31)
    level_timeout: float = DEFAULT_LEVEL_TIMEOUT

    # (handel, levels) -> TimeoutStrategy; default = LinearTimeout
    new_timeout: Optional[Callable] = None
    # (store, handel) -> SigEvaluator; default = the store itself
    new_evaluator: Optional[Callable] = None
    # processing pipeline class (BatchProcessing ctor signature); None =
    # BatchProcessing. FifoProcessing gives the reference's deprecated
    # arrival-order strategy for A/B runs (processing.go:380-493)
    new_processing: Optional[Callable] = None

    logger: Logger = DEFAULT_LOGGER
    # entropy for per-level candidate shuffling (config.go:55)
    rand: random.Random = field(default_factory=random.Random)
    # debugging: keep candidate lists in registry order (config.go:59)
    disable_shuffling: bool = False

    # -- byzantine hardening ----------------------------------------------
    # (handel, ) -> PeerScorer; None builds a PeerScorer with the default
    # thresholds (core/penalty.py). The service's sessions share one
    # scorer per session (SessionScorers)
    new_scorer: Optional[Callable] = None
    # cap on queued unverified candidates per node; beyond it the OLDEST
    # pending candidate is dropped, so a flooder bounds host memory instead
    # of growing it (core/processing.py)
    max_pending: int = DEFAULT_MAX_PENDING

    # -- observability (core/trace.py) -------------------------------------
    # span flight recorder following every contribution recv -> queue ->
    # verify -> merge; None disables tracing (the hooks cost one None check
    # per contribution). Shared across co-located nodes — each node records
    # under its own id as the Chrome-trace tid.
    recorder: Optional[object] = None

    # -- multi-tenant service (service/) -----------------------------------
    # aggregation-session id this node belongs to ("" = the single-tenant
    # default). Scopes the per-instance state — dedup verdict keys, the
    # shared verifier's fairness/admission queues, penalty attribution —
    # so concurrent sessions sharing one process and one device plane
    # never bleed state into each other.
    session: str = ""
    # validator-set epoch this node was spawned under (lifecycle/epoch.py
    # EpochManager). The epoch joins every dedup key and trace span, so a
    # verdict computed against epoch E's registry is never replayed for
    # epoch E+1's. 0 = the single-epoch default (key shapes unchanged).
    epoch: int = 0

    # -- WAN scenario plane (network/geo.py) ------------------------------
    # region label this node aggregates from (GeoNetwork planet model). Tags
    # every send/recv/verify/merge trace span so the critical-path analyzer
    # can attribute WAN hops by region pair. "" = untagged (span args
    # unchanged).
    region: str = ""
    # per-identity stake weights, indexed by identity id (any array-like the
    # bitset's weight_sum can dot against: ArrayRegistry.weights()). None
    # keeps the count-based threshold; all-1.0 weights are bit for bit
    # equivalent to counting.
    weights: Optional[object] = None
    # minimum weight sum in an output multisignature; only read when
    # `weights` is set. 0.0 = derive from `contributions` as the same
    # fraction of total weight that `contributions` is of the node count
    # (so a 51% count threshold becomes a 51% stake threshold).
    weight_threshold: float = 0.0

    # -- batch verification ------------------------------------------------
    # max candidates per device verification launch
    batch_size: int = DEFAULT_BATCH_SIZE
    # async batch verifier (msg, pubkeys, requests) -> verdicts; None
    # verifies through the scheme's own batch_verify
    verifier: Optional[Callable] = None


def default_config(num_nodes: int) -> Config:
    """DefaultConfig (config.go:69-83)."""
    c = Config()
    c.contributions = percentage_to_contributions(
        DEFAULT_CONTRIBUTIONS_PERC, num_nodes
    )
    return c


def merge_with_default(c: Config | None, num_nodes: int) -> Config:
    """Fill unset fields from defaults (config.go:128-165)."""
    if c is None:
        return default_config(num_nodes)
    if c.contributions == 0:
        c.contributions = percentage_to_contributions(
            DEFAULT_CONTRIBUTIONS_PERC, num_nodes
        )
    return c
