"""Best-per-level signature store with merge/patch logic and verification
scoring — a copy of handel_tpu/core/store.py.

Reference: store.go:14-282 — `SignatureStore` interface, the scoring function
`unsafeEvaluate` (store.go:111-183) that prioritizes which unverified signatures
are worth a pairing check, and `unsafeCheckMerge` (store.go:188-229) which
merges non-overlapping multisigs and patches holes with already-verified
individual signatures.

The exact scoring/merging semantics matter for protocol convergence; they are
reproduced faithfully. Point additions go through `Signature.combine`, or
through the `combiner` hook in one call per merge, which a device scheme
serves with one batched G1 sum (core/processing.py `CombineShim`,
models/bn254_torch.py `BN254Device.combine_batch`).

Concurrency note: the reference store carries its own mutex (store.go:41)
because goroutines race on it. Here every caller runs on one asyncio event
loop, so no lock is needed.
"""

from __future__ import annotations

from collections import OrderedDict
from hashlib import blake2b
from typing import Callable

from handel_tpu_torch.core.bitset import BitSet
from handel_tpu_torch.core.crypto import Constructor, MultiSignature
from handel_tpu_torch.core.partitioner import BinomialPartitioner, IncomingSig


class VerifiedAggCache:
    """Bounded LRU of aggregate-verification verdicts.

    Handel's gossip pattern re-delivers the same winning aggregate from many
    peers per level (the reference re-verifies every copy,
    processing.go:258-287); each re-verification burns a device lane.  This
    cache keys a candidate by its exact content — (level, digest of bitset
    words + signature bytes) — so a copy this node has already judged
    short-circuits to the remembered verdict with zero device work.  Negative verdicts are
    cached too: a known-bad aggregate re-sent by a byzantine peer costs
    nothing after the first pairing check.

    Used per-node by `BatchProcessing` (core/processing.py) and, keyed by
    message instead of level, process-wide by `BatchVerifierService`
    (parallel/batch_verifier.py) where co-located nodes dedup each other.
    Bounded so a flood of distinct aggregates cannot grow host memory
    unboundedly; LRU because Handel traffic is bursty per level — the
    current level's winners stay hot, finished levels age out.

    Single-threaded like the store itself (module docstring): every caller
    runs on one asyncio loop, so no lock.
    """

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError("cache capacity must be >= 1")
        self.capacity = capacity
        self._map: OrderedDict[tuple, bool] = OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def content_digest(bitset, signature) -> bytes:
        """16-byte blake2b over the exact bitset words + signature bytes.
        Keys store the digest, not the raw words, which for a wide level
        are kilobytes; a 128-bit content hash has negligible collision odds
        at any reachable entry count."""
        h = blake2b(bitset.words().tobytes(), digest_size=16)
        h.update(signature.marshal())
        return h.digest()

    @staticmethod
    def key(scope, ms: MultiSignature) -> tuple:
        """Content identity of a candidate: its scope (the level) plus the
        content digest of the exact bitset words and signature bytes."""
        return (scope, VerifiedAggCache.content_digest(ms.bitset, ms.signature))

    def drop_scope(self, scope) -> int:
        """Forget every verdict whose key LEADS with `scope` — either as
        the key's first element or as the first element of a tuple scope.
        The multi-tenant eviction hook (parallel/batch_verifier.py
        `forget_session`): a retired session's verdicts must not keep
        occupying LRU capacity the live tenants could use. O(cache size) —
        evictions are rare next to lookups. Returns the number of entries
        dropped."""
        dead = [
            k
            for k in self._map
            if k[0] == scope
            or (isinstance(k[0], tuple) and k[0] and k[0][0] == scope)
        ]
        for k in dead:
            del self._map[k]
        return len(dead)

    def get(self, key: tuple) -> bool | None:
        """Remembered verdict for `key`, or None; counts the hit/miss."""
        verdict = self._map.get(key)
        if verdict is None:
            self.misses += 1
            return None
        self._map.move_to_end(key)
        self.hits += 1
        return verdict

    def put(self, key: tuple, verdict: bool) -> None:
        self._map[key] = verdict
        self._map.move_to_end(key)
        while len(self._map) > self.capacity:
            self._map.popitem(last=False)

    def __len__(self) -> int:
        return len(self._map)

    def values(self) -> dict[str, float]:
        """Reporter counters: dedup hits and misses, hit rate, size."""
        total = self.hits + self.misses
        return {
            "dedupHits": float(self.hits),
            "dedupMisses": float(self.misses),
            "dedupHitRate": self.hits / total if total else 0.0,
            "dedupSize": float(len(self._map)),
        }

    def gauge_keys(self) -> set[str]:
        """Point-in-time keys, declared explicitly so a metrics plane never
        deltas them."""
        return {"dedupHitRate", "dedupSize"}


class SignatureStore:
    """Store of the best verified multisignature per level.

    Also the default `SigEvaluator` — the store knows best which candidate
    signatures are worth verifying (store.go:14-18).
    """

    def __init__(
        self,
        partitioner: BinomialPartitioner,
        new_bitset: Callable[[int], BitSet] = BitSet,
        constructor: Constructor | None = None,
        combiner: Callable[[list], object] | None = None,
        weights=None,
    ):
        self.part = partitioner
        self.nbs = new_bitset
        self.cons = constructor
        # per-identity stake weights in global registry coordinates; None =
        # count-based scoring. Level bitsets slice it through range_level,
        # which is exact because the partitioner embeds level l's bitset at
        # range_level(l)[0].
        self.weights = weights
        # batched signature combiner: list of Signatures -> their combined
        # Signature in ONE call (core/processing.py CombineShim routes it to
        # the device scheme's combine_batch). None = host-serial
        # `Signature.combine` folds, the reference behavior.
        self.combiner = combiner
        # best multisignature per level (store.go:43)
        self.best_by_level: dict[int, MultiSignature] = {}
        self.highest = 0
        # which individual sigs we have verified, per level (store.go:55),
        # allocated on first touch
        self.indiv_verified: dict[int, BitSet] = {0: new_bitset(1)}
        # the verified individual sigs themselves (store.go:58)
        self.individual_sigs: dict[int, dict[int, MultiSignature]] = {0: {}}
        # reporter counters (report.go:80-87)
        self.replace_trial = 0
        self.success_replace = 0
        # combined()/full_signature() results are pure functions of
        # best_by_level; gossip re-sends the SAME bests every period, so the
        # recombination (bitset embeds + signature folds) is memoized on a
        # generation counter bumped whenever a level's best changes
        self._gen = 0
        self._combined_cache: dict[int, tuple[int, MultiSignature | None]] = {}
        self._full_cache: tuple[int, MultiSignature | None] | None = None

    def _iv(self, level: int) -> BitSet:
        """The level's verified-individuals bitset, created on first touch."""
        bs = self.indiv_verified.get(level)
        if bs is None:
            bs = self.indiv_verified[level] = self.nbs(self.part.size_of(level))
            self.individual_sigs.setdefault(level, {})
        return bs

    # -- evaluation (store.go:101-183) -------------------------------------

    def evaluate(self, sp: IncomingSig) -> int:
        """Score an unverified signature: 0 = discard, higher = verify sooner."""
        score = self._evaluate(sp)
        if score < 0:
            raise AssertionError("negative score")
        return score

    def _evaluate(self, sp: IncomingSig) -> int:
        to_receive = self.part.size_of(sp.level)
        cur_best = self.best_by_level.get(sp.level)

        if cur_best is not None and to_receive == cur_best.cardinality():
            return 0  # completed level: nothing more to gain
        if sp.individual and self._iv(sp.level).get(sp.mapped_index):
            return 0  # already verified this exact individual sig
        if (
            cur_best is not None
            and not sp.individual
            and cur_best.bitset.is_superset(sp.ms.bitset)
        ):
            return 0  # strictly dominated by what we already have

        # what we'd have after patching with known-verified individual sigs
        with_indiv = sp.ms.bitset.or_(self._iv(sp.level))
        final_set = with_indiv
        if cur_best is None:
            new_total = with_indiv.cardinality()
            added_sigs = new_total
            combine_ct = new_total - sp.ms.cardinality()
        elif sp.ms.bitset.intersection_cardinality(cur_best.bitset) != 0:
            # overlap: would replace, not merge
            new_total = with_indiv.cardinality()
            added_sigs = new_total - cur_best.cardinality()
            combine_ct = new_total - sp.ms.cardinality()
        else:
            # disjoint: merge with current best + verified individuals
            final_set = with_indiv.or_(cur_best.bitset)
            new_total = final_set.cardinality()
            added_sigs = new_total - cur_best.cardinality()
            combine_ct = final_set.xor(
                cur_best.bitset.or_(sp.ms.bitset)
            ).cardinality()

        if added_sigs <= 0:
            # no gain; keep individual sigs anyway for BFT patching
            return 1 if sp.individual else 0
        if new_total == to_receive:
            # completes a level — top priority, lower levels first
            return 1_000_000 - sp.level * 10 - combine_ct
        # useful but incomplete: favor lower levels and bigger gains. With
        # stake weights, the gain term scores the weight the candidate adds,
        # normalized back to count units so it stays inside this bracket;
        # all-1.0 weights reduce to exactly added_sigs.
        return (
            100_000
            - sp.level * 100
            + self._gain_units(sp.level, added_sigs, cur_best, final_set)
            - combine_ct
        )

    def _gain_units(self, level, added_sigs, cur_best, final_set) -> int:
        """The `added_sigs * 10` scoring term, stake-aware.

        Count path: added_sigs * 10, the reference score (store.go:180).
        Weighted path: the weight the candidate's new bits add, scaled by
        level_size/level_weight into equivalent-count units and clamped to
        the count bracket's natural range. All-1.0 weights make the scale
        factor exactly 1.0, so the two paths return identical ints.
        """
        if self.weights is None:
            return added_sigs * 10
        lo, hi = self.part.range_level(level)
        lvl_w = self.weights[lo:hi]
        gained = final_set.weight_sum(lvl_w)
        if cur_best is not None:
            gained -= cur_best.bitset.weight_sum(lvl_w)
        total_w = float(sum(lvl_w))
        if total_w <= 0.0:
            return added_sigs * 10
        units = gained * ((hi - lo) / total_w)
        return max(0, min(hi - lo, round(units))) * 10

    # -- storage (store.go:82-99, 188-229) ---------------------------------

    def store(self, sp: IncomingSig) -> MultiSignature | None:
        """Save or merge a *verified* signature; returns the resulting best."""
        if sp.individual:
            if sp.ms.cardinality() != 1:
                raise AssertionError("individual sig with cardinality != 1")
            self._iv(sp.level).set(sp.mapped_index, True)
            self.individual_sigs[sp.level][sp.mapped_index] = sp.ms

        new_ms, should_store = self._check_merge(sp)
        if should_store:
            self.best_by_level[sp.level] = new_ms
            self._gen += 1
            if sp.level > self.highest:
                self.highest = sp.level
        return new_ms

    def _check_merge(self, sp: IncomingSig) -> tuple[MultiSignature | None, bool]:
        cur_best = self.best_by_level.get(sp.level)
        if cur_best is None:
            return sp.ms, True
        self.replace_trial += 1

        # collect every signature the resulting best aggregates — the new
        # candidate, the current best when disjoint, and the individual-sig
        # patches — and combine them in ONE call at the end: a batched
        # device scheme (combine_batch via `combiner`) then pays a single
        # launch where the reference pays one pairing-library point add per
        # contribution (store.go:201,225)
        bits = sp.ms.bitset.clone()
        parts = [sp.ms.signature]
        merged = sp.ms.bitset.or_(cur_best.bitset)
        if merged.cardinality() == cur_best.cardinality() + sp.ms.cardinality():
            # disjoint: aggregate the two signatures
            bits = merged
            parts.append(cur_best.signature)

        # patch holes with verified individual sigs (store.go:204-226)
        vl = self._iv(sp.level)
        patchable = bits.and_(vl).xor(vl)
        if patchable.cardinality() + bits.cardinality() <= cur_best.cardinality():
            return None, False

        for pos in patchable.indices():
            parts.append(self.individual_sigs[sp.level][pos].signature)
            bits.set(pos, True)
        self.success_replace += 1
        return MultiSignature(bits, self._combine_sigs(parts)), True

    def _combine_sigs(self, parts: list):
        """Sum a list of signatures: one batched-combiner call when wired
        (point addition is commutative, so the batched sum is the same
        group element as the reference's sequential fold), else the
        reference's serial `Signature.combine` chain."""
        if len(parts) == 1:
            return parts[0]
        if self.combiner is not None:
            return self.combiner(parts)
        sig = parts[0]
        for s in parts[1:]:
            sig = s.combine(sig)
        return sig

    # -- queries (store.go:231-262) ----------------------------------------

    def best(self, level: int) -> MultiSignature | None:
        return self.best_by_level.get(level)

    def combined(self, level: int) -> MultiSignature | None:
        """Best combination of all levels <= `level`, sized for level+1's
        candidate set (store.go:248-262). Memoized per generation — callers
        (the gossip/fast-path send plane) treat the result as immutable."""
        hit = self._combined_cache.get(level)
        if hit is not None and hit[0] == self._gen:
            return hit[1]
        sigs = [
            IncomingSig(origin=-1, level=lvl, ms=ms)
            for lvl, ms in self.best_by_level.items()
            if lvl <= level
        ]
        send_level = level + 1 if level < self.part.max_level() else level
        ms = self.part.combine(sigs, send_level, self.nbs,
                               combiner=self.combiner)
        self._combined_cache[level] = (self._gen, ms)
        return ms

    def combined_cardinality(self, level: int) -> int:
        """Cardinality `combined(level)` would have, without combining.

        Level ranges are disjoint by construction, so the count is a plain
        sum of per-level best cardinalities — O(levels) dict lookups. The
        verified-signature actors use this to skip the (bitset-embed +
        point-add) combine when the result cannot beat what was already
        sent, which is the common case once a level has propagated.
        """
        return sum(
            ms.cardinality()
            for lvl, ms in self.best_by_level.items()
            if lvl <= level
        )

    def full_cardinality(self) -> int:
        """Cardinality `full_signature()` would have, without combining."""
        return sum(ms.cardinality() for ms in self.best_by_level.values())

    def full_weight(self, weights=None) -> float:
        """Stake weight `full_signature()` would carry, without combining:
        the weighted sibling of `full_cardinality()`. Level ranges are
        disjoint, so the total is a per-level `weight_sum` over the level's
        slice of the global weight vector. With all-1.0 weights this equals
        `full_cardinality()` exactly."""
        w = self.weights if weights is None else weights
        if w is None:
            return float(self.full_cardinality())
        total = 0.0
        for lvl, ms in self.best_by_level.items():
            lo, hi = self.part.range_level(lvl)
            total += ms.bitset.weight_sum(w[lo:hi])
        return total

    def full_signature(self) -> MultiSignature | None:
        """Registry-sized combination of everything we have (store.go:238-246).
        Memoized per generation like `combined`."""
        if self._full_cache is not None and self._full_cache[0] == self._gen:
            return self._full_cache[1]
        sigs = [
            IncomingSig(origin=-1, level=lvl, ms=ms)
            for lvl, ms in self.best_by_level.items()
        ]
        ms = self.part.combine_full(sigs, self.nbs, combiner=self.combiner)
        self._full_cache = (self._gen, ms)
        return ms

    def values(self) -> dict[str, float]:
        """Reporter counters (report.go:80-87)."""
        return {
            "successReplace": float(self.success_replace),
            "replaceTrial": float(self.replace_trial),
        }

