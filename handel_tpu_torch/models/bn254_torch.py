"""BLS-over-BN254 with verification on the card — counterpart of
handel_tpu/models/bn254_jax.py (per-candidate checking, one device).

A launch verifies up to `batch_size` candidate aggregate signatures at once:

  1. the aggregate public key of each candidate, from the device-resident
     registry bank: the **range** class takes prefix[hi] - prefix[lo] from
     the prefix table and subtracts the few missing signers of the hull; the
     **dense** class unpacks the bitset words on the card and tree-sums the
     masked registry (ops/curve.py `masked_sum`);
  2. one batched product-of-pairings check
     e(H(m), X_j) * e(-S_j, B2) == 1 for every candidate j, with one shared
     final exponentiation (ops/pairing.py `pairing_check`).

`fp_backend="rns"` runs the field on the RNS backend (ops/rns.py): the
aggregation and affine conversion through its per-mul products, the pairing
check on residue planes (the resident form, on by default there) through
kernel B2.

`combine_batch` sums groups of G1 points — the aggregate-signature merges of
a node's store — in one masked G1 tree sum and affine conversion a chunk,
the device side of core/processing.py `CombineShim`. It runs on the cios
field (kernel B1) whatever the verify backend: its points arrive and leave
as host affine points, so its field is free, and a combine through the rns
backend's per-mul product issues 37x the ops of a cios one (95,531 against
2,571 at 128 lanes, counted on the CPU with each kernel call as one op),
which a round's thousand-odd merges on the event loop cannot afford.

Keys, signatures and wire formats are the host objects of models/bn254.py.
The host packer builds each launch in pinned staging buffers that rotate
over `stage_sets` sets; a CUDA event per set fences a set against reuse
while a launch that reads it may still be copying from it.

Threads. The shared batch verifier (parallel/batch_verifier.py) calls
`dispatch` and `fetch` from worker threads, and the dispatch of launch n+1
may run while the fetch of launch n waits; meanwhile the nodes' merges call
`combine_batch` on the event-loop thread. So on the card:

  * verify and combine run on two streams of their own. A launch's work,
    its verdicts' copy to pinned host memory and its completion event are
    all on the verify stream; `fetch` waits on that event and touches no
    stream. A combine's synchronizing copies wait for the combine stream
    only, never for a verify launch in flight.
  * one lock serializes dispatches: the staging rotation, the fence and
    the per-message H(m) cache belong to one dispatch at a time.
  * first-use state (the kernel library, the field's cached device
    constants, the prefix table, the combine classes, H(m) of the warmup
    message) is built by `warmup`, which ends with a device synchronize: a
    service over the engine starts after it (`BN254TorchConstructor.prepare`
    runs it), so no two threads race to build that state, and the registry
    bank (written by blocking copies) and the prefix table are only read
    from then on.
  * on the card a launch's handle carries two timing events on the verify
    stream, recorded before its first op and after its last;
    `device_span(handle)` maps them onto the trace clock (core/trace.py
    `trace_now`) through one anchor event recorded on the idle stream, so
    the shared verifier's `launch_on_device` span is the launch's time on
    the stream, not the tail left after a host-bound dispatch returns.

`batch_check="rlc"` checks a launch as one random linear combination
(models/rlc.py): a G1 MSM over the signatures, a G2 MSM over the aggregate
keys grouped by message, and one (G+1)-lane product of pairings, bisected
with fresh scalars down to per-candidate launches when it fails. The MSMs
run on the engine's own field, as in the reference: an honest RLC range
launch of 128 lanes issues 1,549,467 ops in its MSMs on the rns backend
against 832,667 on cios (1,808,188 and 1,373,520 in all, counted on the CPU
by `utils/opcount.py`), far from the combine's 37x. `dispatch_multi` takes
launches whose lanes carry different messages.

Epoch rotation (lifecycle/epoch.py). `stage_registry` builds the next
validator set's `RegistryBank` — the key pack, its copy to the card and
the prefix table — while the active bank serves; `activate_staged` flips
it live between launches. Staging runs in an executor thread beside the
service's dispatches, so on the card it takes no dispatch lock, issues its
work on a third stream of its own (B1 launches on the calling thread's
current stream, which is that stream), and waits for that stream's event
before it returns: the flip pays no scan. The flip takes the dispatch lock
for its pointer swaps (the caller has drained every launch by then:
`BatchVerifierService.quiesce_and`), and marks the new bank's tensors as
used on the verify stream, so the allocator reuses a released bank's
memory only after the verify stream is past every read of it.

Not ported yet (ROADMAP): meshes of several cards and the host failover
breaker.
"""

from __future__ import annotations

import random
import threading
import time
from collections import namedtuple
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as nnf

from handel_tpu_torch.core.bitset import BitSet
from handel_tpu_torch.core.trace import trace_now
from handel_tpu_torch.models import rlc
from handel_tpu_torch.models.bn254 import (
    BN254Constructor,
    BN254PublicKey,
    BN254Scheme,
    BN254Signature,
    hash_to_g1,
)
from handel_tpu_torch.ops import bn254_ref as bn
from handel_tpu_torch.ops.curve import BN254Curves, _tree_map
from handel_tpu_torch.ops.pairing import BN254Pairing

# Device-input arrays of one launch, as the packer hands them to dispatch:
# kind "range" = prefix-table path with a miss_k-wide hole patch, "dense" =
# masked registry sum; fields the kind does not use are None. `words` is
# the (C, W) uint64 bitset-word matrix (the dense launch unpacks it on the
# card); only the loop oracle fills the host-side (n, C) `mask`. Plans from
# `_pack_requests` view rotated staging buffers and stay valid until the
# rotation wraps back onto their set; `_pack_requests_loop` plans own theirs.
LaunchPlan = namedtuple(
    "LaunchPlan",
    "kind miss_k lo hi miss_idx miss_ok words mask sig_x sig_y valid",
)


class _StagingSet:
    """One set of host staging buffers for the launch packer.

    Each buffer is a torch tensor (pinned when the engine runs on the card)
    with a numpy view that the packer writes. `fence` is the completion
    event, on the verify stream, of the last launch that read this set:
    before the rotation rewrites the set, the packer waits on it, so an
    asynchronous copy still reading these buffers is never overwritten
    (backpressure, never corruption). The engine's dispatch lock keeps
    packing, rotation and fencing to one thread at a time."""

    __slots__ = ("tensors", "words", "valid", "lo", "hi", "miss", "miss_ok",
                 "sig_x", "sig_y", "fence")

    def __init__(self, n: int, C: int, miss_cap: int, nlimbs: int, pin: bool):
        shapes = {
            "words": ((C, (n + 63) // 64), torch.int64),
            "valid": ((C,), torch.bool),
            "lo": ((C,), torch.int32),
            "hi": ((C,), torch.int32),
            "miss": ((miss_cap, C), torch.int64),
            "miss_ok": ((miss_cap, C), torch.bool),
            "sig_x": ((nlimbs, C), torch.int32),
            "sig_y": ((nlimbs, C), torch.int32),
        }
        self.tensors = {
            k: torch.zeros(s, dtype=d, pin_memory=pin) for k, (s, d) in shapes.items()
        }
        for k, t in self.tensors.items():
            setattr(self, k, t.numpy())
        self.words = self.words.view(np.uint64)  # bitset words, as BitSet keeps them
        self.fence = None


class _WarmupSig:
    """Signature stand-in for warmup launches (the packer reads `.point`)."""

    __slots__ = ("point",)

    def __init__(self, point):
        self.point = point


class RegistryBank:
    """The registry on the device: affine G2 key coordinates as Fp2 pairs of
    (nlimbs, n) int32 Montgomery limbs, committed once, plus the prefix
    table (slot i = sum of keys [0, i), affine, with an infinity flag), built
    at the first range launch when not given."""

    __slots__ = ("reg_x", "reg_y", "n", "prefix")

    def __init__(self, reg_x, reg_y, prefix=None):
        self.reg_x, self.reg_y = reg_x, reg_y
        self.n = reg_x[0].shape[1]
        self.prefix = prefix

    def tensors(self) -> list[torch.Tensor]:
        """Every device tensor of the bank, prefix table included."""
        (x0, x1), (y0, y1) = self.reg_x, self.reg_y
        out = [x0, x1, y0, y1]
        if self.prefix is not None:
            (px0, px1), (py0, py1), inf = self.prefix
            out += [px0, px1, py0, py1, inf]
        return out


def bank_from_numpy(reg_x, reg_y, prefix=None, device=None) -> RegistryBank:
    """A bank from limb arrays as the JAX package's BN254Device holds them:
    `reg_x`/`reg_y` are Fp2 pairs of (nlimbs, n) uint32 arrays (its
    `_reg_x`/`_reg_y` through np.asarray), `prefix` optionally its
    ((x0, x1), (y0, y1), inf) prefix tuple. The limbs are < 2^16, so the
    int32 copy holds the same bits. They are taken as they are, in whatever
    Montgomery form the JAX device packed them: a bank from a JAX device on
    the rns backend (constant M) serves an engine whose curves are on the
    rns backend too, and equals that engine's own packing."""
    from handel_tpu_torch.utils.torchenv import resolve_device

    dev = resolve_device(device)

    def limbs(a):
        return torch.from_numpy(np.asarray(a).astype(np.int32)).to(dev)

    def f2(pair):
        return (limbs(pair[0]), limbs(pair[1]))

    if prefix is not None:
        (px, py, inf) = prefix
        prefix = (f2(px), f2(py), torch.from_numpy(np.array(inf, dtype=bool)).to(dev))
    return RegistryBank(f2(reg_x), f2(reg_y), prefix)


class BN254Device:
    """Verification engine bound to one registry on one device.

    `device` is where the launches run: the card unless the caller asks for
    "cpu" (then every kernel call takes its plain PyTorch version). `bank`
    replaces packing `registry_pubkeys` (see `bank_from_numpy`).
    `fp_backend` picks the field's multiply when `curves` is not given;
    `rns_resident` toggles the resident pairing (None: on exactly for the
    rns backend, True demands it). `batch_check` is "per_candidate" or
    "rlc"; `rlc_rng` draws the RLC scalars (default `random.SystemRandom`:
    they are adversary-facing)."""

    # the curve family, rebound by each family's subclass: its scalar
    # oracle, device curves and pairing, and its host hash and key types
    ref = bn
    Curves = BN254Curves
    Pairing = BN254Pairing
    _hash_to_g1 = staticmethod(hash_to_g1)
    PublicKey = BN254PublicKey
    Signature = BN254Signature

    # missing-signer patch width cap: candidates whose range hull has more
    # holes than this fall back to the dense class
    MISS_CAP = 64
    # dispatch-ahead bound for batch_verify: chunks in flight ahead of fetch
    MAX_DISPATCH_AHEAD = 4

    def __init__(
        self,
        registry_pubkeys: Sequence[BN254PublicKey] | None = None,
        batch_size: int = 16,
        curves: BN254Curves | None = None,
        device=None,
        batch_check: str = "per_candidate",
        bank: RegistryBank | None = None,
        fp_backend: str | None = None,
        rns_resident: bool | None = None,
        rlc_rng: random.Random | None = None,
    ):
        self.batch_check = rlc.validate_batch_check(batch_check)
        self._rlc_rng = rlc_rng
        self.rlc_stats = rlc.RlcStats()
        # launches whose lanes carried more than one message
        self.multi_msg_launches = 0
        self.curves = curves or self.Curves(device=device, backend=fp_backend)
        self.device = self.curves.device
        self.pairing = self.Pairing(self.curves, resident=rns_resident)
        self.batch_size = batch_size
        T = self.curves.T
        if bank is None:
            pts = [pk.point for pk in registry_pubkeys]
            if any(p is None for p in pts):
                raise ValueError("registry public keys must be valid G2 points")
            bank = RegistryBank(
                T.f2_pack([p[0] for p in pts]), T.f2_pack([p[1] for p in pts])
            )
        elif bank.reg_x[0].device != self.device:
            raise ValueError(f"bank on {bank.reg_x[0].device}, engine on {self.device}")
        self.bank = bank
        self.n = bank.n
        self._b2 = (T.f2_pack([self.ref.G2_GEN[0]]), T.f2_pack([self.ref.G2_GEN[1]]))
        self._h_cache: dict[bytes, tuple] = {}
        self._h_np_cache: dict[bytes, tuple] = {}
        # the combine's curves: always on the cios field (module docstring)
        self._combine_curves = (
            self.curves if self.curves.F.backend == "cios"
            else self.Curves(device=self.device, backend="cios")
        )
        # combine_batch's group-width classes (powers of two) that have run
        # once: the port's stand-in for the reference's compiled kernels
        self._combine_ready: set[int] = set()
        self.stage_sets = 2
        pin = self.device.type == "cuda"
        # verify and combine each on a stream of their own on the card (None
        # on the CPU, where torch.cuda.stream(None) changes nothing), and
        # one dispatch at a time (module docstring, "Threads")
        self._verify_stream = torch.cuda.Stream(self.device) if pin else None
        self._combine_stream = torch.cuda.Stream(self.device) if pin else None
        # registry staging's own stream (module docstring, "Epoch rotation")
        self._registry_stream = torch.cuda.Stream(self.device) if pin else None
        self._dispatch_lock = threading.Lock()
        # (event, trace_now()) recorded together on the idle verify stream:
        # the origin that `device_span` maps launch events from
        self._clock_anchor = None
        self._stage = [
            _StagingSet(self.n, batch_size, self.MISS_CAP, self.curves.F.nlimbs, pin)
            for _ in range(self.stage_sets)
        ]
        self._stage_idx = 0
        # host-cost counters: pack = building the plan in staging, dispatch =
        # the device handoff and the asynchronous enqueue that follows it
        self.host_pack_ms = 0.0
        self.host_pack_launches = 0
        self.host_dispatch_ms = 0.0
        self.host_dispatch_launches = 0
        # epoch rotation: `epoch` counts flips (0 is the construction-time
        # set); `_staged` is the next bank, built while this one serves
        self.epoch = 0
        self._staged: RegistryBank | None = None
        self.registry_stagings = 0
        self.registry_staged_ms = 0.0

    # -- registry bank and prefix table ---------------------------------------

    @property
    def _prefix(self):
        if self.bank.prefix is None:
            self.bank.prefix = self._build_prefix(self.bank.reg_x, self.bank.reg_y)
        return self.bank.prefix

    def _build_prefix(self, reg_x, reg_y):
        """Exclusive prefix table: inclusive prefix scan of the registry,
        batch affine conversion, one infinity slot in front."""
        g2 = self.curves.g2
        x, y, inf = g2.to_affine(g2.prefix_scan(g2.from_affine(reg_x, reg_y)))
        pad = lambda a: nnf.pad(a, (1, 0))  # noqa: E731
        one = torch.ones((1,), dtype=torch.bool, device=inf.device)
        return (pad(x[0]), pad(x[1])), (pad(y[0]), pad(y[1])), torch.cat([one, inf])

    # -- epoch rotation (lifecycle/epoch.py) -------------------------------------

    def stage_registry(
        self, registry_pubkeys: Sequence[BN254PublicKey], build_prefix: bool = True
    ) -> int:
        """Stage the NEXT validator set as a second bank on the device while
        the active one keeps serving launches. The host pack, the copy to
        the device and the prefix-table scan all happen here, on the
        registry stream without the dispatch lock, and are complete when
        this returns; `activate_staged` is then a pointer flip. Re-staging
        before activation replaces the pending bank (last staging wins).
        Returns the staged registry size."""
        t0 = time.perf_counter()
        T = self.curves.T
        pts = [pk.point for pk in registry_pubkeys]
        if any(p is None for p in pts):
            raise ValueError("staged registry keys must be valid G2 points")
        stream = self._registry_stream
        with torch.cuda.stream(stream):
            bank = RegistryBank(
                T.f2_pack([p[0] for p in pts]), T.f2_pack([p[1] for p in pts])
            )
            if build_prefix:
                # built NOW: the flip must never pay the scan
                bank.prefix = self._build_prefix(bank.reg_x, bank.reg_y)
            if stream is not None:
                done = torch.cuda.Event()
                done.record(stream)
                done.synchronize()
        self._staged = bank
        self.registry_stagings += 1
        self.registry_staged_ms += (time.perf_counter() - t0) * 1e3
        return bank.n

    def activate_staged(self) -> int:
        """Flip the staged bank live. The caller drains launches around this
        (lifecycle/epoch.py EpochManager.commit_rotation). Cheap by
        construction: pointer swaps, plus new staging buffers when the
        registry size changed. Returns the new epoch."""
        bank = self._staged
        if bank is None:
            raise RuntimeError("no staged registry: call stage_registry first")
        with self._dispatch_lock:
            if self._verify_stream is not None:
                for t in bank.tensors():
                    t.record_stream(self._verify_stream)
            self.bank = bank
            if bank.n != self.n:
                self.n = bank.n
                pin = self.device.type == "cuda"
                self._stage = [
                    _StagingSet(
                        self.n, self.batch_size, self.MISS_CAP,
                        self.curves.F.nlimbs, pin,
                    )
                    for _ in range(self.stage_sets)
                ]
                self._stage_idx = 0
            self._staged = None
            self.epoch += 1
        return self.epoch

    # -- the launch classes ------------------------------------------------------

    def _pairing_tail(self, agg, sig_x, sig_y, h_x, h_y, valid):
        """Affine-convert the aggregates and run the batched
        product-of-pairings check e(H, X_j) * e(-S_j, B2) == 1."""
        g2, F = self.curves.g2, self.curves.F
        agg_inf = g2.is_infinity(agg)
        qx, qy, _ = g2.to_affine(agg)
        (bx0, bx1), (by0, by1) = self._b2
        ok_lane = valid & ~agg_inf
        cat = lambda a, b: torch.cat([a, b], dim=1)  # noqa: E731
        px = cat(h_x.expand_as(sig_x), sig_x)
        py = cat(h_y.expand_as(sig_y), F.neg(sig_y))
        qx2 = (cat(qx[0], bx0.expand_as(qx[0])), cat(qx[1], bx1.expand_as(qx[1])))
        qy2 = (cat(qy[0], by0.expand_as(qy[0])), cat(qy[1], by1.expand_as(qy[1])))
        lane_mask = torch.cat([ok_lane, ok_lane])
        checks = self.pairing.pairing_check(
            (px, py), (qx2, qy2), lane_mask, self.batch_size
        )
        return checks & ok_lane

    def _unpack_words(self, words32, valid):
        """(C, 2W) int32 bitset words -> (n*C,) block-major candidate mask,
        on the device: a gather and a shift per registry index. int32 shifts
        are arithmetic, so every shift is masked with & 1."""
        idx = torch.arange(self.n, device=words32.device)
        w = words32[:, idx // 32]  # (C, n)
        bits = ((w >> (idx % 32).to(torch.int32)) & 1) != 0
        bits = bits & valid[:, None]  # invalid lanes contribute nothing
        return bits.T.reshape(-1)  # block i = registry key i across C lanes

    def _dense_aggregate(self, reg_x, reg_y, words32, valid):
        """Aggregate key per candidate (projective): masked G2 tree-sum over
        the registry tiled across the candidates."""
        C = self.batch_size
        g2 = self.curves.g2
        mask = self._unpack_words(words32, valid)
        tile = lambda a: a.repeat_interleave(C, dim=1)  # noqa: E731  (L, n) -> (L, n*C)
        P2 = g2.from_affine(
            (tile(reg_x[0]), tile(reg_x[1])), (tile(reg_y[0]), tile(reg_y[1]))
        )
        return g2.masked_sum(P2, mask, self.n)

    def _verify_batch(self, reg_x, reg_y, words32, sig_x, sig_y, h_x, h_y, valid):
        """Dense class: the masked registry sum, then the pairing tail.
        Returns (C,) verdicts."""
        agg = self._dense_aggregate(reg_x, reg_y, words32, valid)
        return self._pairing_tail(agg, sig_x, sig_y, h_x, h_y, valid)

    def _gather_prefix(self, prefix, idx):
        """(C,) indices -> projective G2 batch from the prefix table."""
        g2 = self.curves.g2
        (x0, x1), (y0, y1), inf = prefix
        idx = idx.long()
        take = lambda a: a.index_select(1, idx)  # noqa: E731
        P = g2.from_affine((take(x0), take(x1)), (take(y0), take(y1)))
        return g2.select(inf.index_select(0, idx), g2.infinity(idx.shape[0]), P)

    def _range_aggregate(self, lo, hi, miss_idx, miss_ok, prefix, reg_x, reg_y, miss_k):
        """Aggregate key per candidate (projective) =
        prefix[hi] - prefix[lo] - sum(missing signers in the hull)."""
        g2 = self.curves.g2
        hull = g2.add(
            self._gather_prefix(prefix, hi), g2.neg(self._gather_prefix(prefix, lo))
        )
        if miss_k:
            take = lambda a: a.index_select(1, miss_idx)  # noqa: E731
            Pm = g2.from_affine(
                (take(reg_x[0]), take(reg_x[1])), (take(reg_y[0]), take(reg_y[1]))
            )
            hull = g2.add(hull, g2.neg(g2.masked_sum(Pm, miss_ok, miss_k)))
        return hull

    def _verify_batch_range(
        self, lo, hi, miss_idx, miss_ok, sig_x, sig_y, h_x, h_y, valid,
        prefix, reg_x, reg_y, miss_k,
    ):
        """Range class: lo/hi (C,) prefix-table indices, miss_idx/miss_ok
        (miss_k*C,) block-major registry indices of the holes and their
        validity. Returns (C,) verdicts."""
        hull = self._range_aggregate(
            lo, hi, miss_idx, miss_ok, prefix, reg_x, reg_y, miss_k
        )
        return self._pairing_tail(hull, sig_x, sig_y, h_x, h_y, valid)

    # -- RLC combined-check launch class (models/rlc.py) ---------------------------

    # MSM digit width: 64-bit scalars run in 16 windowed steps of 15 buckets
    # each (ops/curve.py Curve.msm)
    RLC_WINDOW = 4

    def _rlc_msm_tail(self, agg, sig_x, sig_y, r_bits, group_oh, valid):
        """Shared MSM stage: per-candidate aggregates (projective G2, batch C)
        and signature lanes -> (S, X_g) in affine.

        S = sum_j r_j·sig_j is a G1 MSM over the C signature lanes (C blocks
        of batch 1); X_g = sum_{j in group g} r_j·apk_j tiles each candidate
        across the G group lanes (index j*G + g) with the scalar bits gated
        by the group one-hot, so one G2 MSM computes every message group at
        once. Scalars are masked to the launch hull by zeroing invalid
        lanes' bit columns, which then contribute the identity. The affine
        epilogue converts each output batch in one stacked-inversion
        `to_affine` call."""
        C = self.batch_size
        g1, g2 = self.curves.g1, self.curves.g2
        G = group_oh.shape[0]
        rb = r_bits * valid[None, :].to(r_bits.dtype)
        S = g1.msm(g1.from_affine(sig_x, sig_y), rb, C, window=self.RLC_WINDOW)

        def tile(a):  # (..., C) -> (..., C*G), index j*G + g <- lane j
            lead = tuple(a.shape[:-1])
            return a.reshape(lead + (C, 1)).expand(lead + (C, G)).reshape(lead + (C * G,))

        tiled = _tree_map(tile, agg)
        rb2 = (rb[:, :, None] * group_oh.T[None, :, :].to(rb.dtype)).reshape(rb.shape[0], C * G)
        X = g2.msm(tiled, rb2, C, window=self.RLC_WINDOW)
        sx, sy, s_inf = g1.to_affine(S)
        xx, xy, x_inf = g2.to_affine(X)
        return sx, sy, s_inf, xx, xy, x_inf

    def _rlc_msm_range(
        self, lo, hi, miss_idx, miss_ok, sig_x, sig_y, r_bits, group_oh,
        valid, prefix, reg_x, reg_y, miss_k,
    ):
        agg = self._range_aggregate(
            lo, hi, miss_idx, miss_ok, prefix, reg_x, reg_y, miss_k
        )
        return self._rlc_msm_tail(agg, sig_x, sig_y, r_bits, group_oh, valid)

    def _rlc_msm_dense(self, words32, sig_x, sig_y, r_bits, group_oh, valid, reg_x, reg_y):
        agg = self._dense_aggregate(reg_x, reg_y, words32, valid)
        return self._rlc_msm_tail(agg, sig_x, sig_y, r_bits, group_oh, valid)

    def _rlc_check(self, sx, sy, s_inf, xx, xy, x_inf, h_gx, h_gy, g_occ):
        """(G+1)-lane product of pairings with ONE shared final
        exponentiation: lanes 0..G-1 carry e(H(m_g), X_g), lane G carries
        e(-S, B2). Masked lanes contribute 1, which IS the factor an
        infinity operand would contribute (e(·, O) = e(O, ·) = 1), so
        infinity and padding lanes mask out without changing the product.
        Returns the (1,) verdict."""
        F = self.curves.F
        (bx0, bx1), (by0, by1) = self._b2
        cat = lambda a, b: torch.cat([a, b], dim=1)  # noqa: E731
        px = cat(h_gx, sx)
        py = cat(h_gy, F.neg(sy))
        qx = (cat(xx[0], bx0), cat(xx[1], bx1))
        qy = (cat(xy[0], by0), cat(xy[1], by1))
        lane_mask = torch.cat([g_occ & ~x_inf, ~s_inf])
        return self.pairing.pairing_check((px, py), (qx, qy), lane_mask, 1)

    def _rlc_combined_launch(self, items, sub):
        """One combined RLC check over candidate indices `sub` of `items`
        ((msg, bitset, sig) triples, pre-screened valid): fresh 64-bit
        scalars, message-grouped G2 MSM (the group count rounded up to a
        power of two), (G+1)-lane pairing tail. Enqueues on the current
        stream (the verify stream, under the dispatch lock) and returns
        (verdict, done) as `_dispatch_one` does."""
        t0 = time.perf_counter()
        C = self.batch_size
        plan = self._pack_requests([(items[j][1], items[j][2]) for j in sub])
        msgs = [items[j][0] for j in sub]
        uniq: dict[bytes, int] = {}
        gid = [uniq.setdefault(m, len(uniq)) for m in msgs]
        M = len(uniq)
        G = 1
        while G < M:
            G *= 2
        rs = rlc.draw_scalars(len(sub), self._rlc_rng)
        r_bits = np.zeros((rlc.SCALAR_BITS, C), np.int32)
        r_bits[:, : len(sub)] = self.Curves.scalar_bits64_np(rs)
        group_oh = np.zeros((G, C), bool)
        group_oh[gid, np.arange(len(sub))] = True
        g_occ = np.arange(G) < M
        # per-group H(m) columns (uniq is in group order); padded groups
        # repeat the last real column, masked out by g_occ
        cols = [self._h_cols(m) for m in uniq]
        hx = np.concatenate([c[0] for c in cols] + [cols[-1][0]] * (G - M), axis=1)
        hy = np.concatenate([c[1] for c in cols] + [cols[-1][1]] * (G - M), axis=1)
        t1 = time.perf_counter()
        self.host_pack_ms += (t1 - t0) * 1000.0
        self.host_pack_launches += 1
        staged = self._stage_plan(plan)
        put = self._put_host
        bank = self.bank
        if plan.kind == "range":
            lo, hi, mi, mo, sig_x, sig_y, valid = staged
            outs = self._rlc_msm_range(
                lo, hi, mi, mo, sig_x, sig_y, put(r_bits), put(group_oh), valid,
                self._prefix, bank.reg_x, bank.reg_y, plan.miss_k,
            )
        else:
            words32, sig_x, sig_y, valid = staged
            outs = self._rlc_msm_dense(
                words32, sig_x, sig_y, put(r_bits), put(group_oh), valid,
                bank.reg_x, bank.reg_y,
            )
        verdict, done = self._verdicts_out(
            self._rlc_check(*outs, put(hx), put(hy), put(g_occ))
        )
        self.rlc_stats.miller_lanes += G + 1
        self.rlc_stats.final_exp_lanes += 1
        if M > 1:
            self.multi_msg_launches += 1
        self.host_dispatch_ms += (time.perf_counter() - t1) * 1000.0
        self.host_dispatch_launches += 1
        return verdict, done

    def _dispatch_rlc(self, items):
        """RLC-mode dispatch (under the dispatch lock, on the verify stream):
        pre-screen validity on the host (the packer's own criterion), launch
        the combined check over the valid lanes now, asynchronously, and
        leave the verdicts, bisection relaunches included, to `fetch`."""
        valid_j = [
            j
            for j, (_m, bs, sig) in enumerate(items)
            if bs.cardinality() > 0 and getattr(sig, "point", None) is not None
        ]
        top = self._rlc_combined_launch(items, valid_j) if len(valid_j) > 1 else None
        return ("rlc", items, valid_j, top, len(items))

    def _fetch_rlc(self, handle):
        """Resolve an RLC handle: a passing combined check accepts every
        valid lane; a failing one bisects with fresh scalars down to the
        per-candidate oracle (`_dispatch_one` on the single candidate), so
        culprits are isolated and attributed exactly as per_candidate mode
        would. Invalid lanes are False without any device work. Runs on the
        fetching thread: each relaunch takes the dispatch lock and the
        verify stream like any dispatch, and is waited for outside the
        lock."""
        _, items, valid_j, top, k = handle[:5]
        verdicts = [False] * k
        pending = [top]

        def combined(sub):
            launch, pending[0] = pending[0], None
            if launch is None or len(sub) != len(valid_j):
                launch = self._issue(self._rlc_combined_launch, items, sub)
            return self._first_verdict(launch)

        def oracle(j):
            msg, bs, sig = items[j]
            return self._first_verdict(self._issue(self._dispatch_one, msg, [(bs, sig)]))

        for j, ok in rlc.bisect_verify(valid_j, combined, oracle, self.rlc_stats).items():
            verdicts[j] = ok
        return verdicts

    def _issue(self, fn, *args):
        """fn(*args) as a dispatch: under the lock, on the verify stream."""
        return self._issue_timed(fn, *args)[0]

    def _issue_timed(self, fn, *args):
        """`_issue`, returning (fn(*args), events): on the card the launch's
        timing events, recorded on the verify stream before its first op
        and after its last; None on the CPU."""
        with self._dispatch_lock, torch.cuda.stream(self._verify_stream):
            stream = self._verify_stream
            if stream is None:
                return fn(*args), None
            if self._clock_anchor is None:
                stream.synchronize()  # idle: the anchor runs as recorded
                anchor = torch.cuda.Event(enable_timing=True)
                self._clock_anchor = (anchor, trace_now())
                anchor.record(stream)
            first = torch.cuda.Event(enable_timing=True)
            first.record(stream)
            out = fn(*args)
            last = torch.cuda.Event(enable_timing=True)
            last.record(stream)
            return out, (first, last)

    def device_span(self, handle):
        """(start, end) of a fetched launch on the verify stream, in
        `trace_now` seconds: its first op to its last. None on the CPU."""
        events = handle[-1]
        if events is None:
            return None
        first, last = events
        last.synchronize()
        anchor, t0 = self._clock_anchor
        return (
            t0 + anchor.elapsed_time(first) / 1e3,
            t0 + anchor.elapsed_time(last) / 1e3,
        )

    @staticmethod
    def _first_verdict(launch) -> bool:
        verdicts, done = launch
        if done is not None:
            done.synchronize()
        return bool(verdicts[0])

    # -- host entry points -------------------------------------------------------

    def _h_point(self, msg: bytes):
        """H(msg) as (nlimbs, 1) device limb columns, hashed once per message."""
        cached = self._h_cache.get(msg)
        if cached is None:
            h = self._hash_to_g1(msg)
            F = self.curves.F
            cached = self._h_cache[msg] = (F.pack([h[0]]), F.pack([h[1]]))
        return cached

    def batch_verify(self, msg: bytes, requests) -> list[bool]:
        """Verify (bitset, aggregate signature) candidates, batch_size per
        launch; a launch is dispatched before earlier verdicts are fetched,
        at most MAX_DISPATCH_AHEAD ahead of the fetch cursor."""
        out: list[bool] = []
        window: list = []
        for i in range(0, len(requests), self.batch_size):
            if len(window) >= self.MAX_DISPATCH_AHEAD:
                out.extend(self.fetch(window.pop(0)))
            window.append(self.dispatch(msg, requests[i : i + self.batch_size]))
        for h in window:
            out.extend(self.fetch(h))
        return out

    def dispatch(self, msg, requests):
        """Enqueue one launch (<= batch_size candidates) on the verify
        stream; returns a handle for `fetch`. On the card the work, and the
        copy of its verdicts to pinned host memory, are in flight when this
        returns. Safe to call from any thread; dispatches run one at a
        time. In RLC mode the handle carries the combined check in flight;
        bisection, if any, runs at `fetch`."""
        if self.batch_check == "rlc":
            rlc_handle, events = self._issue_timed(
                self._dispatch_rlc, [(msg, bs, sig) for bs, sig in requests]
            )
            return rlc_handle + (events,)
        (verdicts, done), events = self._issue_timed(self._dispatch_one, msg, requests)
        return (verdicts, len(requests), done, events)

    def fetch(self, handle) -> list[bool]:
        """Wait for a dispatched launch's verdicts; host-ordered. Waits on
        the launch's completion event only, so it neither waits for a later
        launch nor enqueues anything (an RLC bisection enqueues its
        relaunches as dispatches do); safe from any thread."""
        if isinstance(handle[0], str):
            return self._fetch_rlc(handle)
        verdicts, k, done = handle[:3]
        if done is not None:
            done.synchronize()
        return [bool(v) for v in verdicts[:k].tolist()]

    # -- multi-message launches (the service's cross-session coalescing) --------

    def _h_cols(self, msg: bytes):
        """Host (nlimbs, 1) limb columns of H(msg), hashed once per message:
        the numpy counterpart of `_h_point`, for building per-lane and
        per-group H columns without reading the device."""
        cached = self._h_np_cache.get(msg)
        if cached is None:
            h = self._hash_to_g1(msg)
            F = self.curves.F
            cached = self._h_np_cache[msg] = (F.pack_batch_np([h[0]]), F.pack_batch_np([h[1]]))
        return cached

    def _h_lanes(self, msgs):
        """(nlimbs, C) per-lane H(m) limbs for a mixed-message launch: the
        distinct messages' columns scattered to their lanes; padded lanes
        (masked invalid) repeat the last real column."""
        C = self.batch_size
        uniq: dict[bytes, int] = {}
        inv = np.array([uniq.setdefault(m, len(uniq)) for m in msgs], np.int64)
        cols = [self._h_cols(m) for m in uniq]
        inv = np.concatenate([inv, np.full(C - len(msgs), inv[-1], np.int64)])
        hx = np.concatenate([c[0] for c in cols], axis=1)[:, inv]
        hy = np.concatenate([c[1] for c in cols], axis=1)[:, inv]
        return self._put_host(hx), self._put_host(hy)

    def dispatch_multi(self, items):
        """Enqueue one launch whose lanes may carry DIFFERENT messages — the
        shared verifier's cross-session coalescing contract
        (parallel/batch_verifier.py): items are (msg, pubkeys, bitset, sig);
        pubkeys are ignored, the resident registry is every lane's key
        universe. A one-message batch is an ordinary `dispatch`; mixed
        messages stage per-lane (nlimbs, C) H(m) columns into the same
        launch classes. Returns a `fetch` handle.

        In RLC mode mixed messages GROUP rather than widen: the combined
        check costs one Miller loop per distinct message plus one."""
        if self.batch_check == "rlc":
            rlc_handle, events = self._issue_timed(
                self._dispatch_rlc, [(it[0], it[2], it[3]) for it in items]
            )
            return rlc_handle + (events,)
        msgs = [it[0] for it in items]
        reqs = [(it[2], it[3]) for it in items]
        if len(set(msgs)) <= 1:
            return self.dispatch(msgs[0] if msgs else b"", reqs)
        (verdicts, done), events = self._issue_timed(self._dispatch_one, None, reqs, msgs)
        return (verdicts, len(reqs), done, events)

    # -- batched aggregate combine (the store's merge path) ---------------------

    def combine_batch(self, groups, compiled_only: bool = False):
        """Sum many groups of G1 points — aggregate-signature merges — in
        one launch per batch_size chunk.

        `groups` is a sequence of point sequences (affine scalar-oracle
        tuples, None = infinity); returns one combined affine point (or
        None for infinity) per group. Each chunk's group width is quantized
        to a power of two k >= 2, its class. `compiled_only=True` (the
        CombineShim path) declines with None entries, for the caller to
        fold on the host, any chunk whose class has not run yet; `warmup`
        runs the classes 2, 4 and 8, and any call with
        `compiled_only=False` adds its class. A decline looks like an
        infinity sum, which callers redo on the host the same way."""
        out = []
        with torch.cuda.stream(self._combine_stream):
            for i in range(0, len(groups), self.batch_size):
                out.extend(
                    self._combine_chunk(groups[i : i + self.batch_size], compiled_only)
                )
        return out

    def _combine_chunk(self, groups, compiled_only: bool = False):
        C = self.batch_size
        kmax = max((len(g) for g in groups), default=1)
        k = 2
        while k < kmax:
            k *= 2
        if compiled_only and k not in self._combine_ready:
            return [None] * len(groups)
        # block-major grid: block i = element i of every group's sum
        flat = [None] * (k * C)
        mask = np.zeros((k, C), bool)
        for j, g in enumerate(groups):
            for i, p in enumerate(g):
                flat[i * C + j] = p
                mask[i, j] = p is not None
        curves = self._combine_curves
        g1, F = curves.g1, curves.F
        P = curves.pack_g1(flat)
        x, y, inf = g1.to_affine(
            g1.masked_sum(P, torch.from_numpy(mask.reshape(-1)).to(self.device), k)
        )
        self._combine_ready.add(k)
        xs, ys = F.unpack(x), F.unpack(y)
        infs = inf.cpu().tolist()
        return [None if infs[j] else (xs[j], ys[j]) for j in range(len(groups))]

    def warmup(self) -> int:
        """Build and load the kernel library and the prefix table with one
        range launch, and run the combine classes k = 2, 4 and 8 (pairwise
        merges through wide patch chains; the CombineShim path combines on
        the device only in classes that have run), so the first round pays
        for none of them, and no two threads of a service race to build
        them. In RLC mode a single-candidate dispatch resolves through the
        per-candidate oracle, and one two-candidate launch then runs the
        RLC class: the warmup signature is not valid, so its combined check
        fails and the bisection's oracle launches run too. No launch of
        several messages runs: the per-lane H(m) columns go through the
        same eager ops as one message's, so such a launch would build
        nothing the first real one reuses. Returns the number of launches
        issued (a bisection counts as one)."""
        bs = BitSet(self.n)
        for i in range(min(self.n, 2)):
            bs.set(i, True)
        sig = _WarmupSig(self.ref.G1_GEN)
        self.fetch(self.dispatch(b"bn254-device-warmup", [(bs, sig)]))
        launches = 1
        if self.batch_check == "rlc":
            self.fetch(self.dispatch(b"bn254-device-warmup", [(bs, sig)] * 2))
            launches += 1
        for k in (2, 4, 8):
            self.combine_batch([[self.ref.G1_GEN] * k])
            launches += 1
        if self.device.type == "cuda":
            # the prefix table was written on the verify stream: every later
            # reader, on whichever stream or thread, sees it complete
            torch.cuda.synchronize(self.device)
        self.reset_host_counters()
        return launches

    def reset_host_counters(self) -> None:
        """Zero the host pack/dispatch cost counters and the RLC counters
        (warmup and phase boundaries: accumulation starts at the phase)."""
        self.host_pack_ms = 0.0
        self.host_pack_launches = 0
        self.host_dispatch_ms = 0.0
        self.host_dispatch_launches = 0
        self.rlc_stats = rlc.RlcStats()

    # -- the launch packer -------------------------------------------------------

    @staticmethod
    def _pack_sig_limbs(F, pts, out):
        """Pack G1 coordinate limbs into staging, converting each distinct
        point object once (one aggregate is often fanned across lanes)."""
        uniq: dict[int, int] = {}
        inv = np.empty((len(pts),), np.int64)
        upts: list = []
        for j, p in enumerate(pts):
            i = uniq.get(id(p))
            if i is None:
                i = uniq[id(p)] = len(upts)
                upts.append(p)
            inv[j] = i
        out.sig_x[:] = F.pack_batch_np([p[0] for p in upts])[:, inv]
        out.sig_y[:] = F.pack_batch_np([p[1] for p in upts])[:, inv]

    _U64_ONES = np.uint64(0xFFFFFFFFFFFFFFFF)

    @classmethod
    def _ones_below(cls, c):
        """(1 << c) - 1 for per-element widths c in [0, 64]."""
        shift = np.minimum(c, np.uint64(63))
        return np.where(c >= 64, cls._U64_ONES, (np.uint64(1) << shift) - np.uint64(1))

    def _pack_requests(self, requests) -> LaunchPlan:
        """Vectorized launch packing: requests -> staging arrays.

        Bitsets (anything with `len()` and `words()`, the JAX package's
        BitSet included) hand their uint64 words to the staging set; the
        cardinality, the range bounds and the holes come from word-level
        numpy. Bit-identical to `_pack_requests_loop`, the readable oracle."""
        C = self.batch_size
        n = self.n
        k = len(requests)
        self._stage_idx = (self._stage_idx + 1) % len(self._stage)
        st = self._stage[self._stage_idx]
        if st.fence is not None:
            # the last launch that read this set must be past its copies
            st.fence.synchronize()
            st.fence = None
        words = st.words
        words[:] = 0
        valid = st.valid
        valid[:] = False
        sig_pts: list = []
        for j, (bs, sig) in enumerate(requests):
            if len(bs) != n:
                raise ValueError("bitset length != registry size")
            words[j, :] = bs.words()
            sig_pts.append(getattr(sig, "point", None))

        card = np.bitwise_count(words).sum(axis=1, dtype=np.int64)
        if k:
            valid[:k] = (card[:k] > 0) & np.fromiter(
                (p is not None for p in sig_pts), bool, count=k
            )
        words[~valid] = 0  # invalid lanes contribute nothing

        # range bounds: first/last nonzero word per lane, then a trailing-
        # zero / leading-bit scan of those edge words
        wnz = words != 0
        nonempty = wnz.any(axis=1)
        W = words.shape[1]
        rows = np.arange(C)
        fw = wnz.argmax(axis=1)
        lw = (W - 1) - wnz[:, ::-1].argmax(axis=1)
        wf = words[rows, fw]
        tz = np.bitwise_count((wf & (~wf + np.uint64(1))) - np.uint64(1)).astype(np.int64)
        v = words[rows, lw].copy()  # leading bit: smear right, popcount - 1
        for s in (1, 2, 4, 8, 16, 32):
            v |= v >> np.uint64(s)
        msb = np.bitwise_count(v).astype(np.int64) - 1
        lo, hi = st.lo, st.hi
        lo[:] = np.where(nonempty, fw * 64 + tz, 0)
        hi[:] = np.where(nonempty, lw * 64 + msb + 1, 0)  # one past the last bit
        holes = (hi.astype(np.int64) - lo) - np.where(valid, card, 0)
        max_holes = int(holes.max())

        pts = [pt if valid[j] else self.ref.G1_GEN for j, pt in enumerate(sig_pts)]
        pts += [self.ref.G1_GEN] * (C - k)  # pad lanes
        self._pack_sig_limbs(self.curves.F, pts, st)

        if max_holes > self.MISS_CAP:  # dense class: the words are the input
            return LaunchPlan(
                "dense", 0, None, None, None, None, words, None,
                st.sig_x, st.sig_y, valid,
            )

        # two patch-width classes, as in the reference
        miss_k = 8 if max_holes <= 8 else self.MISS_CAP
        miss_idx = st.miss[:miss_k]
        miss_ok = st.miss_ok[:miss_k]
        miss_idx[:] = 0
        miss_ok[:] = False
        if max_holes > 0:
            # hole bits = ~words inside each lane's [lo, hi) hull
            base = np.arange(W, dtype=np.int64) * 64
            lo_c = np.clip(lo.astype(np.int64)[:, None] - base, 0, 64)
            hi_c = np.clip(hi.astype(np.int64)[:, None] - base, 0, 64)
            hull = self._ones_below(hi_c.astype(np.uint64)) ^ self._ones_below(
                lo_c.astype(np.uint64)
            )
            missw = hull & ~words
            mbits = np.unpackbits(
                missw.view(np.uint8), axis=1, count=n, bitorder="little"
            ).view(np.bool_)
            rj, cj = np.nonzero(mbits)  # row-major: per candidate, ascending
            if rj.size:
                counts = mbits.sum(axis=1)
                offs = np.concatenate(([0], np.cumsum(counts)[:-1]))
                pos = np.arange(rj.size) - offs[rj]
                miss_idx[pos, rj] = cj
                miss_ok[pos, rj] = True
        return LaunchPlan(
            "range", miss_k, lo, hi, miss_idx, miss_ok, words, None,
            st.sig_x, st.sig_y, valid,
        )

    def _pack_requests_loop(self, requests) -> LaunchPlan:
        """The per-candidate packer, kept as the oracle of `_pack_requests`.
        Allocates fresh numpy arrays (no staging)."""
        C = self.batch_size
        F = self.curves.F
        sig_pts = []
        valid = np.zeros((C,), dtype=bool)
        sets: list[np.ndarray] = []
        for j, (bs, sig) in enumerate(requests):
            if len(bs) != self.n:
                raise ValueError("bitset length != registry size")
            idx = np.fromiter(bs.indices(), dtype=np.int64)
            sig_pt = getattr(sig, "point", None)
            if idx.size and sig_pt is not None:
                valid[j] = True
                sig_pts.append(sig_pt)
            else:
                sig_pts.append(self.ref.G1_GEN)  # placeholder, lane masked out
            sets.append(idx)
        sig_pts += [self.ref.G1_GEN] * (C - len(sig_pts))  # pad lanes
        sig_x = F.pack_batch_np([p[0] for p in sig_pts])
        sig_y = F.pack_batch_np([p[1] for p in sig_pts])

        holes = [
            int(idx[-1] - idx[0] + 1 - idx.size) if v and idx.size else 0
            for idx, v in zip(sets, valid)
        ]
        if max(holes, default=0) > self.MISS_CAP:
            mask = np.zeros((self.n, C), dtype=bool)
            for j, idx in enumerate(sets):
                if valid[j] and idx.size:
                    mask[idx, j] = True
            return LaunchPlan(
                "dense", 0, None, None, None, None, None, mask, sig_x, sig_y, valid,
            )
        lo = np.zeros((C,), np.int32)
        hi = np.zeros((C,), np.int32)
        miss_k = 8 if max(holes, default=0) <= 8 else self.MISS_CAP
        miss_idx = np.zeros((miss_k, C), np.int64)
        miss_ok = np.zeros((miss_k, C), dtype=bool)
        for j, idx in enumerate(sets):
            if not valid[j] or not idx.size:
                continue
            lo[j] = idx[0]
            hi[j] = idx[-1] + 1
            missing = np.setdiff1d(
                np.arange(idx[0], idx[-1] + 1), idx, assume_unique=True
            )
            miss_idx[: missing.size, j] = missing
            miss_ok[: missing.size, j] = True
        return LaunchPlan(
            "range", miss_k, lo, hi, miss_idx, miss_ok, None, None, sig_x, sig_y, valid,
        )

    def _stage_plan(self, plan):
        """Copy one plan's staging views to the device (asynchronously from
        pinned memory on the card; the staging fence keeps the buffers
        alive). Returns the per-kind device-argument tuple."""
        dev = self.device

        def put(a):
            return torch.from_numpy(a).to(dev, non_blocking=True)

        if plan.kind == "range":
            return (
                put(plan.lo), put(plan.hi),
                put(plan.miss_idx.reshape(-1)), put(plan.miss_ok.reshape(-1)),
                put(plan.sig_x), put(plan.sig_y), put(plan.valid),
            )
        words32 = put(plan.words.view(np.int64)).view(torch.int32)  # (C, 2W)
        return (words32, put(plan.sig_x), put(plan.sig_y), put(plan.valid))

    def _run_plan(self, plan, staged, h_x, h_y):
        bank = self.bank
        if plan.kind == "range":
            lo, hi, miss_idx, miss_ok, sig_x, sig_y, valid = staged
            return self._verify_batch_range(
                lo, hi, miss_idx, miss_ok, sig_x, sig_y, h_x, h_y, valid,
                self._prefix, bank.reg_x, bank.reg_y, plan.miss_k,
            )
        words32, sig_x, sig_y, valid = staged
        return self._verify_batch(
            bank.reg_x, bank.reg_y, words32, sig_x, sig_y, h_x, h_y, valid
        )

    def _put_host(self, a: np.ndarray):
        """A per-launch host array to the device without waiting: through a
        pinned copy on the card (the caching host allocator keeps it until
        the copy is done), as it is on the CPU."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _verdicts_out(self, verdicts):
        """(verdicts, done) for a launch just enqueued on the current stream:
        on the card the verdicts are copied to pinned host memory and `done`
        is the launch's completion event, which also fences the staging set
        the launch reads (`_pack_requests` waits on it before the rotation
        wraps back onto these buffers); on the CPU they are computed and
        `done` is None."""
        if self.device.type != "cuda":
            return verdicts, None
        host = torch.empty(verdicts.shape, dtype=verdicts.dtype, pin_memory=True)
        host.copy_(verdicts, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        self._stage[self._stage_idx].fence = done
        return host, done

    def _dispatch_one(self, msg, requests, msgs=None):
        """Pack, stage and enqueue one per-candidate launch on the current
        stream (the verify stream, under the dispatch lock): every lane on
        H(msg), or lane j on H(msgs[j]) when `msgs` is given (a mixed-message
        launch). Returns (verdicts, done) as `_verdicts_out`."""
        t0 = time.perf_counter()
        plan = self._pack_requests(requests)
        t1 = time.perf_counter()
        self.host_pack_ms += (t1 - t0) * 1000.0
        self.host_pack_launches += 1
        h_x, h_y = self._h_point(msg) if msgs is None else self._h_lanes(msgs)
        out = self._verdicts_out(self._run_plan(plan, self._stage_plan(plan), h_x, h_y))
        if msgs is not None:
            self.multi_msg_launches += 1
        self.host_dispatch_ms += (time.perf_counter() - t1) * 1000.0
        self.host_dispatch_launches += 1
        return out


class BN254TorchConstructor(BN254Constructor):
    """Constructor whose `batch_verify` runs on the port's device engine.

    The engine is built from the pubkey sequence of the first call (Handel
    passes the same registry list every time) or eagerly by `prepare()`.
    Marshal/unmarshal and single-signature verify stay on the host.
    `fp_backend` ("cios"/"rns") picks the field's multiply; an explicit
    `curves` wins, carrying its own field. `rns_resident`, `batch_check`
    and `rlc_rng` as BN254Device."""

    Device = BN254Device

    def __init__(
        self,
        batch_size: int = 16,
        device=None,
        warmup: bool = True,
        batch_check: str = "per_candidate",
        curves: BN254Curves | None = None,
        fp_backend: str | None = None,
        rns_resident: bool | None = None,
        rlc_rng: random.Random | None = None,
    ):
        self.batch_size = batch_size
        self.batch_check = rlc.validate_batch_check(batch_check)
        self._rlc_rng = rlc_rng
        self.fp_backend = fp_backend
        self.rns_resident = rns_resident
        self.curves = curves or self.Device.Curves(device=device, backend=fp_backend)
        self.warmup = warmup
        self._device: BN254Device | None = None
        self._device_for: int | None = None

    def prepare(self, pubkeys: Sequence[BN254PublicKey]) -> BN254Device:
        self._device = self.Device(
            pubkeys,
            batch_size=self.batch_size,
            curves=self.curves,
            batch_check=self.batch_check,
            rns_resident=self.rns_resident,
            rlc_rng=self._rlc_rng,
        )
        if self.warmup:
            self._device.warmup()
        # hold the list itself: the id() key below is valid only while the
        # original object lives
        self._reg_list = pubkeys
        self._device_for = id(pubkeys)
        self._reg_keys = [pk.point for pk in pubkeys]
        return self._device

    def _device_of(self, pubkeys) -> BN254Device:
        if self._device is None or self._device.n != len(pubkeys):
            self.prepare(pubkeys)
        elif self._device_for != id(pubkeys):
            # same length, new list object: a full content check once per
            # list identity (a same-size registry after churn must not
            # verify against stale keys)
            if [pk.point for pk in pubkeys] == self._reg_keys:
                self._reg_list = pubkeys
                self._device_for = id(pubkeys)
            else:
                self.prepare(pubkeys)
        return self._device

    def batch_verify(self, msg, pubkeys, requests) -> list[bool]:
        return self._device_of(pubkeys).batch_verify(msg, requests)

    def device_combine(self, groups):
        """Batched aggregate combine for core/processing.py `CombineShim`:
        sum each group of G1 signature points on the device, in the classes
        that have run (`combine_batch(compiled_only=True)`; a None entry
        asks the shim to fold that group on the host). Returns None until
        the device exists: the shim must never force the registry upload.
        A launch error raises: no host fold hides a failing device."""
        if self._device is None:
            return None
        return self._device.combine_batch(groups, compiled_only=True)


class BN254TorchScheme(BN254Scheme):
    """Keygen facade for harnesses: the host scheme's keygen and wire formats
    with the device-verification constructor."""

    def __init__(
        self,
        batch_size: int = 16,
        device=None,
        warmup: bool = True,
        batch_check: str = "per_candidate",
        fp_backend: str | None = None,
        rns_resident: bool | None = None,
        rlc_rng: random.Random | None = None,
    ):
        self.constructor = BN254TorchConstructor(
            batch_size=batch_size, device=device, warmup=warmup,
            batch_check=batch_check, fp_backend=fp_backend,
            rns_resident=rns_resident, rlc_rng=rlc_rng,
        )

