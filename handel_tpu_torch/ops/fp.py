"""Prime-field arithmetic on limb tensors — counterpart of handel_tpu/ops/fp.py.

Layout and dtype, stated once for the whole port: an Fp batch is a
**torch.int32** tensor of shape (nlimbs, B) holding 16-bit limbs,
little-endian limb order, limbs-major (one element per column). That is the
JAX package's layout with int32 storage in place of uint32: torch has no
uint32 add, shift or compare on the CPU, and every limb is < 2^16, so the
bits are the same and arrays pass between the packages through numpy
unchanged. Values are canonical (< p) at op boundaries and in Montgomery
form (R = 2^(16 nlimbs)) except where a method says otherwise. BN254 has 16
limbs, BLS12-381 24.

* `add`/`sub`/`neg` use the reference's packed carry-lookahead: per-limb
  generate/propagate bits packed into one word per column, the carry
  closure taken with the adder identity carries(A+B) = A ^ B ^ (A+B).
* `mul` is the Montgomery product. On a CUDA tensor it launches the
  hand-written Hopper kernel (csrc/fp_mont.cu, bound in kernels/fp_mont.py)
  or raises; on a CPU tensor it runs `_mul_plain`, the reference's
  `_mul_cols_vec` column algebra in int64, which is also the yardstick the
  kernel is held against on the card. Which one runs is decided by the
  tensor's device and nothing else.
* Callers stack independent multiplies into one wide call (ops/tower.py),
  so an Fp12 multiply is one `mul` at 54x the batch width.

`backend` picks the modular multiply, as in the reference: "cios" (this
class, kernel B1) or "rns" (ops/rns.py `RnsField`, which `__new__`
redirects to; its resident products run kernel B2). Canonical
non-Montgomery boundary values are bit-identical across backends.

`chained_marginal` is the one throughput method of the port's labs: the
slope between two depths of a chain of dependent calls, each chain captured
once in a CUDA graph on the card. `python -m handel_tpu_torch.ops.fp [batch]
[backend]` prints the production field's marginal mont-muls/s on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from handel_tpu_torch.kernels.fp_mont import mont_mul
from handel_tpu_torch.utils.torchenv import resolve_device

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1

# 4-bit windows: the executed-multiply count of a public-exponent power
# (77 multiplies for the 254-bit Fermat inverse instead of 253). The
# reference picks 1 on XLA:CPU only to keep compile graphs small; eager
# torch compiles nothing, and the result is the same for every window.
DEFAULT_POW_WINDOW = 4


def _int_to_limbs(x: int, nlimbs: int) -> np.ndarray:
    if x >> (LIMB_BITS * nlimbs):
        raise ValueError("value too large for limb count")
    return np.array(
        [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(nlimbs)], np.int32
    )


def windowed_pow_digits(e: int, window: int) -> list[int] | None:
    """MSB-first w-bit digits of a public exponent, or None when the exponent
    is short enough that a direct chain beats the table (shared by
    Field.pow_const and Tower.f12_pow_const)."""
    bits = bin(e)[2:]
    if len(bits) <= window:
        return None
    pad = (-len(bits)) % window
    padded = "0" * pad + bits
    return [int(padded[i : i + window], 2) for i in range(0, len(padded), window)]


def windowed_pow(a, e: int, window: int, mul, sqr):
    """Left-to-right windowed square-and-multiply for a public exponent e.

    The exponent is a static Python int, so the digit loop runs on the host
    and a zero digit simply skips its multiply (the reference computes it
    and discards it with a select, because its scan body is traced once);
    the result is the same. window <= 1 is the plain bit scan."""
    digits = None if window <= 1 else windowed_pow_digits(e, window)
    if digits is None:  # bit scan / short exponent: direct chain
        acc = a
        for c in bin(e)[3:]:
            acc = sqr(acc)
            if c == "1":
                acc = mul(acc, a)
        return acc
    table = [a]  # table[k] = a^(k+1)
    for _ in range(2**window - 2):
        table.append(mul(table[-1], a))
    acc = table[digits[0] - 1]  # the MSB digit is nonzero by construction
    for d in digits[1:]:
        for _ in range(window):
            acc = sqr(acc)
        if d:
            acc = mul(acc, table[d - 1])
    return acc


class Field:
    """Modular arithmetic over a fixed prime on int32 limb tensors.

    Methods take and return (nlimbs, B) int32 tensors; `device` is where
    the host conversions put their results (default: the card). `backend`
    "rns" constructs an `RnsField` instead (ops/rns.py)."""

    backend = "cios"
    limb_dtype = torch.int32

    def __new__(cls, p: int = 0, backend: str | None = None, device=None):
        if cls is Field and backend == "rns":
            from handel_tpu_torch.ops.rns import RnsField  # lazy: avoid a cycle

            return super().__new__(RnsField)
        return super().__new__(cls)

    def __init__(self, p: int, backend: str | None = None,
                 device: str | torch.device | None = None):
        if backend not in (None, "cios", "rns"):
            raise ValueError(
                f"unknown Field backend {backend!r}: valid choices are 'cios' "
                f"(Montgomery kernel B1) and 'rns' (residue pipeline, ops/rns.py)"
            )
        self.p = p
        self.device = resolve_device(device)
        self.nlimbs = n = (p.bit_length() + LIMB_BITS - 1) // LIMB_BITS
        if n % 2 or n >= 31:
            raise ValueError(f"unsupported limb count {n} for p")
        self.mont_r = (1 << (LIMB_BITS * n)) % p
        self.mont_r2 = self.mont_r * self.mont_r % p
        # -p^{-1} mod 2^16: the column algebra's reduction multiplier
        self.n0 = int((-pow(p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS))
        # the kernel works in 32-bit words: p as n/2 words, -p^{-1} mod 2^32
        self.p_words = [(p >> (32 * k)) & 0xFFFFFFFF for k in range(n // 2)]
        self.n0_32 = int((-pow(p, -1, 1 << 32)) % (1 << 32))
        self.p_limbs_np = _int_to_limbs(p, n)
        dev = self.device
        self.p_col = torch.from_numpy(self.p_limbs_np).to(dev)[:, None]
        self._p_col64 = self.p_col.long()
        ar = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
        self._shifts = ar
        self._bit_weights = torch.ones_like(ar) << ar
        # column index i + j of limb product a_i * b_j, flattened over (i, j)
        ij = torch.arange(n)[:, None] + torch.arange(n)[None, :]
        self._ij = ij.reshape(-1).to(dev)
        self._consts: dict[int, torch.Tensor] = {}
        # R^2 mod p as plain limbs (to_mont(a) = mul(a, R^2)), built at the
        # first to_mont: a subclass may still change its Montgomery constant
        self._r2: torch.Tensor | None = None

    # -- host-side conversions ----------------------------------------------

    def pack_batch_np(self, xs, mont: bool = True) -> np.ndarray:
        """List of ints -> (nlimbs, len(xs)) int32 limb array as numpy
        (Montgomery by default)."""
        mult = self.mont_r if mont else 1
        p = self.p
        lbytes = LIMB_BITS // 8
        buf = b"".join(
            (x % p * mult % p).to_bytes(self.nlimbs * lbytes, "little") for x in xs
        )
        arr = np.frombuffer(buf, dtype=np.dtype(f"<u{lbytes}")).reshape(
            len(xs), self.nlimbs
        )
        return np.ascontiguousarray(arr.T, dtype=np.int32)

    def pack(self, xs, mont: bool = True) -> torch.Tensor:
        """List of ints -> (nlimbs, len(xs)) limb tensor on this field's device."""
        return torch.from_numpy(self.pack_batch_np(xs, mont)).to(self.device)

    def unpack(self, limbs, mont: bool = True) -> list[int]:
        """(nlimbs, B) limb array -> list of ints (from Montgomery by default)."""
        if isinstance(limbs, torch.Tensor):
            limbs = limbs.cpu().numpy()
        arr = np.ascontiguousarray(np.asarray(limbs).astype("<u2").T)
        raw = arr.tobytes()
        w = self.nlimbs * 2
        mult = pow(self.mont_r, -1, self.p) if mont else 1
        return [
            int.from_bytes(raw[k * w : (k + 1) * w], "little") * mult % self.p
            for k in range(arr.shape[0])
        ]

    def constant(self, x: int, batch: int) -> torch.Tensor:
        """Montgomery-form constant broadcast to (nlimbs, batch) (a view).
        Each constant crosses to the device once and is cached: a copy from
        pageable host memory would synchronise the card at every call."""
        col = self._consts.get(x)
        if col is None:
            col = self._consts[x] = self.pack([x])
        return col.expand(self.nlimbs, batch)

    # -- carry-lookahead machinery -------------------------------------------

    def _carry_word(self, g, p):
        """Closed carry word from per-limb generate/propagate 0/1 rows: bit i
        of the result is the carry INTO limb i (needs nlimbs < 31)."""
        gb = (g * self._bit_weights).sum(0, dtype=torch.int32)
        pb = (p * self._bit_weights).sum(0, dtype=torch.int32)
        b = gb | pb
        return (gb + b) ^ gb ^ b

    def _ks_carry(self, s):
        """Normalize limbs with values < 2^17 to canonical 16-bit limbs.
        Returns (limbs, carry_out)."""
        r = s & LIMB_MASK
        g = s >> LIMB_BITS
        p = (r == LIMB_MASK).to(torch.int32)
        c = self._carry_word(g, p)
        cin = (c[None, :] >> self._shifts) & 1
        return (r + cin) & LIMB_MASK, ((c >> self.nlimbs) & 1).bool()

    def _borrow_chain(self, t):
        """Borrow bits for limb differences t (t < 0 generates, t == 0
        propagates). Returns (borrow_in, borrowed_past_top)."""
        g = (t < 0).to(torch.int32)
        p = (t == 0).to(torch.int32)
        c = self._carry_word(g, p)
        return (c[None, :] >> self._shifts) & 1, ((c >> self.nlimbs) & 1).bool()

    def _cond_sub_p(self, r):
        """Canonicalize r (< 2p, canonical limbs) to r mod p."""
        t = r - self.p_col
        b, borrowed = self._borrow_chain(t)
        return torch.where(borrowed[None, :], r, (t - b) & LIMB_MASK)

    # -- ring ops ------------------------------------------------------------

    def add(self, a, b):
        r, _ = self._ks_carry(a + b)  # a, b < p so a + b < 2p < R
        return self._cond_sub_p(r)

    def sub(self, a, b, blog: int | None = None):
        """a - b mod p. `blog` is the RNS resident-form bound literal of the
        reference's tower formulas; positional limbs ignore it."""
        t = a - b
        bor, borrowed = self._borrow_chain(t)
        raw = (t - bor) & LIMB_MASK  # a - b mod R
        r, _ = self._ks_carry(raw + self.p_col * borrowed[None, :])
        return r

    def neg(self, a, blog: int | None = None):
        return self.sub(torch.zeros_like(a), a, blog)

    def mul(self, a, b):
        """Montgomery product a * b / R mod p: the CUDA kernel for tensors on
        the card, the plain PyTorch version for tensors on the CPU."""
        if a.is_cuda:
            if a.shape[1] > 1 and a.stride(1) != 1:
                a = a.contiguous()
            if b.shape[1] > 1 and b.stride(1) != 1:
                b = b.contiguous()
            return mont_mul(self, a, b)
        if a.device.type != "cpu" or b.device.type != "cpu":
            raise ValueError(f"Field.mul: operands on {a.device} and {b.device}")
        return self._mul_plain(a, b)

    def _mul_plain(self, a, b):
        """The plain PyTorch Montgomery product: the reference's
        `_mul_cols_vec` column algebra with int64 products. Full schoolbook
        columns (magnitudes < 2^23), interleaved reduction with
        n0 = -p^-1 mod 2^16, one lazy carry pass, one conditional subtract."""
        n = self.nlimbs
        bsz = a.shape[1]
        t = a.long()[:, None, :] * b.long()[None, :, :]  # (n, n, B), exact
        cols = torch.zeros((2 * n + 1, bsz), dtype=torch.int64, device=a.device)
        cols.index_add_(0, self._ij, (t & LIMB_MASK).reshape(n * n, bsz))
        cols.index_add_(0, self._ij + 1, (t >> LIMB_BITS).reshape(n * n, bsz))
        carry = torch.zeros((bsz,), dtype=torch.int64, device=a.device)
        for i in range(n):
            t0 = cols[i] + carry
            m = (t0 * self.n0) & LIMB_MASK
            mp = m[None, :] * self._p_col64  # (n, B)
            mlo = mp & LIMB_MASK
            carry = (t0 + mlo[0]) >> LIMB_BITS
            cols[i + 1 : i + n] += mlo[1:]
            cols[i + 1 : i + n + 1] += mp >> LIMB_BITS
        cols[n] += carry
        hi = cols[n : 2 * n]  # column values < 2^23 (CIOS bound)
        spill = torch.cat([torch.zeros_like(hi[:1]), hi[:-1] >> LIMB_BITS])
        r, _ = self._ks_carry(((hi & LIMB_MASK) + spill).to(torch.int32))
        return self._cond_sub_p(r)

    def sqr(self, a):
        return self.mul(a, a)

    # -- derived ops ---------------------------------------------------------

    def pow_const(self, a, e: int, window: int = DEFAULT_POW_WINDOW):
        """a^e for a fixed public exponent (`windowed_pow`)."""
        return windowed_pow(a, e, window, mul=self.mul, sqr=self.sqr)

    def inv(self, a):
        """Field inverse by Fermat: a^(p-2). Zero maps to zero."""
        return self.pow_const(a, self.p - 2)

    def select(self, mask, a, b):
        """Per-element select: mask (B,) bool -> limbs from a else b."""
        return torch.where(mask[None, :], a, b)

    def is_zero(self, a):
        return (a == 0).all(0)

    def eq(self, a, b):
        return (a == b).all(0)

    # -- Montgomery domain conversions ----------------------------------------

    def to_mont(self, a):
        if self._r2 is None:
            r2 = _int_to_limbs(self.mont_r2, self.nlimbs)
            self._r2 = torch.from_numpy(r2).to(self.device)[:, None]
        return self.mul(a, self._r2.expand(a.shape))

    def from_mont(self, a):
        one = torch.zeros_like(a)
        one[0] = 1
        return self.mul(a, one)


# -- chained-marginal throughput ----------------------------------------------


def chain(fn, a, b, k: int):
    """k dependent calls out = fn(out, b), starting from out = a."""
    out = a
    for _ in range(k):
        out = fn(out, b)
    return out


class ChainTally:
    """What `chained_marginal` ran on the card: graphs captured, calls of
    `fn` captured (the graphs' depths), replays, and calls of `fn` replayed
    (depth x replays). A wrapper's launch counter moves when a graph is
    captured, not when it is replayed, so the kernels a run executed are
    its counter's moves less `captured_calls` plus `replayed_calls`."""

    def __init__(self):
        self.graphs = 0
        self.captured_calls = 0
        self.replays = 0
        self.replayed_calls = 0


class ChainGraph:
    """`chain(fn, a, b, k)` captured once in a torch.cuda.CUDAGraph.

    `fn` runs three times eagerly on a side stream first, so that lazy
    module loading, cached device constants and library handles happen
    outside the capture (none of them is legal during it). `replay()`
    reruns the k calls on the same input tensors and returns the output
    tensor, overwritten in place. Capture errors propagate: there is no
    eager fallback."""

    def __init__(self, fn, a, b, k: int, tally: ChainTally | None = None):
        side = torch.cuda.Stream(a.device)
        side.wait_stream(torch.cuda.current_stream(a.device))
        with torch.cuda.stream(side):
            for _ in range(3):
                fn(a, b)
        torch.cuda.current_stream(a.device).wait_stream(side)
        torch.cuda.synchronize(a.device)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = chain(fn, a, b, k)
        self.depth = k
        self.tally = tally
        if tally is not None:
            tally.graphs += 1
            tally.captured_calls += k

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        if self.tally is not None:
            self.tally.replays += 1
            self.tally.replayed_calls += self.depth
        return self.out


def _best_chain_s(fn, a, b, k: int, trials: int, tally: ChainTally | None) -> float:
    """Best of `trials` times, in seconds, of a k-deep chain. CUDA tensors:
    one captured graph, each replay timed by CUDA events. CPU tensors: the
    chain run eagerly, timed by perf_counter."""
    import time

    if a.is_cuda:
        g = ChainGraph(fn, a, b, k, tally)
        g.replay()  # the first replay uploads the graph
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        best = float("inf")
        for _ in range(trials):
            start.record()
            g.replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        return best
    chain(fn, a, b, k)  # warm
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        chain(fn, a, b, k)
        best = min(best, time.perf_counter() - t0)
    return best


def chained_marginal(fn, a, b, k1: int = 8, k2: int = 72, trials: int = 4,
                     tally: ChainTally | None = None):
    """Marginal throughput of a binary op under chained calls: the method
    behind every rate of the kernel labs and `_throughput_bench`.

    Times k1- and k2-deep chains of dependent `out = fn(out, b)` (best of
    `trials` each) and reports the slope (k2 - k1) * batch / (t2 - t1): what
    a call costs besides the chain's fixed overhead, which cancels in the
    difference. On CUDA tensors each chain is captured once in a CUDA graph
    and replayed, timed by CUDA events, so the host's issue rate drops out
    too and the slope is the device time of one call; on CPU tensors the
    chain runs eagerly. The tensors' device decides which. Returns
    (rate_ops_per_s, floor_s); rate is None when the slope stays non-positive
    after one retry (timing noise at tiny batches): a non-measurement, never
    an absurd figure."""
    t1 = _best_chain_s(fn, a, b, k1, trials, tally)
    t2 = _best_chain_s(fn, a, b, k2, trials, tally)
    if t2 <= t1:  # timing noise: one retry
        t1 = _best_chain_s(fn, a, b, k1, trials, tally)
        t2 = _best_chain_s(fn, a, b, k2, trials, tally)
    if t2 <= t1:
        return None, t1
    batch = a.shape[-1]
    rate = (k2 - k1) * batch / (t2 - t1)
    floor = max(t1 - k1 * batch / rate, 0.0)
    return rate, floor


def device_name(device: torch.device) -> str:
    """The card's name for a CUDA device, "cpu" for the CPU."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _throughput_bench(batch: int = 1 << 18, trials: int = 4, backend: str = "cios",
                      device: str | torch.device | None = None):
    """The production field's marginal mont-muls/s (`chained_marginal`) for
    Field(bn.P, backend=...): cios runs kernel B1, rns the per-mul
    `RnsField.mul`. Operands are seeded raw 16-bit limbs, as in the
    reference. Prints one line naming the device; returns (rate, floor_s),
    rate 0.0 when the slope is not measurable."""
    from handel_tpu_torch.ops import bn254_ref as bn

    F = Field(bn.P, backend=backend, device=device)
    rng = np.random.default_rng(1)
    shape = (F.nlimbs, batch)
    a = torch.from_numpy(rng.integers(0, 1 << LIMB_BITS, shape, np.uint32).astype(np.int32))
    b = torch.from_numpy(rng.integers(0, 1 << LIMB_BITS, shape, np.uint32).astype(np.int32))
    a, b = a.to(F.device), b.to(F.device)
    k1, k2 = 8, 72
    rate, floor = chained_marginal(F.mul, a, b, k1=k1, k2=k2, trials=trials)
    name = device_name(F.device)
    if rate is None:
        print(f"{name}: marginal slope not measurable (floor ~{floor*1e3:.3f} ms at "
              f"batch {batch}): increase batch or chain depth")
        return 0.0, floor
    print(f"{name}: {rate/1e6:.1f}M {bn.P.bit_length()}-bit mont-muls/s marginal "
          f"[{backend}] (batch {batch}, chain {k1}->{k2}, floor ~{floor*1e3:.3f} ms)")
    return rate, floor


if __name__ == "__main__":
    import sys

    # call through the package module: this file is also `__main__`, and
    # Field.__new__'s redirect to RnsField needs the package's Field class
    from handel_tpu_torch.ops.fp import _throughput_bench as bench

    bench(int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 20,
          backend=sys.argv[2] if len(sys.argv) > 2 else "cios")
