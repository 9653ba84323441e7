"""Montgomery-multiply kernel lab — counterpart of scripts/fp_kernel_lab.py.

The lab races formulations of the production Field's Montgomery product.
Each candidate is first validated against a bigint oracle under its own
Montgomery constant, then timed by `chained_marginal` (ops/fp.py): on the
card, chains of dependent calls captured in CUDA graphs, so each figure is
the device's marginal rate per call, comparable across candidates.

  * `prod(Field.mul)`    the production product, kernel B1 (csrc/fp_mont.cu):
                         32-bit words, word-serial CIOS, 64-bit products.
  * `rns(Field backend)` the per-mul `RnsField.mul` (ops/rns.py), whose
                         Montgomery constant is M, not R.
  * `plain:<form>`       the two formulations below as plain PyTorch bodies
                         (the reference's `xla:` candidates).
  * `cuda:<form>:w<w>`   the same formulations as hand-written Hopper
                         kernels (B3a, B3b in csrc/lab_mont.cu) at blocks
                         of w = 1, 2, 4 warps of 32 columns (the
                         reference's `pallas:<form>:t<tile>` race); card
                         only. B3b runs its two constant products on the
                         int8 tensor cores.

The formulations keep the reference's 16-bit digits in lazy 32-bit columns:

  * `cios_fullwidth` — interleaved CIOS: all n^2 digit products land in
    2n + 1 column sums, then n reduction steps, one spill and carry pass,
    one conditional subtract.
  * `separated` — separated Montgomery: T = a b, m = (T mod R) p' mod R,
    (T + m p) / R, with both constant products unrolled against the digits
    of p' and p.

The plain bodies emulate the reference's uint32 lanes in int64 (torch has
no uint32 arithmetic on the CPU): every value stays below 2^32 except where
the reference's lane wraps, and there the code masks with 0xFFFFFFFF. A
candidate that fails validation is printed as FAIL, left out of the race,
and makes `main` exit non-zero after the race.

    python -m handel_tpu_torch.scripts.fp_kernel_lab [batch] [--device cpu]

`main` returns a dict of the figures and prints it as one JSON line last.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys

import numpy as np
import torch
import torch.nn.functional as tnf

from handel_tpu_torch.kernels.lab_mont import (
    DEFAULT_WARPS,
    SUPPORTED_LIMBS,
    WARPS,
    lab_cios_fullwidth,
    lab_separated,
    separated_fragments,
)
from handel_tpu_torch.ops import bn254_ref as bn
from handel_tpu_torch.ops.fp import (
    LIMB_BITS,
    LIMB_MASK,
    ChainTally,
    Field,
    _int_to_limbs,
    chained_marginal,
    device_name,
)
from handel_tpu_torch.utils.torchenv import resolve_device

U32 = 0xFFFFFFFF  # where the reference's uint32 lane wraps
FORMS = ("cios_fullwidth", "separated")


def _split8(x: int) -> tuple[int, int]:
    return x & 0xFF, (x >> 8) & 0xFF


class LabField:
    """Lab formulations sharing the production Field's constants. Bodies
    take (n, B) int32 digit tensors (each digit < 2^16) on the Field's device
    and return the canonical (n, B) int32 product; they compute in int64.
    The reference adds at static offsets in two forms (an indexed add, and a
    pad and add that Pallas can lower); both give the same sums, and the
    bodies here take the indexed one, in place on tensors they allocated."""

    def __init__(self, F: Field):
        self.F = F
        self.n = F.nlimbs
        self.p = F.p
        self.n0 = F.n0
        # full n-limb Montgomery multiplier p' = -p^{-1} mod R
        R = 1 << (LIMB_BITS * self.n)
        self.pprime = (-pow(F.p, -1, R)) % R
        self.pprime_limbs = [int(v) for v in _int_to_limbs(self.pprime, self.n)]
        self.p_limbs = [int(v) for v in F.p_limbs_np]
        # B3b's constants p' and p as its tensor-core fragments, on the card
        self.frags = (
            torch.from_numpy(separated_fragments(self.n, self.p_limbs, self.pprime_limbs))
            .to(F.device)
            if F.device.type == "cuda" and self.n in SUPPORTED_LIMBS else None
        )

    def _cond_sub_p_rows(self, rows):
        """r - p if r >= p else r, for a list of n canonical 16-bit rows
        (the Field's borrow chain, as the reference's lab calls its Field's)."""
        return self.F._cond_sub_p(torch.stack(rows).int())

    # -- V1: CIOS with full-width column accumulation -----------------------

    def cios_fullwidth_body(self, a, b):
        """Interleaved CIOS with the algebra of Field._mul_cols: the n^2
        product terms land via n static slice-adds on a (2n+1, B) array."""
        n = self.n
        a, b = a.long(), b.long()
        bsz = a.shape[1]
        cols = torch.zeros((2 * n + 1, bsz), dtype=torch.int64, device=a.device)
        for i in range(n):
            prod = a[i][None, :] * b  # (n, B) exact, < 2^32
            cols[i : i + n] += prod & LIMB_MASK
            cols[i + 1 : i + n + 1] += prod >> LIMB_BITS
        p_col = self.F._p_col64
        carry = torch.zeros((bsz,), dtype=torch.int64, device=a.device)
        for i in range(n):
            t0 = cols[i] + carry
            m = ((t0 * self.n0) & U32) & LIMB_MASK  # t0 * n0 wraps the uint32 lane
            mp = m[None, :] * p_col  # (n, B)
            mlo = mp & LIMB_MASK
            mhi = mp >> LIMB_BITS
            carry = (t0 + mlo[0]) >> LIMB_BITS
            cols[i + 1 : i + n] += mlo[1:]
            cols[i + 1 : i + n + 1] += mhi
        cols[n] += carry
        hi = cols[n : 2 * n]
        spill = tnf.pad(hi >> LIMB_BITS, (0, 0, 1, 0))[:n]
        rows = (hi & LIMB_MASK) + spill
        carry2 = torch.zeros_like(rows[0])
        out = []
        for k in range(n):
            t = rows[k] + carry2
            out.append(t & LIMB_MASK)
            carry2 = t >> LIMB_BITS
        return self._cond_sub_p_rows(out)

    # -- V2: separated Montgomery, constant-operand products ----------------

    def _mac_const(self, acc, x, limb_consts, lo_col0: int, keep: int):
        """acc[lo_col0+j : ...] += x * limb_consts[j] for each 16-bit constant
        limb, the constant split 8-bit so products of x < 2^17 stay below
        2^25, truncated to columns < keep. x: (n, B) rows < 2^17. Adds in
        place and returns acc."""
        n = x.shape[0]
        for j, c in enumerate(limb_consts):
            base = lo_col0 + j
            if base >= keep:
                break
            w = min(n, keep - base)
            clo, chi = _split8(c)
            if clo:
                v = x[:w] * clo  # < 2^25
                acc[base : base + w] += v & LIMB_MASK
                acc[base + 1 : base + 1 + w] += v >> LIMB_BITS
            if chi:
                v = x[:w] * chi  # < 2^25
                # times 2^8 straddles the 16-bit column boundary
                acc[base : base + w] += (v & 0xFF) << 8
                acc[base + 1 : base + 1 + w] += v >> 8
        return acc

    def _norm_pass1(self, cols):
        """One lazy-carry pass: (k, B) columns < 2^c -> rows < 2^16 +
        2^(c-16) with the carries shifted in, and the carry out of the top."""
        r = cols & LIMB_MASK
        c = cols >> LIMB_BITS
        r[1:] += c[:-1]
        return r, c[-1]

    def _ks_rows(self, s, nl):
        """0/1 carry closure over nl <= 24 limb rows with values < 2^17 via the
        packed-word adder identity (Field._carry_word). Returns (canonical
        rows, carry out)."""
        r = s & LIMB_MASK
        g = s >> LIMB_BITS
        pr = (r == LIMB_MASK).long()
        gb = torch.zeros_like(r[0])
        pb = torch.zeros_like(r[0])
        for i in range(nl):
            gb = gb | (g[i] << i)
            pb = pb | (pr[i] << i)
        bor = gb | pb
        cw = (gb + bor) ^ gb ^ bor  # bit nl is the highest read: < 2^25
        rows = [(r[i] + ((cw >> i) & 1)) & LIMB_MASK for i in range(nl)]
        return torch.stack(rows), (cw >> nl) & 1

    def separated_body(self, a, b):
        n = self.n
        a, b = a.long(), b.long()
        bsz = a.shape[1]
        # T = a*b in column basis, with one spare top row: (2n+1, B), columns
        # < 2^22; Acc below accumulates m*p onto it in place
        T = torch.zeros((2 * n + 1, bsz), dtype=torch.int64, device=a.device)
        for i in range(n):
            prod = a[i][None, :] * b
            T[i : i + n] += prod & LIMB_MASK
            T[i + 1 : i + n + 1] += prod >> LIMB_BITS
        # semi-normalise the low half (values < 2^17); its carry out has
        # weight R and m is needed only mod R
        tlo, _tlo_carry = self._norm_pass1(T[:n])
        m_acc = torch.zeros((n + 1, bsz), dtype=torch.int64, device=a.device)
        m_acc = self._mac_const(m_acc, tlo, self.pprime_limbs, 0, n)
        m1, _ = self._norm_pass1(m_acc[:n])
        m, _ = self._ks_rows(m1, n)  # canonical m < R
        # Acc = T + m*p exactly
        acc = self._mac_const(T, m, self.p_limbs, 0, 2 * n + 1)
        # the low half is 0 mod R; propagate its real carry into column n
        low1, lowc = self._norm_pass1(acc[:n])
        _, ks_out = self._ks_rows(low1, n)
        hi1, _hic = self._norm_pass1(acc[n : 2 * n])
        hi1[0] += lowc + ks_out
        hi2, _c2 = self._ks_rows(hi1, n)
        # what passes the top (_hic, _c2, acc[2n]) is dropped: the quotient
        # mod R, as in the reference (0 for canonical operands)
        return self._cond_sub_p_rows([hi2[k] for k in range(n)])

    # -- the kernels ----------------------------------------------------------

    def mul_cios_fullwidth(self, a, b, warps: int = DEFAULT_WARPS):
        """B3a on CUDA tensors (or raise); the plain body on CPU tensors."""
        if a.is_cuda:
            return lab_cios_fullwidth(self, a, b, warps)
        self._cpu_operands(a, b)
        return self.cios_fullwidth_body(a, b)

    def mul_separated(self, a, b, warps: int = DEFAULT_WARPS):
        """B3b on CUDA tensors (or raise); the plain body on CPU tensors."""
        if a.is_cuda:
            return lab_separated(self, a, b, warps)
        self._cpu_operands(a, b)
        return self.separated_body(a, b)

    @staticmethod
    def _cpu_operands(a, b):
        if a.device.type != "cpu" or b.device.type != "cpu":
            raise ValueError(f"LabField: operands on {a.device} and {b.device}")

    def body(self, form: str):
        return {"cios_fullwidth": self.cios_fullwidth_body,
                "separated": self.separated_body}[form]

    def kernel(self, form: str, warps: int = DEFAULT_WARPS):
        """The binary op that launches the named formulation's kernel at
        blocks of `warps` warps."""
        mul = {"cios_fullwidth": self.mul_cios_fullwidth,
               "separated": self.mul_separated}[form]
        return functools.partial(mul, warps=warps)


def validate(F: Field, fn, bsz: int = 256, seed: int = 7) -> None:
    """Exactness against the bigint oracle under the candidate field's own
    Montgomery constant (mont_r is R mod p for the CIOS family, M mod p for
    the RNS backend: pow(mont_r, -1, p) is the right quotient either way).
    Raises AssertionError naming the first lanes that differ."""
    rng = np.random.default_rng(seed)
    xs = [int(rng.integers(0, 1 << 62)) * int(rng.integers(0, 1 << 62)) % F.p
          for _ in range(bsz)]
    ys = [int(rng.integers(0, 1 << 62)) * int(rng.integers(0, 1 << 62)) % F.p
          for _ in range(bsz)]
    a = F.pack(xs, mont=False)
    b = F.pack(ys, mont=False)
    got = F.unpack(fn(a, b), mont=False)
    m_inv = pow(F.mont_r, -1, F.p)
    want = [x * y * m_inv % F.p for x, y in zip(xs, ys)]
    bad = [k for k in range(bsz) if got[k] != want[k]]
    if bad:
        raise AssertionError(f"mismatch at lanes {bad[:5]} (of {len(bad)})")


def bench(name: str, fn, a, b, trials: int = 5, tally: ChainTally | None = None):
    """Marginal muls/s of one candidate (`chained_marginal`, chains of 4 and
    20), printed; None when the slope is lost to timing noise."""
    rate, _floor = chained_marginal(fn, a, b, k1=4, k2=20, trials=trials, tally=tally)
    if rate is None:
        print(f"  {name:28s} marginal slope unmeasurable (timing noise)")
        return None
    print(f"  {name:28s} {rate/1e6:10.2f}M muls/s marginal")
    return rate


def candidates(F: Field, lab: LabField, F_rns: Field):
    """(name, fn, field) for every candidate; the kernels on the card only.
    Every fn is shape-polymorphic, so validation runs it at 256 columns."""
    out = [("prod(Field.mul)", F.mul, F), ("rns(Field backend)", F_rns.mul, F_rns)]
    for form in FORMS:
        out.append((f"plain:{form}", lab.body(form), F))
        if F.device.type == "cuda":
            for w in WARPS:
                out.append((f"cuda:{form}:w{w}", lab.kernel(form, w), F))
    return out


def raw_operands(F: Field, batch: int):
    """The race's operands: two (nlimbs, batch) int32 tensors of raw 16-bit
    digits from seed 3 (values up to R - 1, as in the reference), on F's
    device."""
    rng = np.random.default_rng(3)
    shape = (F.nlimbs, batch)
    a = rng.integers(0, 1 << LIMB_BITS, shape, np.uint32).astype(np.int32)
    b = rng.integers(0, 1 << LIMB_BITS, shape, np.uint32).astype(np.int32)
    return torch.from_numpy(a).to(F.device), torch.from_numpy(b).to(F.device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m handel_tpu_torch.scripts.fp_kernel_lab")
    ap.add_argument("batch", nargs="?", type=int, default=1 << 18)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    batch = args.batch
    F = Field(bn.P, device=dev)
    lab = LabField(F)
    F_rns = Field(bn.P, backend="rns", device=dev)
    a, b = raw_operands(F, batch)
    name = device_name(dev)
    print(f"device={name} batch={batch}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    race, failed = [], []
    for nm, fn, cf in candidates(F, lab, F_rns):
        try:
            validate(cf, fn)
        except Exception as e:  # noqa: BLE001 - reported, and fails the run below
            print(f"  {nm:28s} validate: FAIL ({type(e).__name__}: {e})")
            failed.append(nm)
            continue
        print(f"  {nm:28s} validate: OK")
        race.append((nm, fn))
    print("-- timing --")
    rates, captured, replayed = {}, {}, {}
    for nm, fn in race:
        tally = ChainTally()
        try:
            rates[nm] = bench(nm, fn, a, b, tally=tally)
        except Exception as e:  # noqa: BLE001 - reported, and fails the run below
            print(f"  {nm:28s} bench FAIL ({type(e).__name__}: {e})")
            failed.append(nm)
        captured[nm] = tally.captured_calls
        replayed[nm] = tally.replayed_calls
        if dev.type == "cuda":  # the chains' graphs are gone: release their pools
            torch.cuda.empty_cache()
    result = {
        "lab": "fp_kernel_lab", "device": name, "batch": batch,
        "muls_per_s": rates, "failed": failed,
        # calls of each candidate captured into graphs and made by graph
        # replays (0 on the CPU): a kernel's launch counter moves when its
        # graph is captured, not when it is replayed
        "captured_calls": captured,
        "replayed_calls": replayed,
        "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else None),
    }
    print(json.dumps(result))
    if failed:
        raise SystemExit(f"fp_kernel_lab: {len(failed)} candidate(s) failed: {failed}")
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
