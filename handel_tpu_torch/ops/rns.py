"""Residue-number-system Montgomery multiplication — counterpart of
handel_tpu/ops/rns.py.

`RnsField` is the "rns" field backend (`Field(p, backend="rns")`). It keeps
the Field contract: canonical (< p) positional (nlimbs, B) int32 limbs at
every op boundary, so the tower, curve and launch code run unchanged.

* **Bases.** Base A (product M, the backend's Montgomery constant) holds
  small primes below 2^13 until M >= 2^56 p; base B (product MB) until
  MB > 2 (kA + 1) p; a redundant prime m_r rides along for exact CRT
  offsets. BN254: kA = 24, kB = 21, k_all = 46. BLS12-381: 34, 30, 65.
* **Per-mul path (`mul`).** Positional operands map to residues by one
  constant-matrix contraction, multiply residue-wise, run the Montgomery
  reduction in residues and come back by an exact (Shenoy–Kumaresan) CRT
  and a conditional-subtract ladder. Each call pays one conversion in and
  one out, and never reaches kernel B1: B1's Montgomery constant is R, not
  M.
* **Resident form.** A value stays a (k_all, B) int32 plane of joint
  residues (base A rows, base B rows, the m_r row) between genuine
  boundaries. `mul_resident` closes the product inside that form; on a CUDA
  tensor it launches kernel B2 (csrc/rns_mont.cu, bound in
  kernels/rns_mont.py) or raises, on a CPU tensor it runs
  `_mul_resident_core`, its plain version. Adds and subtracts are
  residue-wise; the tower threads static bound literals (`blog`) through
  its subtractions so the represented value stays nonnegative.
  `ResidentRns` wraps the form in the Field surface for
  `Tower.as_resident()`.

Exactness. Every output row is the canonical residue of an integer that
the algorithm fixes completely, so any exact reduction gives the
reference's bits: residues reduce with `torch.remainder`, and the
constant-matrix contractions run as float64 matrix products, exact because
every partial sum is an integer below 2^32 (terms < 2^26, depth <= 48),
far inside float64's 53-bit mantissa, in any summation order and on either
device. The reference's float-assisted reduction and its int8-plane
lowering are TPU-specific techniques with the same results and are not
copied here (kernel B2 has its own exact float-estimate reduction).

Conversion counters count each executed `to_resident`/`from_resident` and
each per-mul round trip. The reference counts at trace time, once per call
site; every conversion of a resident pairing is outside any loop, so the
two agree there (one `pairing` or `pairing_check`: 5 in, 1 out).
"""

from __future__ import annotations

import numpy as np
import torch

from handel_tpu_torch.ops.fp import DEFAULT_POW_WINDOW, Field, windowed_pow

_PRIME_BOUND = 1 << 13  # residue moduli < 2^13: products and sums fit 32 bits


def _small_primes_desc(bound: int) -> list[int]:
    sieve = np.ones(bound, dtype=bool)
    sieve[:2] = False
    for i in range(2, int(bound**0.5) + 1):
        if sieve[i]:
            sieve[i * i :: i] = False
    return [int(x) for x in np.nonzero(sieve)[0][::-1]]


def _limbs8(x: int, n: int) -> list[int]:
    return [(x >> (8 * t)) & 0xFF for t in range(n)]


class RnsField(Field):
    """Field whose `mul` is the RNS Montgomery pipeline; Montgomery constant
    M = prod(base A) instead of 2^(16 nlimbs)."""

    backend = "rns"

    # base A is grown until M >= 2^RES_MUL_LOG2 * p, so mul_resident is
    # exact for operand bound exponents summing to <= RES_MUL_LOG2
    RES_MUL_LOG2 = 56
    # sub_resident offset table covers blog in [0, RES_MAX_BLOG]
    RES_MAX_BLOG = 32

    def __init__(self, p: int, backend: str | None = None,
                 device: str | torch.device | None = None):
        if backend not in (None, "rns"):
            raise ValueError(
                f"RnsField is the 'rns' backend, got {backend!r}: construct "
                f"Field(p, backend='cios') for kernel B1 or "
                f"Field(p, backend='rns') for this one"
            )
        super().__init__(p, device=device)
        self._build_bases(p)
        # Montgomery constant: M, not R (module docstring)
        self.mont_r = self.M % p
        self.mont_r2 = self.mont_r * self.mont_r % p
        self._n_to_resident = 0
        self._n_from_resident = 0
        self._adapter = None
        self._kernel_table: torch.Tensor | None = None

    # -- construction -------------------------------------------------------

    def _build_bases(self, p: int) -> None:
        primes = iter(_small_primes_desc(_PRIME_BOUND))
        mA: list[int] = []
        M = 1
        while M < (p << self.RES_MUL_LOG2):
            mA.append(next(primes))
            M *= mA[-1]
        kA = len(mA)
        # mul_resident's output bound (kA + 1) p <= 2^6 p needs kA + 1 <= 64
        assert kA + 1 <= 64, "resident output bound 2^6*p needs kA+1 <= 64"
        mB: list[int] = []
        MB = 1
        while MB <= 2 * (kA + 1) * p:  # r < (kA+1) p must be < MB (CRT range)
            mB.append(next(primes))
            MB *= mB[-1]
        kB = len(mB)
        mr = next(primes)
        assert mr > kB + 1, "redundant modulus must bound the CRT offset"
        self.mA, self.mB, self.mr = mA, mB, mr
        self.M, self.MB = M, MB
        self.kA, self.kB = kA, kB
        self.k_all = kA + kB + 1  # joint base: A ++ B ++ [m_r]

        n8 = 2 * self.nlimbs
        m_all = mA + mB + [mr]
        mB_r = mB + [mr]
        # positional -> residues: W[i, j] = 2^(8j) mod m_i
        self._W = np.array([[pow(2, 8 * j, m) for j in range(n8)] for m in m_all], np.int32)
        # folded quotient digits: xi_i = d_i * (-p^-1 (M/m_i)^-1) mod m_i
        self._c1 = np.array([(-pow(p, -1, m) * pow(M // m, -1, m)) % m for m in mA], np.int32)
        # base extension A -> B ++ [m_r]: E[j, i] = (M/m_i) mod m_j
        self._E = np.array([[(M // mi) % mj for mi in mA] for mj in mB_r], np.int32)
        self._p_modB = np.array([p % m for m in mB_r], np.int32)
        self._MinvB = np.array([pow(M % m, -1, m) for m in mB_r], np.int32)
        # exact CRT over base B: xi'_j = r_j (MB/m_j)^-1 mod m_j, alpha via m_r
        self._c2 = np.array([pow(MB // m, -1, m) % m for m in mB], np.int32)
        self._L_mr = np.array([(MB // m) % mr for m in mB], np.int32)
        self._MBinv_r = int(pow(MB % mr, -1, mr))
        n8out = (MB.bit_length() + 7) // 8
        n8out += n8out % 2  # even, so the 8 -> 16 bit repack is a reshape
        self.n8out, self.n16out = n8out, n8out // 2
        self._L8 = np.array([_limbs8(MB // m, n8out) for m in mB], np.int32).T
        self._MB8 = np.array(_limbs8(MB, n8out), np.int32)
        # binary canonicalization ladder: r < (kA+1) p <= 2^smax p
        smax = kA.bit_length()
        self._sub_consts = [
            np.array([((p << s) >> (16 * t)) & 0xFFFF for t in range(self.n16out)], np.int32)
            for s in range(smax - 1, -1, -1)
        ]
        self._m_all = np.array(m_all, np.int32)
        # resident form: exact base extension B -> A, E2[i, j] = (MB/m_j) mod m_i
        self._E2 = np.array([[(MB // mj) % mi for mj in mB] for mi in mA], np.int32)
        self._MB_modA = np.array([MB % mi for mi in mA], np.int32)
        # Montgomery one (M mod p) as joint residues: the refresh multiplier
        self._one_res = np.array([(M % p) % m for m in m_all], np.int32)
        # sub_resident offsets: residues of (p << s)
        self._off_res = np.array(
            [[(p << s) % m for m in m_all] for s in range(self.RES_MAX_BLOG + 1)], np.int32
        )

        # the same constants as device tensors, built once
        dev = self.device
        col = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)[:, None]  # noqa: E731
        f64 = lambda a: torch.from_numpy(a.astype(np.float64)).to(dev)  # noqa: E731
        self._m_col = col(self._m_all)
        self._mA_col, self._mB_col = self._m_col[:kA], self._m_col[kA : kA + kB]
        self._mBr_col = self._m_col[kA:]
        self._m_f64 = self._m_col.double()
        self._W_f64, self._E_f64 = f64(self._W), f64(self._E)
        self._E2_f64, self._L8_f64 = f64(self._E2), f64(self._L8)
        self._c1_col, self._c2_col = col(self._c1), col(self._c2)
        self._p_modB_col, self._MinvB_col = col(self._p_modB), col(self._MinvB)
        self._L_mr_col, self._MB8_col = col(self._L_mr), col(self._MB8)
        self._MB_modA_col = col(self._MB_modA)
        self._one_res_col = col(self._one_res)
        self._off_res_t = torch.from_numpy(self._off_res).to(dev)
        self._sub_cols = [col(c) for c in self._sub_consts]
        ar = torch.arange(self.n16out, dtype=torch.int32, device=dev)[:, None]
        self._ladder_shifts = ar
        self._ladder_weights = torch.ones_like(ar) << ar

    # -- exact modular primitives ------------------------------------------

    def _dot(self, W64, x, m64=None):
        """Constant-matrix contraction W @ x for int32 x (d, B): one float64
        matrix product, exact (integer partial sums < 2^32). Reduced mod the
        (rows, 1) float64 moduli `m64` when given (fmod of exact nonnegative
        integers is exact), else the exact int32 sum."""
        y = torch.matmul(W64, x.to(torch.float64))
        if m64 is not None:
            y.fmod_(m64)
        return y.to(torch.int32)

    # -- residue conversion -------------------------------------------------

    def _split8(self, a):
        """(nlimbs, B) int32 16-bit limbs -> (2 nlimbs, B) int32 8-bit limbs."""
        return torch.stack([a & 0xFF, a >> 8], dim=1).reshape(2 * self.nlimbs, a.shape[1])

    def to_rns(self, a):
        """Positional (nlimbs, B) limbs -> joint-base residues (k_all, B)."""
        return self._dot(self._W_f64, self._split8(a), self._m_f64)

    def _crt_digits(self, rB, rr):
        """Shenoy digits xi'_j of base-B residues and the exact CRT offset
        alpha (< kB < m_r) recovered through the redundant channel rr."""
        xi = torch.remainder(rB * self._c2_col, self._mB_col)
        mr = self.mr
        s = torch.remainder(xi * self._L_mr_col, mr).sum(0, dtype=torch.int32) % mr
        alpha = ((s - rr + mr) * self._MBinv_r) % mr
        return xi, alpha

    def from_rns_base_b(self, rB, rr):
        """Exact CRT: base-B residues (kB, B) and the m_r row (B,) of a value
        v < MB -> canonical positional 16-bit rows (n16out, B) int32:
        v = L8 @ xi' - alpha MB in 8-bit columns, carried from the bottom.
        Every intermediate is int32 (columns < 2^27); the arithmetic shift
        of a negative multiple of 256 is exact floor division."""
        xi, alpha = self._crt_digits(rB, rr)
        cols = self._dot(self._L8_f64, xi) - alpha[None, :] * self._MB8_col
        carry = torch.zeros_like(cols[0])
        out8 = []
        for t in range(self.n8out):
            v = cols[t] + carry
            low = v & 0xFF
            out8.append(low)
            carry = (v - low) >> 8
        o8 = torch.stack(out8)  # the top carry is 0: v < MB
        return o8[0::2] + (o8[1::2] << 8)

    def _cond_sub_const(self, v, c_col):
        """v - C if v >= C else v over (n16out, B) 16-bit rows: the borrow
        chain closed in one packed word (Field._carry_word's identity)."""
        t = v - c_col
        gb = ((t < 0).to(torch.int32) * self._ladder_weights).sum(0, dtype=torch.int32)
        pb = ((t == 0).to(torch.int32) * self._ladder_weights).sum(0, dtype=torch.int32)
        b = gb | pb
        c = (gb + b) ^ gb ^ b  # bit i: borrow into row i
        bor = (c[None, :] >> self._ladder_shifts) & 1
        borrowed = ((c >> self.n16out) & 1).bool()  # past the top: v < C
        return torch.where(borrowed[None, :], v, (t - bor) & 0xFFFF)

    def _to_canonical(self, r):
        """Joint-base residues r (k_all or kB+1 trailing rows of base B and
        m_r) of a value < (kA+1) p -> canonical positional limbs."""
        kB = self.kB
        v16 = self.from_rns_base_b(r[-kB - 1 : -1], r[-1])
        for c in self._sub_cols:
            v16 = self._cond_sub_const(v16, c)
        return v16[: self.nlimbs]  # the value is < p: the higher rows are 0

    # -- Montgomery steps -----------------------------------------------------

    def _mont_reduce(self, d):
        """Folded quotient digits in base A, offset-tolerant extension
        A -> B ++ [m_r], then r = (T + q_hat p)/M residue-wise. Returns the
        (kB+1, B) residues of r < (kA+1) p (for T < M p)."""
        kA = self.kA
        xi = torch.remainder(d[:kA] * self._c1_col, self._mA_col)
        Q = self._dot(self._E_f64, xi, self._m_f64[kA:])
        u = torch.remainder(Q * self._p_modB_col, self._mBr_col)
        return torch.remainder((d[kA:] + u) * self._MinvB_col, self._mBr_col)

    def _extend_b_to_a(self, r):
        """Exact base extension B ++ [m_r] -> A for v < MB: (kA, B) residues
        (sum_j xi'_j E2[i, j] - alpha MB) mod mA_i."""
        kA, kB = self.kA, self.kB
        xi, alpha = self._crt_digits(r[:kB], r[kB])
        rA = self._dot(self._E2_f64, xi, self._m_f64[:kA])
        corr = torch.remainder(alpha[None, :] * self._MB_modA_col, self._mA_col)
        return torch.remainder(rA + self._mA_col - corr, self._mA_col)

    def mul(self, a, b):
        """RNS Montgomery product of canonical positional operands ->
        canonical a b M^-1 mod p. One conversion in and one out (counted);
        plain torch on either device (the contractions are float64 matrix
        products), never kernel B1."""
        bsz = a.shape[1]
        if bsz == 0:
            return torch.zeros_like(a)
        self._n_to_resident += 1
        self._n_from_resident += 1
        res = self.to_rns(torch.cat([a, b], dim=1))
        d = torch.remainder(res[:, :bsz] * res[:, bsz:], self._m_col)
        return self._to_canonical(self._mont_reduce(d))

    # -- resident form ------------------------------------------------------
    #
    # A resident value is a (k_all, B) int32 plane of joint-base residues of
    # some integer v < 2^lb p; the bound exponent lb is a static property the
    # tower tracks by construction (its per-site `blog` literals).

    def _mul_resident_core(self, ra, rb):
        """The plain version of kernel B2: joint residues of ra rb M^-1,
        bound < (kA+1) p <= 2^6 p; exact when the operand bound exponents sum
        to <= RES_MUL_LOG2."""
        d = torch.remainder(ra * rb, self._m_col)
        r = self._mont_reduce(d)
        return torch.cat([self._extend_b_to_a(r), r], dim=0)

    def mul_resident(self, ra, rb):
        """Resident Montgomery product. On CUDA tensors: kernel B2 or raise;
        on CPU tensors: `_mul_resident_core`."""
        if ra.shape[1] == 0:
            return torch.zeros_like(ra)
        if ra.is_cuda:
            from handel_tpu_torch.kernels.rns_mont import rns_mul_resident

            # broadcast operands (cached constants) take a dense copy
            if ra.shape[1] > 1 and ra.stride(1) != 1:
                ra = ra.contiguous()
            if rb.shape[1] > 1 and rb.stride(1) != 1:
                rb = rb.contiguous()
            return rns_mul_resident(self, ra, rb)
        if ra.device.type != "cpu" or rb.device.type != "cpu":
            raise ValueError(f"mul_resident: operands on {ra.device} and {rb.device}")
        return self._mul_resident_core(ra, rb)

    def kernel_table(self) -> torch.Tensor:
        """Kernel B2's constant table for this field on its device (int32,
        layout in kernels/rns_mont.py), packed once."""
        if self._kernel_table is None:
            from handel_tpu_torch.kernels.rns_mont import pack_constants

            self._kernel_table = torch.from_numpy(pack_constants(self)).to(self.device)
        return self._kernel_table

    def add_resident(self, ra, rb):
        """Residue-wise add; the bound grows to max(la, lb) + 1."""
        return torch.remainder(ra + rb, self._m_col)

    def sub_resident(self, ra, rb, blog: int):
        """ra + (p << blog) - rb residue-wise: congruent to a - b and
        nonnegative when the subtrahend's bound exponent is <= blog."""
        if blog is None:
            raise ValueError(
                "resident subtraction needs a static `blog` bound literal for "
                "the subtrahend; positional backends ignore it"
            )
        if not 0 <= blog <= self.RES_MAX_BLOG:
            raise ValueError(
                f"blog={blog} outside the offset table [0, {self.RES_MAX_BLOG}]"
            )
        off = self._off_res_t[blog][:, None]
        return torch.remainder(ra + off + self._m_col - rb, self._m_col)

    def to_resident(self, a):
        """Canonical positional limbs -> resident residues (bound 0);
        counts one conversion."""
        self._n_to_resident += 1
        return self.to_rns(a)

    def refresh_resident(self, r):
        """Multiply by the Montgomery one: same value mod p, bound reset to
        < (kA+1) p, without leaving the residues."""
        return self.mul_resident(r, self._one_res_col.expand(self.k_all, r.shape[1]))

    def from_resident(self, r):
        """Resident residues (bound <= RES_MUL_LOG2) -> canonical positional
        limbs, the same bits as the CIOS backend's; counts one conversion."""
        self._n_from_resident += 1
        return self._to_canonical(self.refresh_resident(r))

    # -- conversion accounting ------------------------------------------------

    def conversion_counts(self) -> dict:
        return {
            "to_resident": self._n_to_resident,
            "from_resident": self._n_from_resident,
            "total": self._n_to_resident + self._n_from_resident,
        }

    def reset_conversion_counts(self) -> None:
        self._n_to_resident = 0
        self._n_from_resident = 0

    def resident(self) -> "ResidentRns":
        """The Field-shaped adapter over resident values (cached)."""
        if self._adapter is None:
            self._adapter = ResidentRns(self)
        return self._adapter


class ResidentRns:
    """The Field surface over resident values, for `Tower.as_resident()`:
    (k_all, B) int32 residue planes in place of positional limbs. `sub` and
    `neg` need the per-site `blog` literal; `eq` and `is_zero` raise, since
    residues of non-canonical values are not comparable (`from_resident`
    first)."""

    backend = "rns"
    is_resident = True
    limb_dtype = torch.int32

    def __init__(self, F: RnsField):
        self.base = F
        self.p = F.p
        self.device = F.device
        self.mont_r = F.mont_r
        self.mont_r2 = F.mont_r2
        self.nlimbs = F.k_all  # one batch row per residue channel
        self._consts: dict[int, torch.Tensor] = {}

    def pack(self, xs, mont: bool = True):
        return self.base.to_resident(self.base.pack(xs, mont=mont))

    def unpack(self, r, mont: bool = True) -> list[int]:
        return self.base.unpack(self.base.from_resident(r), mont=mont)

    def constant(self, x: int, batch: int):
        """Montgomery-form constant as residues, broadcast to (k_all, batch);
        computed on the host, cached on the device, no conversion counted."""
        col = self._consts.get(x)
        if col is None:
            v = x % self.p * self.mont_r % self.p
            res = np.array([v % int(m) for m in self.base._m_all], np.int32)
            col = self._consts[x] = torch.from_numpy(res).to(self.device)[:, None]
        return col.expand(self.nlimbs, batch)

    def add(self, a, b):
        return self.base.add_resident(a, b)

    def sub(self, a, b, blog: int | None = None):
        return self.base.sub_resident(a, b, blog)

    def neg(self, a, blog: int | None = None):
        return self.base.sub_resident(torch.zeros_like(a), a, blog)

    def mul(self, a, b):
        return self.base.mul_resident(a, b)

    def sqr(self, a):
        return self.base.mul_resident(a, a)

    def refresh(self, a):
        return self.base.refresh_resident(a)

    def pow_const(self, a, e: int, window: int = DEFAULT_POW_WINDOW):
        """Windowed square-and-multiply on resident values; bound-safe for
        inputs <= 2^28 p (every product multiplies values bounded by
        max(input, 2^6 p))."""
        return windowed_pow(a, e, window, mul=self.mul, sqr=self.sqr)

    def inv(self, a):
        """Fermat inverse a^(p-2); zero maps to zero. Output bound 2^6 p."""
        return self.pow_const(a, self.p - 2)

    def select(self, mask, a, b):
        return torch.where(mask[None, :], a, b)

    def eq(self, a, b):
        raise RuntimeError(
            "ResidentRns.eq: residues of non-canonical values are not "
            "comparable; reconstruct with from_resident() first"
        )

    def is_zero(self, a):
        raise RuntimeError(
            "ResidentRns.is_zero: reconstruct with from_resident() first"
        )
