"""Outer-product Montgomery lab — counterpart of scripts/mxu_limb_lab.py.

Can a matrix unit beat the scalar-lane Montgomery product? A batched limb
product is an outer product per element (contraction depth 1), so the only
matrix-shaped pieces are the products against constants. The lab races:

  * `prod`           the production product, kernel B1 (csrc/fp_mont.cu).
  * `outer8_f32`     8-bit digits (32 of them for 256 bits), the full
                     (B, 32, 32) outer product as one float32 einsum (exact:
                     products <= 255^2, column sums <= 63 * 65025 < 2^24),
                     an anti-diagonal fold, then a radix-2^8 Montgomery
                     reduction with lazy carries in integer lanes.
  * `rns`            the per-mul `RnsField.mul` (ops/rns.py): residues and
                     constant-matrix contractions.

and measures the card's int8 ceiling: eight chained 4096^3 int8 x int8 ->
int32 products (`torch._int_mm`, a library call timed as the yardstick of
what any matrix-shaped formulation could reach, never a port of a kernel),
with its share of the H100 SXM's data-sheet 1,979 T dense int8 ops/s. The
right operand is stored column-major, the layout cuBLASLt's int8
tensor-core path takes; the row-major figure is printed beside it.
Everything here is what the reference leaves to XLA, so it is plain
PyTorch; the reference's `lax.scan`s are Python loops. Rates come from
`chained_marginal` (ops/fp.py), the same method as the kernel lab's. The
result is printed as one JSON line last and returned. Agreement gates run
first: outer8 against Field.mul, rns against the bigint oracle; a failed
gate exits non-zero.

`--persist` writes the result, with the card's name and power limit from
nvidia-smi, as the "mxu_lab" entry of results/torch/fp_microbench.json
(the port's own file; the JAX package's results/fp_microbench.json holds a
TPU's figures), keeping the file's other entries. The reference's rules
hold: a run on the CPU and a batch under 32,768 are refused the default
file (FP_ARTIFACT_ENV names another file, which takes any run), the write
is atomic, a file cut short by a killed writer is replaced rather than
read, and a slope lost to noise keeps the prior entry's figure with a
note.

    python -m handel_tpu_torch.scripts.mxu_limb_lab [batch] [--device cpu] [--int8-n N]
        [--persist]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as tnf

from handel_tpu_torch.ops import bn254_ref as bn
from handel_tpu_torch.ops.fp import LIMB_BITS, Field, chained_marginal, device_name
from handel_tpu_torch.scripts.artifacts import card_line, write_json_atomic
from handel_tpu_torch.utils.torchenv import resolve_device

N8 = 32  # 8-bit limbs for 256 bits
INT8_OPS_PER_S = 1979e12  # H100 SXM data sheet, dense int8
# --persist's file, and the variable that names another one
FP_ARTIFACT = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "results", "torch",
    "fp_microbench.json"))
FP_ARTIFACT_ENV = "HANDEL_TORCH_BENCH_FP_ARTIFACT"
# the smallest batch whose figures may go to the default file
PERSIST_MIN_BATCH = 1 << 15
# the rates a lost slope may carry over from the prior entry
RATE_KEYS = ("prod_muls_per_s", "outer8_muls_per_s", "rns_muls_per_s")


def split8(a16):
    """(16, B) int32 16-bit limbs -> (32, B) int32 8-bit limbs."""
    lo = a16 & 0xFF
    hi = (a16 >> 8) & 0xFF
    return torch.stack([lo, hi], dim=1).reshape(2 * a16.shape[0], a16.shape[1])


def outer8_product(a8, b8):
    """Exact schoolbook product of 8-bit-limb vectors via one einsum.

    P[b, i, j] = a8[i, b] b8[j, b] in float32 (products <= 65025, exact),
    then the anti-diagonal fold c[k, b] = sum_{i+j=k} P[b, i, j] with column
    sums <= 63 * 65025 < 2^24, still exact in float32 in any order.
    Returns (63, B) float32."""
    af = a8.float()
    bf = b8.float()
    P = torch.einsum("ib,jb->bij", af, bf)  # (B, 32, 32)
    rows = [tnf.pad(P[:, i, :], (i, N8 - 1 - i)) for i in range(N8)]  # (B, 63) each
    return torch.stack(rows).sum(0).T  # (63, B)


def make_outer8_mont(F: Field):
    """Full Montgomery product in the outer-product formulation, exact.

    Reduction: the float32 columns become integer 8-bit-radix columns, then
    32 Montgomery steps of 8 bits (m = c0 (-p^-1) mod 2^8, c = (c + m p) >> 8)
    with lazy carries, one carry pass to canonical 8-bit limbs, a repack to
    16-bit limbs and one borrow-chained conditional subtract. Integer values
    stay below 2^25, so the reference's uint32 lanes never wrap; int64 here."""
    p8 = [(F.p >> (8 * i)) & 0xFF for i in range(N8)]
    p16 = [(F.p >> (LIMB_BITS * i)) & 0xFFFF for i in range(F.nlimbs)]
    ninv8 = (-pow(F.p, -1, 1 << 8)) % (1 << 8)
    # p's 8-bit digits padded to the accumulator's 64 rows, per device
    p8_cols: dict[torch.device, torch.Tensor] = {}

    def p8j(device):
        col = p8_cols.get(device)
        if col is None:
            col = torch.tensor(p8 + [0] * N8, dtype=torch.int64, device=device)[:, None]
            p8_cols[device] = col
        return col

    def mont(a16, b16):
        a8 = split8(a16)
        b8 = split8(b16)
        c = outer8_product(a8, b8).long()  # (63, B), <= 2^24
        c = torch.cat([c, torch.zeros_like(c[:1])])
        pc = p8j(c.device)
        for _ in range(N8):
            m = ((c[0] & 0xFF) * ninv8) & 0xFF  # (B,)
            c = c + m[None, :] * pc  # lazy, <= 2^24 + 2^16 2^8
            # shift one 8-bit limb, carrying c[0]'s bits above 8 into c[1]
            c = torch.cat([(c[1] + (c[0] >> 8))[None], c[2:], torch.zeros_like(c[:1])])
        carry = torch.zeros_like(c[0])
        limbs = []
        for k in range(c.shape[0]):
            v = c[k] + carry
            limbs.append(v & 0xFF)
            carry = v >> 8
        c = torch.stack(limbs)
        # repack 8-bit (64, B) -> 16-bit; rows >= 32 are zero
        c16 = (c[0::2] + (c[1::2] << 8))[: F.nlimbs]
        # Montgomery leaves results < 2p: one borrow-chained subtract of p
        borrow = torch.zeros_like(c16[0])
        diff = []
        for k in range(F.nlimbs):
            d = c16[k] - p16[k] - borrow
            borrow = (d < 0).long()  # the reference's (d >> 31) & 1 on uint32
            diff.append(d & 0xFFFF)
        ge_p = borrow == 0
        return torch.where(ge_p[None, :], torch.stack(diff), c16).int()

    return mont


def marginal(fn, a, b, k1=4, k2=20, trials=5):
    """The lab depth of `chained_marginal`: muls/s, or None when the slope
    is lost to timing noise."""
    rate, _floor = chained_marginal(fn, a, b, k1=k1, k2=k2, trials=trials)
    return rate


def int8_ceiling(device: torch.device, n: int, rng: np.random.Generator) -> dict:
    """int8 ops/s of eight chained n^3 int8 x int8 -> int32 products
    (torch._int_mm), each result cast back to int8 for the next, with the
    constant right operand stored column-major (the layout of cuBLASLt's
    int8 tensor-core path) and, for comparison, row-major. Timed by CUDA
    events on the card, perf_counter on the CPU, after one warm run.
    Returns {"col_major_b": ops/s, "row_major_b": ops/s}."""
    import time

    x8 = torch.from_numpy(rng.integers(-127, 127, (n, n)).astype(np.int8)).to(device)

    def chain8(rhs):
        y = x8
        for _ in range(8):
            y = torch._int_mm(y, rhs).to(torch.int8)
        return y

    out = {}
    for key, rhs in (("col_major_b", x8.t().contiguous().t()), ("row_major_b", x8)):
        chain8(rhs)
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            chain8(rhs)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            chain8(rhs)
            dt = time.perf_counter() - t0
        out[key] = 8 * 2 * n**3 / dt
    return out


def persist(out: dict, device: torch.device) -> str | None:
    """Writes `out` as the "mxu_lab" entry of the fp microbench file (module
    docstring). Returns the path written, or None when the run is refused
    the default file (the reason printed)."""
    override = os.environ.get(FP_ARTIFACT_ENV)
    path = override or FP_ARTIFACT
    if not override and device.type != "cuda":
        print(f"refusing --persist on {device.type}: {path} keeps the card's figures "
              f"(set {FP_ARTIFACT_ENV} to write another file)")
        return None
    if not override and out["batch"] < PERSIST_MIN_BATCH:
        print(f"refusing --persist at batch {out['batch']} < {PERSIST_MIN_BATCH} to {path} "
              f"(set {FP_ARTIFACT_ENV} to write a small run elsewhere)")
        return None
    art = {}
    if os.path.exists(path):
        try:  # a file cut short by a killed writer holds nothing to keep
            with open(path) as f:
                art = json.load(f)
        except (OSError, ValueError):
            art = {}
        if not isinstance(art, dict):
            art = {}
    entry = {**out, "nvidia_smi": card_line(device),
             "captured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}
    prev = art.get("mxu_lab")
    if isinstance(prev, dict):
        # a slope lost to noise keeps the prior figure, marked as such
        for k in RATE_KEYS:
            if entry.get(k) is None and prev.get(k) is not None:
                entry[k] = prev[k]
                entry[k.split("_")[0] + "_note"] = (
                    f"carried from the prior capture (batch {prev.get('batch')}, "
                    f"{prev.get('captured_at')}); this run's slope was lost to timing noise")
    art["mxu_lab"] = entry
    write_json_atomic(path, art)
    print(f"persisted mxu_lab -> {path}")
    return path


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m handel_tpu_torch.scripts.mxu_limb_lab")
    ap.add_argument("batch", nargs="?", type=int, default=1 << 15)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--int8-n", type=int, default=4096,
                    help="side of the int8 ceiling's square products")
    ap.add_argument("--persist", action="store_true",
                    help=f"write the result into {os.path.relpath(FP_ARTIFACT)}")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    batch = args.batch
    F = Field(bn.P, device=dev)
    name = device_name(dev)
    print(f"device={name} batch={batch}")

    rng = np.random.default_rng(11)
    # full-range values (256 random bits mod p): every 8-bit limb row and
    # every high-limb carry path carries data through the gates below
    raw = rng.integers(0, 256, (batch, 32), np.uint8)
    vals_a = [int.from_bytes(bytes(r), "little") % F.p for r in raw]
    raw_b = rng.integers(0, 256, (batch, 32), np.uint8)
    vals_b = [int.from_bytes(bytes(r), "little") % F.p for r in raw_b]
    a = F.pack(vals_a, mont=False)
    b = F.pack(vals_b, mont=False)

    # correctness first: outer8 against the production product
    mont8 = make_outer8_mont(F)
    k = min(256, batch)
    got = mont8(a[:, :k], b[:, :k])
    want = F.mul(a[:, :k], b[:, :k])
    ok = torch.equal(got, want)
    print(f"outer8_f32 vs prod agreement: {ok}")
    if not ok:
        bad = torch.nonzero((got != want).any(0)).flatten()[:4].tolist()
        raise SystemExit(f"mxu_limb_lab: outer8_f32 != prod at lanes {bad}")
    # rns gate: its Montgomery constant is M, so compare with the oracle
    F_rns = Field(bn.P, backend="rns", device=dev)
    got_r = F_rns.unpack(F_rns.mul(a[:, :k], b[:, :k]), mont=False)
    m_inv = pow(F_rns.mont_r, -1, F.p)
    want_r = [x * y * m_inv % F.p for x, y in zip(vals_a[:k], vals_b[:k])]
    ok_r = got_r == want_r
    print(f"rns vs oracle agreement: {ok_r}")
    if not ok_r:
        bad = [j for j in range(k) if got_r[j] != want_r[j]][:4]
        raise SystemExit(f"mxu_limb_lab: rns != oracle at lanes {bad}")

    out = {"lab": "mxu_limb_lab", "device": name, "batch": batch}
    for key, label, fn in (
        ("prod_muls_per_s", "prod (Field.mul)", F.mul),
        ("outer8_muls_per_s", "outer8_f32 (einsum)", mont8),
        ("rns_muls_per_s", "rns (per-mul)", F_rns.mul),
    ):
        r = marginal(fn, a, b)
        out[key] = r
        shown = f"{r/1e6:10.1f}M muls/s marginal" if r else "unmeasurable (noise)"
        print(f"{label:22s} {shown}")
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    layouts = int8_ceiling(dev, args.int8_n, rng)
    ops = layouts["col_major_b"]
    out["int8_n"] = args.int8_n
    out["int8_ops_per_s"] = ops
    out["int8_ops_per_s_row_major_b"] = layouts["row_major_b"]
    # the data-sheet share only means something for a figure from the card
    share = ops / INT8_OPS_PER_S if dev.type == "cuda" else None
    out["int8_share_of_datasheet"] = share
    shown = f" ({100 * share:.1f}% of the H100 SXM's 1979 T)" if share is not None else ""
    print(f"int8 ceiling:          {ops/1e12:10.2f} T int8-ops/s{shown} "
          f"[{layouts['row_major_b']/1e12:.2f} T with a row-major right operand]")
    # one 254-bit product at radix 2^8 needs ~2 * 32^2 limb multiply-adds,
    # about 4096 int8 ops
    out["ceiling_muls_per_s"] = ops / 4096
    print(f"  => a perfectly matrix-shaped product: ~{ops/4096/1e9:.2f}B muls/s; an "
          f"outer product contracts over K = 1")
    if args.persist:
        persist(out, dev)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
