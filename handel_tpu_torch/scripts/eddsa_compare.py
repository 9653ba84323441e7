"""Ed25519 against BN254-BLS at one committee size — counterpart of
scripts/eddsa_compare.py.

What does the aggregating curve buy? This script times, on the host, the
whole signer and verifier pipeline of the port's two host schemes at the
same committee size (default 64, Ed25519's MAX_SIGNERS envelope):

  keygen     n deterministic keypairs
  sign       n individual signatures over one message
  aggregate  the fold of Signature.combine (BLS: point adds; Ed25519: a
             set union)
  verify     the aggregate public key's verify of the combined signature
             (and a tampered message refused)
  wire       the combined signature's marshal size

Both schemes are the port's host code (models/eddsa.py, models/bn254.py,
with the scalar oracle ops/bn254_ref.py in place of the reference's C++),
so the times are host CPU times. The record goes to
results/torch/eddsa_compare.json unless `--out` names another file.

    python -m handel_tpu_torch.scripts.eddsa_compare [nodes] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import time

from handel_tpu_torch.models.registry import new_scheme
from handel_tpu_torch.scripts.artifacts import write_json_atomic

MSG = b"eddsa-compare:handel scenario message"
DEFAULT_OUT = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "results", "torch",
    "eddsa_compare.json"))


def _bench_scheme(name: str, n: int) -> dict:
    scheme = new_scheme(name)
    t0 = time.perf_counter()
    pairs = [scheme.keygen(i) for i in range(n)]
    t_keygen = time.perf_counter() - t0

    t0 = time.perf_counter()
    sigs = [sk.sign(MSG) for sk, _ in pairs]
    t_sign = time.perf_counter() - t0

    t0 = time.perf_counter()
    agg_sig = sigs[0]
    for s in sigs[1:]:
        agg_sig = agg_sig.combine(s)
    t_aggregate = time.perf_counter() - t0

    t0 = time.perf_counter()
    agg_pub = pairs[0][1]
    for _, pk in pairs[1:]:
        agg_pub = agg_pub.combine(pk)
    ok = agg_pub.verify(MSG, agg_sig)
    t_verify = time.perf_counter() - t0
    assert ok, f"{name}: aggregate verify failed"
    assert not agg_pub.verify(b"tampered", agg_sig), f"{name}: forgery accepted"

    wire = agg_sig.marshal()
    assert len(wire) == scheme.constructor.signature_size()
    return {
        "keygen_ms": round(t_keygen * 1e3, 2),
        "sign_ms": round(t_sign * 1e3, 2),
        "aggregate_ms": round(t_aggregate * 1e3, 2),
        "verify_ms": round(t_verify * 1e3, 2),
        "agg_sig_bytes": len(wire),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("nodes", nargs="?", type=int, default=64)
    ap.add_argument("--out", default=DEFAULT_OUT, help="the record's path")
    args = ap.parse_args(argv)
    n = args.nodes
    out = {
        "metric": f"eddsa_vs_bn254_{n}n",
        "nodes": n,
        "message_bytes": len(MSG),
        "clock": "host",
        "captured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "schemes": {
            "eddsa": _bench_scheme("eddsa", n),
            "bn254": _bench_scheme("bn254", n),
        },
    }
    print(json.dumps(out, indent=1))
    write_json_atomic(args.out, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
