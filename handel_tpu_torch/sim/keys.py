"""Key generation and the CSV node registry — a copy of
handel_tpu/sim/keys.py, reading and writing the same CSV.

Reference: simul/lib/generator.go:1-53 (per-node keypairs), parser.go:14-156
(CSV registry `(id, addr, privHex, pubHex)` + NodeList implementing Registry),
nodes.go:10-64.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from typing import Sequence

from handel_tpu_torch.core.identity import ArrayRegistry, Identity


@dataclass
class NodeRecord:
    id: int
    address: str
    secret_hex: str
    public_hex: str


def generate_nodes(scheme, addresses: Sequence[str]) -> list[NodeRecord]:
    """Deterministic per-id keypairs for every address (generator.go:1-53)."""
    out = []
    for i, addr in enumerate(addresses):
        sk, pk = scheme.keygen(i)
        out.append(
            NodeRecord(
                id=i,
                address=addr,
                secret_hex=sk.marshal().hex(),
                public_hex=pk.marshal().hex(),
            )
        )
    return out


def write_registry_csv(path: str, records: Sequence[NodeRecord]) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        for r in records:
            w.writerow([r.id, r.address, r.secret_hex, r.public_hex])


def read_registry_csv(path: str) -> list[NodeRecord]:
    out = []
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if not row:
                continue
            out.append(NodeRecord(int(row[0]), row[1], row[2], row[3]))
    out.sort(key=lambda r: r.id)
    return out


def registry_from_records(records: Sequence[NodeRecord], scheme) -> ArrayRegistry:
    """Build the runtime Registry (parser.go NodeList.Registry equivalent)."""
    idents = []
    for r in records:
        pk = scheme.unmarshal_public(bytes.fromhex(r.public_hex))
        idents.append(Identity(r.id, r.address, pk))
    return ArrayRegistry(idents)


def secret_of(record: NodeRecord, scheme):
    return scheme.unmarshal_secret(bytes.fromhex(record.secret_hex))
