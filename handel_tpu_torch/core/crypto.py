"""Signature-scheme interfaces and the MultiSignature wire object — a copy
of handel_tpu/core/crypto.py.

Reference: crypto.go:14-137 — the `PublicKey`/`SecretKey`/`Signature`
protocols, the `Constructor` factory whose `batch_verify` a device scheme
overrides with one batched multi-pairing launch, `MultiSignature` (bitset
plus aggregate signature) with its wire format (crypto.go:65-110), and
`verify_multisignature` (crypto.go:120-137).
"""

from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

from handel_tpu_torch.core.bitset import BitSet


@runtime_checkable
class Signature(Protocol):
    """An individual or aggregate signature (crypto.go:46-56)."""

    def marshal(self) -> bytes: ...

    def combine(self, other: "Signature") -> "Signature":
        """Aggregate (not verify) this signature with another one."""
        ...


@runtime_checkable
class PublicKey(Protocol):
    """A public key (crypto.go:14-27)."""

    def marshal(self) -> bytes: ...

    def verify(self, msg: bytes, sig: Signature) -> bool: ...

    def combine(self, other: "PublicKey") -> "PublicKey": ...


@runtime_checkable
class SecretKey(Protocol):
    """A secret key (crypto.go:36-41)."""

    def sign(self, msg: bytes) -> Signature: ...


class Constructor:
    """Factory for a signature scheme's objects (crypto.go:29-44).

    Subclasses implement `unmarshal_signature`/`signature_size` and may
    override the batch helpers with device kernels."""

    def unmarshal_signature(self, data: bytes) -> Signature:
        raise NotImplementedError

    def signature_size(self) -> int:
        """Fixed wire size of one (possibly aggregate) signature in bytes."""
        raise NotImplementedError

    def aggregate_public_keys(
        self, keys: Sequence[PublicKey], bitset: BitSet
    ) -> PublicKey:
        """Sum of `keys[i]` for every set bit i (crypto.go:126-134 loop)."""
        agg = None
        for i in bitset.indices():
            agg = keys[i] if agg is None else agg.combine(keys[i])
        if agg is None:
            raise ValueError("empty bitset: no public keys to aggregate")
        return agg

    def batch_verify(
        self,
        msg: bytes,
        pubkeys: Sequence[PublicKey],
        requests: Sequence[tuple[BitSet, Signature]],
    ) -> list[bool]:
        """Verify many (bitset, aggregate signature) candidates against one
        msg. Default: serial aggregate-then-verify (processing.go:342-368);
        device schemes override this with one batched launch."""
        out = []
        for bs, sig in requests:
            if bs.cardinality() == 0:
                out.append(False)
                continue
            out.append(self.aggregate_public_keys(pubkeys, bs).verify(msg, sig))
        return out


class MultiSignature:
    """A (bitset, aggregate signature) pair — the protocol's unit of gossip.

    Wire format (crypto.go:65-110): the marshaled bitset (core/bitset.py)
    followed by the fixed-size signature bytes.
    """

    __slots__ = ("bitset", "signature")

    def __init__(self, bitset: BitSet, signature: Signature):
        self.bitset = bitset
        self.signature = signature

    def cardinality(self) -> int:
        return self.bitset.cardinality()

    def marshal(self) -> bytes:
        return self.bitset.marshal() + self.signature.marshal()

    @classmethod
    def unmarshal(cls, data: bytes, constructor: Constructor) -> "MultiSignature":
        bs, used = BitSet.unmarshal(data)
        sig_bytes = data[used:]
        if len(sig_bytes) < constructor.signature_size():
            raise ValueError("multisignature wire data truncated")
        sig = constructor.unmarshal_signature(
            sig_bytes[: constructor.signature_size()]
        )
        return cls(bs, sig)

    def __repr__(self) -> str:
        return f"MultiSignature(bits={self.bitset!r})"


def verify_multisignature(
    msg: bytes,
    ms: MultiSignature,
    registry: "Registry",  # noqa: F821 - core/identity.py imports this module
    constructor: Constructor,
) -> bool:
    """Registry-wide final verification (crypto.go:120-137): aggregate the
    public keys of every signer in `ms.bitset` over the full registry and
    check the aggregate signature against `msg`, on the host."""
    n = registry.size()
    if len(ms.bitset) != n:
        return False
    if ms.bitset.cardinality() == 0:
        return False
    keys = [registry.identity(i).public_key for i in range(n)]
    agg = constructor.aggregate_public_keys(keys, ms.bitset)
    return agg.verify(msg, ms.signature)
