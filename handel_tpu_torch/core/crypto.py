"""Signature-scheme interfaces — the part of handel_tpu/core/crypto.py that
the port's host scheme and device constructor need.

Reference: crypto.go:14-137 — the `PublicKey`/`SecretKey`/`Signature`
protocols and the `Constructor` factory whose `batch_verify` a device scheme
overrides with one batched multi-pairing launch. `MultiSignature` and
`verify_multisignature` are not copied: nothing in the port uses them yet.
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
