"""Node identities and the registry — a copy of handel_tpu/core/identity.py.

Reference: identity.go:11-134 — `Identity` (address + public key + int32 id),
`Registry` (size / identity(i) / identities(from,to)), the array-backed
implementation, and the deterministic seeded shuffle (identity.go:116-125) used
to randomize per-level candidate ordering. The same `random.Random` seed
gives the JAX package's peer order.
"""

from __future__ import annotations

import random
from typing import Sequence

from handel_tpu_torch.core.crypto import PublicKey


class Identity:
    """A participant: network address + public key + dense integer id."""

    __slots__ = ("id", "address", "public_key")

    def __init__(self, id: int, address: str, public_key: PublicKey | None):
        self.id = id
        self.address = address
        self.public_key = public_key

    def __repr__(self) -> str:
        return f"Identity(id={self.id}, addr={self.address!r})"


class Registry:
    """Registry interface (identity.go:24-31)."""

    def size(self) -> int:
        raise NotImplementedError

    def identity(self, idx: int) -> Identity:
        raise NotImplementedError

    def identities(self, from_idx: int, to_idx: int) -> Sequence[Identity]:
        """Identities in [from_idx, to_idx) — empty on out-of-range."""
        raise NotImplementedError

    def public_keys(self) -> list[PublicKey]:
        """The registry's keys in id order."""
        return [self.identity(i).public_key for i in range(self.size())]

    def identity_range(self, from_idx: int, to_idx: int) -> "RegistrySlice":
        """O(1) read-only view of [from_idx, to_idx) — no per-call copy of
        the level's candidates."""
        lo = max(0, from_idx)
        hi = min(self.size(), to_idx)
        return RegistrySlice(self, lo, max(lo, hi))


class RegistrySlice(Sequence):
    """Lazy contiguous registry window: Sequence protocol over identity(i)."""

    __slots__ = ("_reg", "_lo", "_hi")

    def __init__(self, registry: Registry, lo: int, hi: int):
        self._reg = registry
        self._lo = lo
        self._hi = hi

    def __len__(self) -> int:
        return self._hi - self._lo

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            lo, hi, step = idx.indices(len(self))
            if step == 1:
                return RegistrySlice(self._reg, self._lo + lo, self._lo + hi)
            return [self._reg.identity(self._lo + i) for i in range(lo, hi, step)]
        if idx < 0:
            idx += len(self)
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        return self._reg.identity(self._lo + idx)

    def __iter__(self):
        for i in range(self._lo, self._hi):
            yield self._reg.identity(i)

    def __repr__(self) -> str:
        return f"RegistrySlice([{self._lo},{self._hi}))"


class ArrayRegistry(Registry):
    """Dense array-backed registry (identity.go:60-98)."""

    def __init__(self, identities: Sequence[Identity]):
        self._ids = list(identities)
        self._pks: list[PublicKey] | None = None
        for i, ident in enumerate(self._ids):
            if ident.id != i:
                raise ValueError(f"registry identity {i} has id {ident.id}")

    def size(self) -> int:
        return len(self._ids)

    def identity(self, idx: int) -> Identity:
        return self._ids[idx]

    def identities(self, from_idx: int, to_idx: int) -> Sequence[Identity]:
        if from_idx < 0 or to_idx > len(self._ids) or from_idx > to_idx:
            return []
        return self._ids[from_idx:to_idx]

    def public_keys(self) -> list[PublicKey]:
        """The registry's keys in id order, one cached list: every node of
        an in-process cluster hands this same object to the device
        constructor, which keys its registry bank on it."""
        if self._pks is None:
            self._pks = [i.public_key for i in self._ids]
        return self._pks


def shuffle(items: list, seed_rng: random.Random) -> None:
    """Deterministic in-place Fisher-Yates shuffle (identity.go:116-125).

    Callers pass a `random.Random` seeded from Config.rand so that level
    candidate orderings are reproducible across runs and in tests.
    """
    for i in range(len(items) - 1, 0, -1):
        j = seed_rng.randrange(i + 1)
        items[i], items[j] = items[j], items[i]
