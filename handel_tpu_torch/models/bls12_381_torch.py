"""BLS-over-BLS12-381 with verification on the card — counterpart of
handel_tpu/models/bls12_381_jax.py.

The second device curve behind the Constructor interface: `bn254-cuda` and
`bls12-381-cuda` share one launch engine. Everything of it (the range and
dense launch classes, the prefix table, the staging sets, the streams and
the dispatch lock, the batched combine, the RLC launch class) is
models/bn254_torch.py `BN254Device`'s; this module binds the BLS12-381
family (381-bit field in 24 limbs or 65 residues, M-type twist, |z|-bit
Miller loop) and the host wire formats of models/bls12_381.py. Every
multiply of a launch reaches kernel B1 at 24 limbs on the cios backend, and
the resident pairing reaches kernel B2 at k_all 65 on the rns backend.
"""

from __future__ import annotations

import random

from handel_tpu_torch.models.bls12_381 import (
    BLS12381Constructor,
    BLS12381PublicKey,
    BLS12381Scheme,
    BLS12381Signature,
    hash_to_g1,
)
from handel_tpu_torch.models.bn254_torch import BN254Device, BN254TorchConstructor
from handel_tpu_torch.ops import bls12_381_ref as bls
from handel_tpu_torch.ops.curve import BLS12Curves
from handel_tpu_torch.ops.pairing import BLS12Pairing


class BLS12381Device(BN254Device):
    """BLS12-381 binding of the verification engine."""

    ref = bls
    Curves = BLS12Curves
    Pairing = BLS12Pairing
    _hash_to_g1 = staticmethod(hash_to_g1)
    PublicKey = BLS12381PublicKey
    Signature = BLS12381Signature


class BLS12381TorchConstructor(BLS12381Constructor, BN254TorchConstructor):
    """Constructor whose `batch_verify` and `device_combine` run on the
    engine; wire formats and single-signature verify stay the host
    BLS12-381 scheme's. Arguments as BN254TorchConstructor."""

    Device = BLS12381Device

    def __init__(
        self,
        batch_size: int = 16,
        device=None,
        warmup: bool = True,
        batch_check: str = "per_candidate",
        curves: BLS12Curves | None = None,
        fp_backend: str | None = None,
        rns_resident: bool | None = None,
        rlc_rng: random.Random | None = None,
        mesh_devices: int = 1,
    ):
        BN254TorchConstructor.__init__(
            self, batch_size=batch_size, device=device, warmup=warmup,
            batch_check=batch_check, curves=curves, fp_backend=fp_backend,
            rns_resident=rns_resident, rlc_rng=rlc_rng, mesh_devices=mesh_devices,
        )


class BLS12381TorchScheme(BLS12381Scheme):
    """Keygen facade for harnesses: the host scheme's keygen and wire
    formats with the device-verification constructor."""

    def __init__(
        self,
        batch_size: int = 16,
        device=None,
        warmup: bool = True,
        batch_check: str = "per_candidate",
        fp_backend: str | None = None,
        rns_resident: bool | None = None,
        rlc_rng: random.Random | None = None,
        mesh_devices: int = 1,
    ):
        self.constructor = BLS12381TorchConstructor(
            batch_size=batch_size, device=device, warmup=warmup,
            batch_check=batch_check, fp_backend=fp_backend,
            rns_resident=rns_resident, rlc_rng=rlc_rng, mesh_devices=mesh_devices,
        )
