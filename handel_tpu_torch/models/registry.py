"""String -> signature-scheme dispatch — a copy of handel_tpu/models/registry.py.

Reference: simul/lib/config.go:211-225 (`Config.NewConstructor`). The names
select both keygen and the verify path; the device schemes verify on the
port's engine (models/bn254_torch.py), on the card unless the caller passes
`device="cpu"`.

One table holds every alias: canonical name -> (is_device, factory), so a
new alias cannot miss the batch-size plumbing in sim/node.py.

The port's device schemes are `bn254-cuda` (alias `bn256-cuda`) and
`bls12-381-cuda`. The JAX package's device names select them here
(`bn254-jax`, `bn254-tpu` and `bn256-tpu` the first; `bls12-381-jax`,
`bls12-381-tpu` and `bls12381-jax` the second), so that the repo's
`results/*_device.toml` configs run unchanged. `bls12-381` and `bls12381`
name the host scheme, and `eddsa` and `ed25519` the pure-Python Ed25519
control group (models/eddsa.py).
"""

from __future__ import annotations


def _fake(**kw):
    from handel_tpu_torch.models.fake import FakeScheme

    return FakeScheme()


def _bn254(**kw):
    from handel_tpu_torch.models.bn254 import BN254Scheme

    return BN254Scheme()


def _bn254_cuda(**kw):
    from handel_tpu_torch.models.bn254_torch import BN254TorchScheme

    return BN254TorchScheme(**kw)


def _bls12_381(**kw):
    from handel_tpu_torch.models.bls12_381 import BLS12381Scheme

    return BLS12381Scheme()


def _bls12_381_cuda(**kw):
    from handel_tpu_torch.models.bls12_381_torch import BLS12381TorchScheme

    return BLS12381TorchScheme(**kw)


def _eddsa(**kw):
    from handel_tpu_torch.models.eddsa import EdDSAScheme

    return EdDSAScheme()

# alias -> (is_device_scheme, factory)
_TABLE = {
    "fake": (False, _fake),
    "empty": (False, _fake),
    "bn254": (False, _bn254),
    "bn256": (False, _bn254),
    "bn254-ref": (False, _bn254),
    "bn254-cuda": (True, _bn254_cuda),
    "bn256-cuda": (True, _bn254_cuda),
    "bn254-jax": (True, _bn254_cuda),
    "bn254-tpu": (True, _bn254_cuda),
    "bn256-tpu": (True, _bn254_cuda),
    "eddsa": (False, _eddsa),
    "ed25519": (False, _eddsa),
    "bls12-381": (False, _bls12_381),
    "bls12381": (False, _bls12_381),
    "bls12-381-cuda": (True, _bls12_381_cuda),
    "bls12-381-jax": (True, _bls12_381_cuda),
    "bls12-381-tpu": (True, _bls12_381_cuda),
    "bls12381-jax": (True, _bls12_381_cuda),
}


def new_scheme(name: str, **kwargs):
    entry = _TABLE.get(name.lower())
    if entry is None:
        raise ValueError(f"unknown signature scheme: {name!r}")
    return entry[1](**kwargs)


def host_scheme_name(name: str) -> str:
    """The host scheme that shares `name`'s keys and signatures: `bn254`
    for a BN254 device name, `bls12-381` for a BLS12-381 one, and `name`
    itself for a host scheme. The sim's baselines verify on the host, so a
    device scheme's baseline run builds this one and holds no card state
    (ROADMAP §C, deviation 8)."""
    entry = _TABLE.get(name.lower())
    if entry is None:
        raise ValueError(f"unknown signature scheme: {name!r}")
    return {_bn254_cuda: "bn254", _bls12_381_cuda: "bls12-381"}.get(entry[1], name)


def is_device_scheme(name: str) -> bool:
    """True when `name` selects a device-verification scheme (one whose
    constructor accepts batch_size and exposes a Device class)."""
    entry = _TABLE.get(name.lower())
    return bool(entry and entry[0])
