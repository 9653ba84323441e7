"""The port's Ed25519 scheme (handel_tpu_torch/models/eddsa.py and its
registry names) against the JAX package's, after tests/test_eddsa.py.

Tolerance: exact. Both are pure-Python big-int code: keys, signatures and
the fixed wire envelope must be the reference's byte for byte for the
same seeds, and every verdict the same.
"""

import asyncio
import random

import pytest

from handel_tpu.core.bitset import BitSet as JBitSet
from handel_tpu.core.crypto import MultiSignature as JMultiSignature
from handel_tpu.models import eddsa as jeddsa
from handel_tpu.models.registry import new_scheme as jnew_scheme
from handel_tpu_torch.core.bitset import BitSet
from handel_tpu_torch.core.crypto import MultiSignature, verify_multisignature
from handel_tpu_torch.core.identity import ArrayRegistry, Identity
from handel_tpu_torch.models import eddsa
from handel_tpu_torch.models.eddsa import MAX_SIGNERS, EdDSAScheme, new_keypair
from handel_tpu_torch.models.registry import is_device_scheme, new_scheme

MSG = b"eddsa unit message"


def test_rfc8032_vectors():
    # RFC 8032 §7.1 TEST 1 (empty message) and TEST 3 (two bytes), in both
    for mod in (eddsa, jeddsa):
        sk1 = mod.EdDSASecretKey(bytes.fromhex(
            "9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60"))
        assert sk1.enc_pub == bytes.fromhex(
            "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a")
        assert next(iter(sk1.sign(b"").sigs.values())) == bytes.fromhex(
            "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e0652249015"
            "55fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b")
        sk3 = mod.EdDSASecretKey(bytes.fromhex(
            "c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7"))
        assert sk3.enc_pub == bytes.fromhex(
            "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025")
        assert next(iter(sk3.sign(b"\xaf\x82").sigs.values())) == bytes.fromhex(
            "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3a"
            "c18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a")


@pytest.mark.parametrize("seed", [0, 1, 7, 123, 4095])
def test_keys_signatures_and_envelope_byte_equal(seed):
    ours, theirs = new_keypair(seed=seed), jeddsa.new_keypair(seed=seed)
    assert ours[0].marshal() == theirs[0].marshal()
    assert ours[1].marshal() == theirs[1].marshal()
    assert ours[0].enc_pub == theirs[0].enc_pub
    rng = random.Random(seed)
    for _ in range(3):
        msg = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 64)))
        a, b = ours[0].sign(msg), theirs[0].sign(msg)
        assert a.sigs == b.sigs
        assert a.marshal() == b.marshal()
        assert ours[1].verify(msg, a) and theirs[1].verify(msg, b)
        # each package accepts the other's signature through the wire
        assert ours[1].verify(msg, EdDSAScheme().constructor.unmarshal_signature(b.marshal()))
        assert theirs[1].verify(msg, jeddsa.EdDSAScheme().constructor.unmarshal_signature(
            a.marshal()))
        assert not ours[1].verify(msg + b"x", a)
    # the scheme's own keygen is the seeded one
    assert EdDSAScheme().keygen(seed)[1].marshal() == jeddsa.EdDSAScheme().keygen(seed)[1].marshal()


@pytest.mark.parametrize("k", [1, 2, 9, MAX_SIGNERS])
def test_aggregate_envelope_byte_equal_and_round_trips(k):
    scheme, jscheme = EdDSAScheme(), jeddsa.EdDSAScheme()
    agg = jagg = None
    for i in range(k):
        s, js = scheme.keygen(i)[0].sign(MSG), jscheme.keygen(i)[0].sign(MSG)
        agg = s if agg is None else agg.combine(s)
        jagg = js if jagg is None else jagg.combine(js)
    wire = agg.marshal()
    assert wire == jagg.marshal()
    assert len(wire) == scheme.constructor.signature_size() == jscheme.constructor.signature_size()
    back, jback = (scheme.constructor.unmarshal_signature(wire),
                   jscheme.constructor.unmarshal_signature(wire))
    assert back.sigs == jback.sigs == agg.sigs
    assert back.wire_cardinality() == k


def test_sign_verify_and_reject():
    sk, pk = new_keypair(seed=1)
    sig = sk.sign(MSG)
    assert pk.verify(MSG, sig)
    assert not pk.verify(b"other", sig)
    _, pk2 = new_keypair(seed=2)
    assert not pk2.verify(MSG, sig)  # wrong key: no matching kid entry
    assert not pk.verify(MSG, "not a signature")


@pytest.mark.parametrize("seed", range(3))
def test_combine_is_union_and_order_independent(seed):
    pairs = [new_keypair(seed=i) for i in range(6)]
    sigs = [sk.sign(MSG) for sk, _ in pairs]
    orders = [list(range(6)), list(reversed(range(6)))]
    rng = random.Random(seed)
    orders.append(rng.sample(range(6), 6))
    folds = []
    for order in orders:
        acc = sigs[order[0]]
        for i in order[1:]:
            acc = acc.combine(sigs[i])
        folds.append(acc)
    assert all(f.sigs == folds[0].sigs for f in folds)
    assert len({f.marshal() for f in folds}) == 1
    agg_pk = pairs[0][1]
    for _, pk in pairs[1:]:
        agg_pk = agg_pk.combine(pk)
    assert agg_pk.verify(MSG, folds[0])
    partial = sigs[0]
    for s in sigs[1:-1]:
        partial = partial.combine(s)
    assert not agg_pk.verify(MSG, partial)  # one missing entry fails


def test_capacity_enforced():
    for mod in (eddsa, jeddsa):
        pairs = [mod.new_keypair(seed=i) for i in range(MAX_SIGNERS + 1)]
        agg = pairs[0][0].sign(MSG)
        for sk, _ in pairs[1:]:
            agg = agg.combine(sk.sign(MSG))
        with pytest.raises(ValueError, match="sigs"):
            agg.marshal()
    assert eddsa.MAX_SIGNERS == jeddsa.MAX_SIGNERS


@pytest.mark.parametrize("data", [
    b"", b"\x00" * 100,  # truncated
    b"\x00\x41" + b"\x00" * (2 + 64 * 72),  # count 65 > MAX_SIGNERS
])
def test_malformed_envelopes_raise_alike(data):
    for cons in (EdDSAScheme().constructor, jeddsa.EdDSAScheme().constructor):
        with pytest.raises(ValueError):
            cons.unmarshal_signature(data)


def test_random_envelopes_verify_false_alike():
    rng = random.Random(5)
    _, pk = new_keypair(seed=3)
    _, jpk = jeddsa.new_keypair(seed=3)
    cons, jcons = EdDSAScheme().constructor, jeddsa.EdDSAScheme().constructor
    for _ in range(10):
        entry = pk.marshal()[:8] + bytes(rng.randrange(256) for _ in range(64))
        wire = b"\x00\x01" + entry + b"\x00" * ((MAX_SIGNERS - 1) * 72)
        assert pk.verify(MSG, cons.unmarshal_signature(wire)) is False
        assert jpk.verify(MSG, jcons.unmarshal_signature(wire)) is False


def test_public_key_round_trip():
    scheme = EdDSAScheme()
    sk, pk = scheme.keygen(4)
    enc = pk.marshal()
    assert len(enc) == 32
    assert enc == jeddsa.EdDSAScheme().keygen(4)[1].marshal()
    assert scheme.unmarshal_public(enc).verify(MSG, sk.sign(MSG))
    assert scheme.unmarshal_secret(sk.marshal()).enc_pub == sk.enc_pub
    with pytest.raises(ValueError):
        eddsa.point_decompress(b"\xff" * 31)


@pytest.mark.parametrize("name", ["eddsa", "ed25519", "EdDSA"])
def test_registry_dispatch(name):
    assert type(new_scheme(name)) is EdDSAScheme
    assert type(jnew_scheme(name)) is jeddsa.EdDSAScheme
    assert not is_device_scheme(name)


def test_registry_multisignature_verifies_and_rejects():
    scheme = new_scheme("ed25519")
    n = 6
    pairs = [scheme.keygen(i) for i in range(n)]
    reg = ArrayRegistry([Identity(i, f"eddsa-{i}", pk) for i, (_, pk) in enumerate(pairs)])
    bs, jbs = BitSet(n), JBitSet(n)
    agg = None
    for i in (0, 2, 5):
        bs.set(i, True)
        jbs.set(i, True)
        s = pairs[i][0].sign(MSG)
        agg = s if agg is None else agg.combine(s)
    ms = MultiSignature(bs, agg)
    assert verify_multisignature(MSG, ms, reg, scheme.constructor)
    wire = ms.marshal()
    # the JAX package's MultiSignature over the reference's scheme: same bytes
    jagg = None
    for i in (0, 2, 5):
        js = jeddsa.EdDSAScheme().keygen(i)[0].sign(MSG)
        jagg = js if jagg is None else jagg.combine(js)
    assert JMultiSignature(jbs, jagg).marshal() == wire
    back = MultiSignature.unmarshal(wire, scheme.constructor)
    assert verify_multisignature(MSG, back, reg, scheme.constructor)
    # a bitset claiming a signer whose entry is absent must fail
    bs.set(1, True)
    assert not verify_multisignature(MSG, MultiSignature(bs, agg), reg, scheme.constructor)


def eddsa_round(n: int):
    from handel_tpu_torch.core.test_harness import LocalCluster

    async def go():
        cluster = LocalCluster(n, threshold=n, scheme=new_scheme("eddsa"))
        cluster.start()
        try:
            finals = await cluster.wait_complete_success(timeout=120)
        finally:
            cluster.stop()
        return cluster, finals

    return asyncio.run(go())


def test_small_protocol_round_over_eddsa():
    """A 4-node round over Ed25519 through the port's harness: every node's
    final holds all 4 signers and verifies."""
    cluster, finals = eddsa_round(4)
    assert len(finals) == 4
    for ms in finals.values():
        assert ms.bitset.cardinality() == 4
        assert verify_multisignature(cluster.msg, ms, cluster.registry,
                                     cluster.scheme.constructor)


@pytest.mark.slow
def test_protocol_round_over_eddsa():
    """The reference's slow-tier round: 8 nodes over Ed25519."""
    _, finals = eddsa_round(8)
    assert next(iter(finals.values())).bitset.cardinality() == 8


def test_eddsa_compare(tmp_path):
    """The port's counterpart of scripts/eddsa_compare.py at 16 nodes (its
    default is 64): both schemes' pipelines pass their verify and forgery
    checks, and the record's wire sizes are the reference schemes'."""
    import json

    from handel_tpu_torch.scripts import eddsa_compare

    out = tmp_path / "e.json"
    assert eddsa_compare.main(["16", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["nodes"] == 16 and rec["clock"] == "host"
    for name in ("eddsa", "bn254"):
        got = rec["schemes"][name]
        assert got["agg_sig_bytes"] == jnew_scheme(name).constructor.signature_size()
        assert all(got[k] >= 0 for k in ("keygen_ms", "sign_ms", "aggregate_ms", "verify_ms"))
