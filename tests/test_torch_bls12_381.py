"""The port's BLS12-381 family against the JAX package's, exactly.

* the scalar oracle (handel_tpu_torch/ops/bls12_381_ref.py) against
  handel_tpu/ops/bls12_381_ref.py: constants, G1/G2 group ops, the Fp12
  arithmetic, the Miller loop, the (cubed) final exponentiation and the
  product check;
* the host scheme (models/bls12_381.py): keys from seeds, signatures,
  aggregation and the wire bytes of G1, G2 and infinity, across packages;
* `BLS12Curves` (24 limbs, both field backends), the tower at 381 bits
  (Frobenius constants, conjugation, cyclotomic squaring and powers, the
  inverse, the resident tower at k_all 65 with its Fermat inverse) and
  `BLS12Pairing` at 2-4 lanes, against the oracle;
* the scheme table and the RLC seam.

Every expected value comes from the JAX package's own oracle
(handel_tpu/ops/bls12_381_ref.py) on the same seeded inputs. A JAX
BLS12-381 pairing graph takes minutes of XLA compilation on the CPU, so the
port's curves and pairing are held here to that oracle, the one the JAX
pairing is itself validated against (tests/test_bls12_381_jax.py);
tests/test_torch_bls12_381_device.py has the slow-tier parity runs through
the JAX curves and pairing.
"""

import random

import pytest
import torch

from handel_tpu.models import bls12_381 as jhost
from handel_tpu.models import registry as jreg
from handel_tpu.models import rlc as jrlc
from handel_tpu.ops import bls12_381_ref as jbls
from handel_tpu_torch.models import bls12_381 as phost
from handel_tpu_torch.models import registry as preg
from handel_tpu_torch.models import rlc as prlc
from handel_tpu_torch.ops import bls12_381_ref as bls
from handel_tpu_torch.ops.curve import BLS12Curves
from handel_tpu_torch.ops.pairing import BLS12Pairing

torch.set_num_threads(1)


def _points(seed, k=4):
    rng = random.Random(seed)
    g1 = [jbls.g1_mul(jbls.G1_GEN, rng.randrange(1, jbls.R)) for _ in range(k)]
    g2 = [jbls.g2_mul(jbls.G2_GEN, rng.randrange(1, jbls.R)) for _ in range(k)]
    return g1, g2


# -- the scalar oracle ---------------------------------------------------------


@pytest.mark.parametrize("name", ["P", "R", "Z", "B", "G1_GEN", "G2_GEN", "XI", "TWIST_B",
                                  "_GAMMA", "F12_ONE"])
def test_oracle_constants_equal(name):
    assert getattr(bls, name) == getattr(jbls, name)


def test_oracle_group_ops_equal():
    g1, g2 = _points(1)
    k = 0x1234_5678_9ABC
    for a, b in zip(g1, g1[1:] + [None]):
        assert bls.g1_add(a, b) == jbls.g1_add(a, b)
        assert bls.g1_mul(a, k) == jbls.g1_mul(a, k)
        assert bls.g1_neg(a) == jbls.g1_neg(a)
        assert bls.g1_is_valid(a) and jbls.g1_is_valid(a)
    for a, b in zip(g2[:2], [g2[1], None]):
        assert bls.g2_add(a, b) == jbls.g2_add(a, b)
        assert bls.g2_mul(a, k) == jbls.g2_mul(a, k)
        assert bls.g2_neg(a) == jbls.g2_neg(a)
    assert bls.g2_is_valid(g2[0]) and jbls.g2_is_valid(g2[0])
    off = (g1[0][0], (g1[0][1] + 1) % bls.P)
    assert not bls.g1_is_valid(off) and not jbls.g1_is_valid(off)


def test_oracle_pairing_equal():
    g1, g2 = _points(2, 2)
    for p, q in zip(g1, g2):
        f = bls.miller_loop(q, p)
        assert f == jbls.miller_loop(q, p)
        assert bls.final_exponentiation(f) == jbls.final_exponentiation(f)
        assert bls.f12_frobenius2(f) == jbls.f12_frobenius2(f)
        assert bls.f12_inv(f) == jbls.f12_inv(f)
    a = 0xDEAD_BEEF
    good = [(bls.g1_mul(g1[0], a), g2[0]), (bls.g1_neg(g1[0]), bls.g2_mul(g2[0], a))]
    bad = [good[0], (bls.g1_neg(g1[0]), bls.g2_mul(g2[0], a + 1))]
    assert bls.pairing_check(good) and jbls.pairing_check(good)
    assert not bls.pairing_check(bad) and not jbls.pairing_check(bad)


# -- the host scheme -------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_keypairs_signatures_and_wire_bytes_equal(seed):
    msg = b"bls12-381 host parity"
    psk, ppk = phost.new_keypair(seed=seed)
    jsk, jpk = jhost.new_keypair(seed=seed)
    assert psk.scalar == jsk.scalar and ppk.point == jpk.point
    assert psk.marshal() == jsk.marshal()
    assert ppk.marshal() == jpk.marshal()
    assert len(ppk.marshal()) == 192
    assert phost.hash_to_g1(msg) == jhost.hash_to_g1(msg)
    psig, jsig = psk.sign(msg), jsk.sign(msg)
    assert psig.marshal() == jsig.marshal() and len(psig.marshal()) == 96
    assert ppk.verify(msg, psig) and not ppk.verify(msg + b"!", psig)
    # aggregation, and each package reading the other's bytes
    osk, opk = phost.new_keypair(seed=seed + 100)
    agg, aggpk = psig.combine(osk.sign(msg)), ppk.combine(opk)
    assert aggpk.verify(msg, agg)
    assert jhost.unmarshal_g1(agg.marshal()) == agg.point
    assert jhost.unmarshal_g2(aggpk.marshal()) == aggpk.point
    assert phost.unmarshal_g2(jpk.marshal()) == jpk.point
    scheme = phost.BLS12381Scheme()
    assert scheme.unmarshal_public(ppk.marshal()) == ppk
    assert scheme.unmarshal_secret(psk.marshal()).scalar == psk.scalar
    assert scheme.constructor.unmarshal_signature(jsig.marshal() + b"tail") == psig


def test_wire_bytes_of_infinity_and_bad_points():
    assert phost.marshal_g1(None) == jhost.marshal_g1(None) == b"\x00" * 96
    assert phost.marshal_g2(None) == jhost.marshal_g2(None) == b"\x00" * 192
    assert phost.unmarshal_g1(b"\x00" * 96) is None
    assert phost.unmarshal_g2(b"\x00" * 192) is None
    assert phost.BLS12381Scheme().constructor.signature_size() == 96
    big = bls.P.to_bytes(48, "big") + b"\x00" * 48
    off = bls.G1_GEN[0].to_bytes(48, "big") + (bls.G1_GEN[1] + 1).to_bytes(48, "big")
    for bad in (b"\x01" * 95, big, off):
        with pytest.raises(ValueError):
            phost.unmarshal_g1(bad)
        with pytest.raises(ValueError):
            jhost.unmarshal_g1(bad)
    with pytest.raises(ValueError):
        phost.unmarshal_g2(b"\x01" * 191)


# -- curves and tower at 381 bits --------------------------------------------------


@pytest.fixture(scope="module", params=["cios", "rns"])
def stack(request):
    curves = BLS12Curves(device="cpu", backend=request.param)
    return curves, BLS12Pairing(curves)


def test_curves_bind_the_family(stack):
    curves, pr = stack
    assert curves.F.nlimbs == 24 and curves.params is bls and curves.g1.ops.b3 == 12
    if curves.F.backend == "rns":
        assert curves.F.k_all == 65 and (curves.F.kA, curves.F.kB) == (34, 30)
        assert pr.resident
    else:
        assert not pr.resident
    assert BLS12Pairing(device="cpu").curves.params is bls


def test_curve_ops_match_oracle(stack):
    curves, _ = stack
    g1, g2 = _points(3)
    P, Q = curves.pack_g1(g1), curves.pack_g2(g2)
    assert curves.unpack_g1(curves.g1.double(P)) == [jbls.g1_add(p, p) for p in g1]
    assert curves.unpack_g2(curves.g2.double(Q)) == [jbls.g2_add(q, q) for q in g2]
    P2 = curves.pack_g1(g1[1:] + [None])
    Q2 = curves.pack_g2([g2[1], None, jbls.g2_neg(g2[2]), g2[0]])
    assert curves.unpack_g1(curves.g1.add(P, P2)) == [
        jbls.g1_add(a, b) for a, b in zip(g1, g1[1:] + [None])]
    assert curves.unpack_g2(curves.g2.add(Q, Q2)) == [
        jbls.g2_add(a, b) for a, b in zip(g2, [g2[1], None, jbls.g2_neg(g2[2]), g2[0]])]
    assert bool(curves.g1.on_curve(P).all()) and bool(curves.g2.on_curve(Q).all())
    # a block-major tree sum of 4 blocks of 1 lane: the sum of all four
    s1 = curves.unpack_g1(curves.g1.sum_points(P, 4))
    s2 = curves.unpack_g2(curves.g2.sum_points(Q, 4))
    want1, want2 = None, None
    for p, q in zip(g1, g2):
        want1, want2 = jbls.g1_add(want1, p), jbls.g2_add(want2, q)
    assert s1 == [want1] and s2 == [want2]


def _cyclotomic(seed, k):
    """Seeded Fp12 elements f^((p^6-1)(p^2+1)) (the cyclotomic subgroup) from
    Miller values of random points."""
    g1, g2 = _points(seed, k)
    out = []
    for p, q in zip(g1, g2):
        f = jbls.miller_loop(q, p)
        f = jbls.f12_mul(jbls.f12_conj(f), jbls.f12_inv(f))
        out.append(jbls.f12_mul(jbls.f12_frobenius2(f), f))
    return out


def test_tower_at_381_bits(stack):
    """Frobenius constants, conjugation, Frobenius^2, the inverse, the
    cyclotomic squaring and a cyclotomic power by |z| against the oracle;
    on the rns backend each also through the resident tower (k_all 65; its
    inverse is the Fermat power on residues)."""
    curves, _ = stack
    T = curves.T
    for j in range(1, 6):
        assert T.f2_unpack(T._gamma[j]) == [jbls._GAMMA[j]]
    xs = _cyclotomic(4, 2)
    towers = [(T, lambda a: a, lambda a: a)]
    if curves.F.backend == "rns":
        R = T.as_resident()
        assert R.F.nlimbs == 65
        flat_in = lambda a: _f12_map(a, curves.F.to_resident)  # noqa: E731
        flat_out = lambda a: _f12_map(a, curves.F.from_resident)  # noqa: E731
        towers.append((R, flat_in, flat_out))
    for Tw, into, out in towers:
        a = into(T.f12_pack(xs))
        got = lambda v: T.f12_unpack(out(v))  # noqa: E731
        assert got(Tw.f12_conj(a, 22)) == [jbls.f12_conj(x) for x in xs]
        assert got(Tw.f12_frobenius2(a)) == [jbls.f12_frobenius2(x) for x in xs]
        assert got(Tw.f12_inv(a)) == [jbls.f12_inv(x) for x in xs]
        assert got(Tw.f12_cyclo_sqr(a)) == [jbls.f12_mul(x, x) for x in xs]
        assert got(Tw.f12_pow_const(a, -jbls.Z, cyclo=True)) == [
            jbls.f12_pow(x, -jbls.Z) for x in xs]


def _f12_map(a, fn):
    return tuple(tuple(tuple(fn(c) for c in e2) for e2 in e6) for e6 in a)


def _pack_pairs(curves, g1, g2):
    F, T = curves.F, curves.T
    return ((F.pack([p[0] for p in g1]), F.pack([p[1] for p in g1])),
            (T.f2_pack([q[0] for q in g2]), T.f2_pack([q[1] for q in g2])))


def test_pairing_matches_oracle(stack):
    """Miller values and whole pairings (Miller loop and final
    exponentiation, resident on rns) of three lanes and a masked one
    (test_bls12_381_jax.py's case, mirrored)."""
    curves, pr = stack
    g1, g2 = _points(5, 3)
    p, q = _pack_pairs(curves, g1 + [g1[0]], g2 + [g2[0]])
    mask = torch.tensor([True, True, True, False])
    f = pr.miller_loop(p, q, mask)
    want = [jbls.miller_loop(b, a) for a, b in zip(g1, g2)]
    assert curves.T.f12_unpack(f) == want + [jbls.F12_ONE]
    e = pr.pairing(p, q, mask)
    assert curves.T.f12_unpack(e) == [jbls.final_exponentiation(x) for x in want] + [jbls.F12_ONE]
    assert pr.gt_is_one(e).tolist() == [False, False, False, True]


def test_pairing_check_bls_verdicts(stack):
    """e(H, X_j) e(-S_j, B2) == 1 over two candidates in the pair-chunk-major
    layout; the second is signed with the wrong key."""
    curves, pr = stack
    rng = random.Random(11)
    h = jbls.g1_mul(jbls.G1_GEN, rng.randrange(1, jbls.R))
    sks = [rng.randrange(1, jbls.R) for _ in range(2)]
    pks = [jbls.g2_mul(jbls.G2_GEN, sk) for sk in sks]
    sigs = [jbls.g1_mul(h, sks[0]), jbls.g1_mul(h, sks[1] + 1)]
    g1 = [h, h] + [jbls.g1_neg(s) for s in sigs]
    g2 = pks + [jbls.G2_GEN] * 2
    p, q = _pack_pairs(curves, g1, g2)
    got = pr.pairing_check(p, q, torch.ones(4, dtype=torch.bool), 2)
    assert got.tolist() == [True, False]
    assert [jbls.pairing_check([(h, pk), (jbls.g1_neg(s), jbls.G2_GEN)])
            for pk, s in zip(pks, sigs)] == [True, False]


# -- the scheme table, the default device and the RLC seam ----------------------------


@pytest.mark.parametrize("name", ["bls12-381", "bls12381", "bls12-381-cuda", "bls12-381-jax",
                                  "bls12-381-tpu", "bls12381-jax", "BLS12-381-JAX"])
def test_aliases_resolve_to_the_port(name):
    from handel_tpu_torch.models.bls12_381_torch import BLS12381TorchScheme

    if preg.is_device_scheme(name):
        s = preg.new_scheme(name, batch_size=4, device="cpu", warmup=False, fp_backend="rns")
        assert isinstance(s, BLS12381TorchScheme)
        assert s.constructor.batch_size == 4 and s.constructor.curves.F.backend == "rns"
        assert s.constructor.Device.Curves is BLS12Curves
    else:
        assert type(preg.new_scheme(name)) is phost.BLS12381Scheme


@pytest.mark.parametrize("name", sorted(set(jreg._TABLE) & set(preg._TABLE)))
def test_device_table_agrees_with_the_reference(name):
    assert preg.is_device_scheme(name) == jreg.is_device_scheme(name)


def test_device_scheme_runs_on_the_card_unless_asked():
    from handel_tpu_torch.models.bls12_381_torch import BLS12381TorchScheme

    assert BLS12381TorchScheme(device="cpu").constructor.curves.device.type == "cpu"
    if torch.cuda.is_available():
        assert BLS12381TorchScheme().constructor.curves.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            BLS12381TorchScheme()


def test_rlc_host_ops_and_bisection_match_the_reference():
    """`host_ops_for` gives the BLS12-381 table for the port's constructors;
    `bisect_verify` over it, with the same scalar draws, gives the JAX
    package's verdicts and counters on a batch with one forgery."""
    from handel_tpu_torch.models.bls12_381_torch import BLS12381TorchScheme

    for cons in (phost.BLS12381Constructor(),
                 BLS12381TorchScheme(device="cpu", warmup=False).constructor):
        assert prlc.host_ops_for(cons).g2_gen == jbls.G2_GEN
    assert prlc.host_ops_for(jhost.BLS12381Constructor()) is not None
    assert jrlc.host_ops_for(jhost.BLS12381Constructor()).g2_gen == jbls.G2_GEN
    rng = random.Random(21)
    msgs = [b"m0", b"m1"]
    sks = [rng.randrange(1, 1 << 30) for _ in range(4)]
    cands = []
    for j, sk in enumerate(sks):
        msg = msgs[j % 2]
        sig = jbls.g1_mul(phost.hash_to_g1(msg), sk + (1 if j == 2 else 0))
        cands.append((msg, jbls.g2_mul(jbls.G2_GEN, sk), sig))

    def run(rlc, ops):
        stats = rlc.RlcStats()
        draw = random.Random(5)
        verdicts = rlc.bisect_verify(
            list(range(len(cands))),
            lambda sub: rlc.host_rlc_check(ops, [cands[j] for j in sub], draw, stats),
            lambda j: rlc.host_rlc_check(ops, [cands[j]], draw, stats), stats)
        return verdicts, (stats.bisection_ct, stats.miller_lanes, stats.final_exp_lanes)

    ours = run(prlc, prlc.bls12_381_host_ops())
    theirs = run(jrlc, jrlc.bls12_381_host_ops())
    assert ours == theirs
    assert [ours[0][j] for j in range(4)] == [True, True, False, True]


def test_bls12_381_host_ops_equal_the_reference_table():
    ours, theirs = prlc.bls12_381_host_ops(), jrlc.bls12_381_host_ops()
    g1, g2 = _points(6, 2)
    ks = [3, 0x1_0000_0001]
    assert ours.g1_mul_batch(g1, ks) == theirs.g1_mul_batch(g1, ks)
    assert ours.g2_sum(g2) == theirs.g2_sum(g2)
    assert ours.hash_to_g1(b"x") == theirs.hash_to_g1(b"x")
    assert ours.g1_neg(g1[0]) == theirs.g1_neg(g1[0])


@pytest.mark.parametrize("fp_backend", ["cios", "rns"])
def test_sim_node_takes_the_device_scheme(fp_backend):
    """A sim config naming bls12-381-cuda builds the device scheme the way
    sim/node.py does, its mesh width included (nothing BLS-specific is
    refused)."""
    from handel_tpu_torch.models.bls12_381_torch import BLS12381TorchScheme
    from handel_tpu_torch.sim.config import RunConfig, SimConfig

    cfg = SimConfig(network="udp", scheme="bls12-381-cuda", shared_verifier=True,
                    batch_size=4, fp_backend=fp_backend, mesh_devices=2,
                    runs=[RunConfig(nodes=4, threshold=3, processes=1)])
    assert preg.is_device_scheme(cfg.scheme)
    scheme = preg.new_scheme(cfg.scheme, batch_size=cfg.batch_size,
                             mesh_devices=cfg.mesh_devices, fp_backend=cfg.fp_backend,
                             rns_resident=None, device="cpu")
    assert isinstance(scheme, BLS12381TorchScheme)
    assert scheme.constructor.curves.F.backend == fp_backend
    assert scheme.constructor.mesh_devices == 2
