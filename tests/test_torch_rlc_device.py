"""The port's RLC launch class and mixed-message launches on the CPU engine
(handel_tpu_torch/models/bn254_torch.py `BN254Device` with
batch_check="rlc", `dispatch_multi`) against the JAX package.

Requests are built with the JAX package's BitSet and signature objects, as
in tests/test_torch_bn254_device.py. RLC verdicts must equal the ones known
by construction (the per-candidate verdicts) and the reference HostDevice's
RLC verdicts; the counters follow the M+1 / 1 contract; the affine (S, X)
that the launch's MSM stage hands its pairing tail must equal the sums the
JAX package's scalar oracle computes for the same scalars.
"""

import random

import numpy as np
import pytest
import torch

from handel_tpu import native as nat
from handel_tpu.core.bitset import BitSet
from handel_tpu.models.bn254 import BN254PublicKey, BN254Scheme, BN254Signature, hash_to_g1
from handel_tpu.ops import bn254_ref as jbn
from handel_tpu.ops.fp import Field as JField
from handel_tpu.service.driver import HostDevice as JHostDevice
from handel_tpu_torch.models.bn254_torch import BN254Device

torch.set_num_threads(1)

N = 12
C = 4


class SmallCapDevice(BN254Device):
    """A lowered hole cap, so that a 12-key registry reaches the dense class."""

    MISS_CAP = 2


@pytest.fixture(scope="module")
def registry():
    rng = random.Random(41)
    sks = [rng.randrange(1, 1 << 20) for _ in range(N)]
    pks = [BN254PublicKey(p) for p in nat.g2_mul_batch([jbn.G2_GEN] * N, sks)]
    return sks, pks


def item(sks, msg, idx, forge=False):
    """(msg, bitset, sig); a forged candidate's signature is off by one."""
    bs = BitSet(N)
    for i in idx:
        bs.set(i, True)
    k = (sum(sks[i] for i in idx) + (1 if forge else 0)) % jbn.R
    return msg, bs, BN254Signature(jbn.g1_mul(hash_to_g1(msg), k) if idx else None)


def reference_rlc_verdicts(pks, items):
    dev = JHostDevice(BN254Scheme().constructor, batch_check="rlc", rlc_rng=random.Random(3))
    return dev.fetch(dev.dispatch_multi([(m, pks, bs, sig) for m, bs, sig in items]))


class MsmTap:
    """Wraps an engine's `_rlc_msm_tail` to keep each call's scalars, group
    one-hot, validity and affine outputs."""

    def __init__(self, dev):
        self.calls = []
        inner = dev._rlc_msm_tail

        def tap(agg, sig_x, sig_y, r_bits, group_oh, valid):
            out = inner(agg, sig_x, sig_y, r_bits, group_oh, valid)
            self.calls.append((r_bits, group_oh, valid, out))
            return out

        dev._rlc_msm_tail = tap


def check_msm_outputs(dev, call, sks, items):
    """S and every X_g against the scalar oracle's sums for the launch's own
    scalars (read back from its bit columns)."""
    r_bits, group_oh, valid, (sx, sy, s_inf, xx, xy, x_inf) = call
    F, T = dev.curves.F, dev.curves.T
    bits = r_bits.numpy().astype(object)
    rs = [sum(int(b) << (63 - i) for i, b in enumerate(bits[:, j])) for j in range(C)]
    oh = group_oh.numpy()
    live = [j for j in range(C) if valid[j]]
    S = None
    for j in live:
        t = jbn.g1_mul(items[j][2].point, rs[j])
        S = t if S is None else jbn.g1_add(S, t)
    assert not bool(s_inf[0])
    assert (F.unpack(sx)[0], F.unpack(sy)[0]) == S
    xs, ys = T.f2_unpack(xx), T.f2_unpack(xy)
    for g in range(oh.shape[0]):
        X = None
        for j in live:
            if oh[g, j]:
                apk = sum(sks[i] for i in items[j][1].indices()) % jbn.R
                t = jbn.g2_mul(jbn.G2_GEN, apk * rs[j] % jbn.R)
                X = t if X is None else jbn.g2_add(X, t)
        if X is None:
            assert bool(x_inf[g])
        else:
            assert (xs[g], ys[g]) == X
    return rs


@pytest.mark.parametrize("backend", ["cios", "rns"])
def test_rlc_range_launch_one_message(registry, backend):
    """An honest range launch of C candidates on one message (holes, one
    padded lane): every verdict True, one combined check of M+1 = 2 Miller
    lanes and one final exponentiation, and (S, X) equal to the oracle's."""
    sks, pks = registry
    items = [item(sks, b"m", range(0, 5)), item(sks, b"m", [2, 3, 5, 6, 9]),
             item(sks, b"m", range(7, 12))]
    dev = BN254Device(pks, batch_size=C, device="cpu", fp_backend=backend,
                      batch_check="rlc", rlc_rng=random.Random(11))
    tap = MsmTap(dev)
    got = dev.fetch(dev.dispatch(b"m", [(bs, sig) for _m, bs, sig in items]))
    assert got == [True, True, True] == reference_rlc_verdicts(pks, items)
    st = dev.rlc_stats
    assert (st.rlc_launches, st.bisection_ct, st.bisection_depth_max) == (1, 0, 0)
    assert (st.miller_lanes, st.final_exp_lanes) == (2, 1)
    assert dev.multi_msg_launches == 0
    (call,) = tap.calls
    rs = check_msm_outputs(dev, call, sks, items)
    assert rs[0] == 1 and rs[3] == 0 and not bool(call[2][3])  # r_0 = 1; the pad lane


def test_rlc_dense_launch_mixed_messages(registry):
    """A dense launch whose lanes carry three messages (G = 4, one padded
    group), through dispatch_multi: verdicts, G+1 = 5 Miller lanes (the
    padded group's lane masked out), one multi-message launch, (S, X_g)
    equal to the oracle's per group, infinity for the padded one."""
    sks, pks = registry
    items = [item(sks, b"m1", [0, 4, 8, 11]), item(sks, b"m2", [1, 5, 9]),
             item(sks, b"m3", [0, 3, 7, 10]), item(sks, b"m2", [2, 6, 11])]
    dev = SmallCapDevice(pks, batch_size=C, device="cpu", batch_check="rlc",
                         rlc_rng=random.Random(12))
    assert dev._pack_requests([(bs, sig) for _m, bs, sig in items]).kind == "dense"
    tap = MsmTap(dev)
    got = dev.fetch(dev.dispatch_multi([(m, pks, bs, sig) for m, bs, sig in items]))
    assert got == [True] * 4 == reference_rlc_verdicts(pks, items)
    st = dev.rlc_stats
    assert (st.rlc_launches, st.bisection_ct, st.miller_lanes, st.final_exp_lanes) == (1, 0, 5, 1)
    assert dev.multi_msg_launches == 1
    (call,) = tap.calls
    assert call[1].shape == (4, C)
    check_msm_outputs(dev, call, sks, items)


def test_rlc_handle_without_a_combined_launch(registry):
    """At most one valid candidate: nothing is launched at dispatch; the
    lone candidate resolves through its per-candidate oracle at fetch, an
    invalid lane is False with no device work, an empty launch is []."""
    sks, pks = registry
    dev = BN254Device(pks, batch_size=C, device="cpu", batch_check="rlc")
    empty = BitSet(N)
    handle = dev.dispatch(b"m", [(empty, BN254Signature(jbn.G1_GEN))])
    assert handle[0] == "rlc" and handle[3] is None
    assert dev.fetch(handle) == [False]
    assert dev.host_dispatch_launches == 0
    assert dev.fetch(dev.dispatch_multi([])) == []
    _m, bs, sig = item(sks, b"m", [4, 5])
    assert dev.fetch(dev.dispatch(b"m", [(bs, sig), (empty, sig)])) == [True, False]
    st = dev.rlc_stats
    assert (st.rlc_launches, st.bisection_ct, st.miller_lanes) == (0, 0, 0)
    assert dev.host_dispatch_launches == 1  # the oracle's per-candidate launch


def test_h_cols_match_the_reference_packing(registry):
    _sks, pks = registry
    dev = BN254Device(pks, batch_size=C, device="cpu")
    F = JField(jbn.P)
    for msg in (b"m1", b"another message"):
        h = hash_to_g1(msg)
        hx, hy = dev._h_cols(msg)
        assert hx.shape == (16, 1) and hx.dtype == np.int32
        assert (hx == np.asarray(F.pack_batch_np([h[0]]))).all()
        assert (hy == np.asarray(F.pack_batch_np([h[1]]))).all()
        assert dev._h_cols(msg) is dev._h_cols(msg)  # hashed once
    lx, ly = dev._h_lanes([b"m1", b"m2", b"m1"])
    assert lx.shape == (16, C)
    assert torch.equal(lx[:, 0], lx[:, 2]) and torch.equal(lx[:, 2], lx[:, 3])  # pad repeats
    assert (lx[:, 1].numpy() == dev._h_cols(b"m2")[0][:, 0]).all()


def test_per_candidate_dispatch_multi_matches_per_message_launches(registry):
    """Mixed messages in one per-candidate launch (per-lane H columns)
    give the verdicts of one launch per message; forged lanes included."""
    sks, pks = registry
    items = [item(sks, b"m1", range(0, 4)), item(sks, b"m2", range(3, 8), forge=True),
             item(sks, b"m2", range(5, 9)), item(sks, b"m1", [1, 2, 4], forge=True)]
    dev = BN254Device(pks, batch_size=C, device="cpu")
    got = dev.fetch(dev.dispatch_multi([(m, pks, bs, sig) for m, bs, sig in items]))
    assert dev.multi_msg_launches == 1 and dev.host_dispatch_launches == 1
    per_message = [None] * len(items)
    for msg in (b"m1", b"m2"):
        idx = [j for j, it in enumerate(items) if it[0] == msg]
        for j, v in zip(idx, dev.batch_verify(msg, [items[j][1:] for j in idx])):
            per_message[j] = v
    assert got == per_message == [True, False, True, False]
    # one message: an ordinary dispatch
    dev.dispatch = lambda msg, reqs: ("dispatch", msg, reqs)
    assert dev.dispatch_multi([(b"m1", pks, *items[0][1:])]) == ("dispatch", b"m1", [items[0][1:]])


def test_warmup_runs_the_rlc_class(registry):
    """warmup's launches, as the reference's for one plan class: the
    per-candidate range launch, in RLC mode one two-candidate launch (whose
    combined check fails on the warmup signature and bisects), then the
    combine classes 2, 4 and 8, and never a dispatch_multi; the counters
    are zeroed at the end. The launches are recorded, not run."""
    _sks, pks = registry
    for mode, want in (("per_candidate", 4), ("rlc", 5)):
        dev = BN254Device(pks, batch_size=C, device="cpu", batch_check=mode)
        calls = []
        dev.dispatch = lambda msg, reqs: calls.append(("dispatch", msg, len(reqs))) or "h"
        dev.dispatch_multi = lambda items: calls.append(
            ("dispatch_multi", tuple(it[0] for it in items))) or "h"
        dev.fetch = lambda h: []
        dev.combine_batch = lambda groups: calls.append(("combine", len(groups[0])))
        dev.rlc_stats.rlc_launches = 3
        assert dev.warmup() == want
        assert dev.rlc_stats.rlc_launches == 0
        expect = [("dispatch", b"bn254-device-warmup", 1)]
        if mode == "rlc":
            expect.append(("dispatch", b"bn254-device-warmup", 2))
        assert calls == expect + [("combine", k) for k in (2, 4, 8)]


def test_rlc_check_folds_nine_lanes_with_padded_groups(registry):
    """The (G+1)-lane pairing tail at G = 8 with five groups occupied (the
    launch's padded groups repeat the last H column and carry X at
    infinity): e(H_g, X_g) for g < 5 against e(-S, B2) is 1 exactly when
    S = sum h_g x_g G1; pairing_check(..., groups=1) folds the nine lanes."""
    _sks, pks = registry
    dev = BN254Device(pks, batch_size=C, device="cpu")
    F, T = dev.curves.F, dev.curves.T
    rng = random.Random(9)
    hs = [rng.randrange(1, jbn.R) for _ in range(5)]
    xs = [rng.randrange(1, jbn.R) for _ in range(5)]
    H = [jbn.g1_mul(jbn.G1_GEN, h) for h in hs] + [jbn.g1_mul(jbn.G1_GEN, hs[-1])] * 3
    X = [jbn.g2_mul(jbn.G2_GEN, x) for x in xs]
    zero2 = (0, 0)
    xx = T.f2_pack([p[0] for p in X] + [zero2] * 3)
    xy = T.f2_pack([p[1] for p in X] + [zero2] * 3)
    x_inf = torch.arange(8) >= 5
    g_occ = torch.arange(8) < 5
    hx, hy = F.pack([p[0] for p in H]), F.pack([p[1] for p in H])
    s_inf = torch.zeros(1, dtype=torch.bool)
    want = sum(h * x for h, x in zip(hs, xs)) % jbn.R
    for k, ok in ((want, True), (want + 1, False)):
        S = jbn.g1_mul(jbn.G1_GEN, k)
        got = dev._rlc_check(F.pack([S[0]]), F.pack([S[1]]), s_inf, xx, xy, x_inf, hx, hy, g_occ)
        assert got.tolist() == [ok]
