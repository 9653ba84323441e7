"""The port's mesh sharding (handel_tpu_torch/parallel/sharding.py) against
the JAX package's (handel_tpu/parallel/sharding.py), as tests/test_sharding.py
holds the reference.

The JAX side runs on conftest's 8 virtual CPU devices; the port's mesh is K
shards of the CPU (`make_mesh(K, devices=["cpu"] * K)`). The same keys
(seeded, from the reference's native keygen) and the same seeded numpy masks
go through both `sharded_masked_sum_g2`s, and the projective limbs must be
equal: the port keeps the reference's per-shard masked tree-sums, its
lo/hi combine tree and its edge padding. The inputs repeat
tests/test_sharding.py's, so the JAX executables are the ones that file
compiles. The sharded pairing check and the wired engine are in
tests/test_torch_mesh_device.py.
"""

import functools
import random

import numpy as np
import pytest
import torch

from handel_tpu_torch.ops.curve import BN254Curves as PCurves
from handel_tpu_torch.parallel import sharding as psh

N_DEV = 8


@functools.lru_cache(maxsize=None)
def keys(n, seed):
    from handel_tpu import native as nat
    from handel_tpu.ops import bn254_ref as bn

    rng = random.Random(seed)
    sks = [rng.randrange(1, 1 << 30) for _ in range(n)]
    return tuple(nat.g2_mul_batch([bn.G2_GEN] * n, sks))


@functools.lru_cache(maxsize=None)
def jax_registry(n, seed):
    from handel_tpu.ops.curve import BN254Curves

    T = BN254Curves().T
    pks = keys(n, seed)
    return T.f2_pack([p[0] for p in pks]), T.f2_pack([p[1] for p in pks])


def port_registry(n, seed):
    """The JAX package's limbs, as the port's int32 tensors."""
    rx, ry = jax_registry(n, seed)
    t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int32))  # noqa: E731
    return (t(rx[0]), t(rx[1])), (t(ry[0]), t(ry[1]))


def leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in leaves(t)]
    return [np.asarray(tree).astype(np.int64)]


def assert_same_limbs(port_pt, jax_pt):
    got, want = leaves(port_pt), leaves(jax_pt)
    assert len(got) == len(want) == 6  # (X, Y, Z), each an Fp2 pair
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@functools.lru_cache(maxsize=None)
def jax_masked_sum(k, n, batch, key_seed, mask_seed, empty_col):
    """The JAX package's sharded masked sum on a k-device mesh: (mask,
    projective limbs as numpy)."""
    import jax.numpy as jnp

    from handel_tpu.ops.curve import BN254Curves
    from handel_tpu.parallel.sharding import make_mesh, sharded_masked_sum_g2

    rx, ry = jax_registry(n, key_seed)
    mask = np.random.default_rng(mask_seed).random((n, batch)) < 0.5
    if empty_col is not None:
        mask[:, empty_col] = False
    fn = sharded_masked_sum_g2(BN254Curves(), make_mesh(k), n, batch)
    agg = fn(rx[0], rx[1], ry[0], ry[1], jnp.asarray(mask))
    return mask, [np.asarray(a) for a in leaves(agg)]


def port_mesh(k):
    return psh.make_mesh(k, devices=["cpu"] * k)


def whole(sharded):
    """A `Sharded` operand put back together."""
    if sharded.dim is None:
        return sharded[0]
    return torch.cat(list(sharded), dim=sharded.dim)


# -- the mesh ------------------------------------------------------------------


def test_mesh_requires_enough_devices():
    """Both packages refuse a mesh wider than what is there, naming the
    count; the port never falls back to the CPU or to fewer shards."""
    import jax

    from handel_tpu.parallel.sharding import make_mesh

    with pytest.raises(ValueError, match="devices"):
        make_mesh(len(jax.devices()) + 1)
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=rf"mesh of {visible + 1} devices requested but only "
                                         rf"{visible} visible"):
        psh.make_mesh(visible + 1)
    with pytest.raises(ValueError, match="only 2 devices listed"):
        psh.make_mesh(3, devices=["cpu", "cpu"])
    mesh = port_mesh(3)
    assert mesh.shape == {"dp": 3} and mesh.devices == (torch.device("cpu"),) * 3
    assert mesh.streams == (None, None, None)


def test_mesh_engine_on_the_card_needs_its_cards():
    """`bn254_mesh_engine(pks, K)` without an explicit mesh puts its shards
    on cards 0..K-1: with fewer visible it raises, naming the count, and
    never builds a CPU mesh in their place."""
    from handel_tpu_torch.parallel.mesh_plane import bn254_mesh_engine

    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=rf"only {visible} visible"):
        bn254_mesh_engine([], visible + 1)


# -- partition rules ---------------------------------------------------------------


NAMES = ["reg_x", "reg_y", "reg_x0", "prefix", "res_x", "resident_y", "mask", "sig_x",
         "sig_y", "valid", "lo", "hi", "miss_idx", "miss_ok", "r_bits", "group_oh",
         "g_occ", "h_x"]


def test_launch_partition_rules_match_the_reference_table():
    """The same spec per operand name as the reference's table, first match
    winning, RLC operands replicated; a table without the catch-all refuses
    an unknown operand in both."""
    from jax.sharding import PartitionSpec as JP

    from handel_tpu.parallel import sharding as rsh

    ours = psh.match_partition_rules(psh.launch_partition_rules(), NAMES)
    theirs = rsh.match_partition_rules(rsh.launch_partition_rules(), NAMES)
    assert {k: tuple(v) for k, v in ours.items()} == {k: tuple(v) for k, v in theirs.items()}
    assert ours["reg_x"] == psh.P(None, "dp") and ours["mask"] == psh.P("dp", None)
    assert ours["r_bits"] == psh.P() == ours["sig_x"]
    for mod, spec in ((psh, psh.P(None, "dp")), (rsh, JP(None, "dp"))):
        with pytest.raises(ValueError, match="no partition rule"):
            mod.match_partition_rules(((r"^reg", spec),), ["mask"])


def test_make_shard_fns_place_by_rule():
    """Rule-matched placement: the registry split over its point axis, the
    mask over its rows (zero-padded to the shard multiple), replicated
    operands whole on every shard."""
    mesh = port_mesh(N_DEV)
    put = psh.make_shard_fns(
        mesh, psh.match_partition_rules(psh.launch_partition_rules(), ["reg_x", "mask", "sig_x"])
    )
    reg = put["reg_x"](np.arange(64, dtype=np.int32).reshape(4, 16))
    assert reg.dim == 1 and [tuple(s.shape) for s in reg] == [(4, 2)] * N_DEV
    np.testing.assert_array_equal(whole(reg).numpy(), np.arange(64).reshape(4, 16))
    mask = put["mask"](np.ones((13, 4), bool))  # 13 rows pad to 16
    assert mask.dim == 0 and [tuple(s.shape) for s in mask] == [(2, 4)] * N_DEV
    assert whole(mask).sum().item() == 13 * 4 and not mask[-1][1:].any()
    sig = put["sig_x"](np.zeros((4, 4), np.int32))
    assert sig.dim is None and all(tuple(s.shape) == (4, 4) for s in sig)


def test_commit_registry_sharded_pads_edge_limb_for_limb():
    """5 keys over 8 shards: both packages' commits hold the same limbs,
    the 3 padded columns replicating the last key, one column a shard."""
    from handel_tpu.parallel.sharding import commit_registry_sharded, make_mesh

    n = 5
    rx, ry = jax_registry(n, 17)
    theirs = commit_registry_sharded(make_mesh(N_DEV), rx, ry, n)
    prx, pry = port_registry(n, 17)
    ours = psh.commit_registry_sharded(port_mesh(N_DEV), prx, pry, n)
    for got, want in zip(leaves([whole(s) for pair in ours for s in pair]), leaves(theirs)):
        assert got.shape == (16, N_DEV)
        np.testing.assert_array_equal(got, want)
        for col in range(n, N_DEV):
            np.testing.assert_array_equal(got[:, col], got[:, n - 1])
    assert all(tuple(s.shape) == (16, 1) for pair in ours for sh in pair for s in sh)


# -- the sharded masked sum -----------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_sharded_masked_sum_limbs_equal_the_jax_function(k):
    """k in {1, 2, 3, 8} over 11 keys (11 divides by none of 2, 3, 8; at 8
    the last two shards are pure padding), one all-empty candidate: the
    port's projective limbs are the JAX function's, and the empty candidate
    is the point at infinity."""
    n, batch = 11, 4
    mask, want = jax_masked_sum(k, n, batch, 31, 5, 2)
    prx, pry = port_registry(n, 31)
    curves = PCurves(device="cpu")
    fn = psh.sharded_masked_sum_g2(curves, port_mesh(k), n, batch)
    got = fn(prx[0], prx[1], pry[0], pry[1], torch.from_numpy(mask))
    assert_same_limbs(got, want)
    assert curves.g2.is_infinity(got).tolist() == [False, False, True, False]


def test_sharded_masked_sum_tiny_registry_empty_shards():
    """5 keys over 8 shards (shards 5..7 pure padding) and 2 candidates:
    the limbs are the JAX function's."""
    n, batch = 5, 2
    mask = np.zeros((n, batch), bool)
    mask[:3, 0] = True  # candidate 0: keys {0, 1, 2}
    mask[4, 1] = True  # candidate 1: a single key
    import jax.numpy as jnp

    from handel_tpu.ops.curve import BN254Curves
    from handel_tpu.parallel.sharding import make_mesh, sharded_masked_sum_g2

    rx, ry = jax_registry(n, 13)
    want = sharded_masked_sum_g2(BN254Curves(), make_mesh(N_DEV), n, batch)(
        rx[0], rx[1], ry[0], ry[1], jnp.asarray(mask))
    prx, pry = port_registry(n, 13)
    fn = psh.sharded_masked_sum_g2(PCurves(device="cpu"), port_mesh(N_DEV), n, batch)
    assert_same_limbs(fn(prx[0], prx[1], pry[0], pry[1], torch.from_numpy(mask)), want)


@pytest.mark.parametrize("k", [3, 8])
def test_preplaced_padded_mask_and_committed_registry_keep_their_shards(k):
    """The engine's dense staging: a mask pre-padded to the shard multiple
    and placed by partition rule, over the committed registry shards, gives
    the limbs of the JAX function's unpadded call."""
    n, batch = 11, 4
    mask, want = jax_masked_sum(k, n, batch, 31, 5, 2)
    mesh = port_mesh(k)
    pad = (-n) % k
    prx, pry = port_registry(n, 31)
    (rx0, rx1), (ry0, ry1) = psh.commit_registry_sharded(mesh, prx, pry, n)
    put = psh.make_shard_fns(mesh, psh.match_partition_rules(psh.launch_partition_rules(),
                                                             ["mask"]))
    placed = put["mask"](np.pad(mask, ((0, pad), (0, 0))))
    assert [tuple(s.shape) for s in placed] == [((n + pad) // k, batch)] * k
    fn = psh.sharded_masked_sum_g2(PCurves(device="cpu"), mesh, n, batch)
    assert_same_limbs(fn(rx0, rx1, ry0, ry1, placed), want)
