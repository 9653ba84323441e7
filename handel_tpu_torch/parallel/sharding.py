"""Mesh sharding for the verification batch plane — counterpart of
handel_tpu/parallel/sharding.py, with the same names.

The scaling axis is the pairing/aggregation batch: candidates shard over the
mesh's axis, the registry shards over the same devices for the masked G2
segment-sum, and the partial sums are gathered onto the first shard's device
and combined by a log-depth point-add tree (point addition is not an
elementwise monoid, so no reduction collective applies).

The mesh is one process. The reference's is too: one `BN254Device` spans K
devices through `shard_map` under one `jit`. Here a `Mesh` is a tuple of
torch devices with one CUDA stream a shard. Each shard's work is issued on
its own stream, and the shards are joined by CUDA events before the gather;
the gather and every other move between devices are explicit copies
(`Mesh.scatter`, `Mesh.gather`), ordered by the streams PyTorch's
cross-device copy synchronizes. The host issues the shards one after
another, so that a shard's kernels run while the host issues the next
shard's. A launch is bound by its host issue, and threads would share one
interpreter lock: on one H100 a two-shard range launch of 8 lanes issued
from a thread a shard took 25.3–28.6 s, in turn 11.5–14.2 s (PERF.md).
A device list may repeat a device: the CPU tests pass `["cpu"] * K`, the
counterpart of the reference's forced host device count, and one card
carries two shards as `[cuda:0] * 2`.

Two entry points:
  * `sharded_masked_sum_g2`: each shard masked-tree-sums its registry block
    for every candidate; the partials are gathered and combined with the
    reference's lo/hi halving, odd tail last, so the projective limbs equal
    the JAX function's.
  * `sharded_pairing_check`: each shard runs the Miller loop and the shared
    final exponentiation for its local candidates (both pairs of a candidate
    on its shard), no transfer but the inputs and the verdicts.

Launch partition rules: `launch_partition_rules` and `match_partition_rules`
map launch-operand names to partition specs by first-matching regex, and
`make_shard_fns` turns the matched specs into per-operand placement
functions, which pad a tensor along its sharded dim and split it into one
tensor a shard, on each shard's device. `BN254Device(mesh_devices=K)` uses
them to place the dense launch's mask shard by shard.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from handel_tpu_torch.ops.curve import _tree_map
from handel_tpu_torch.utils.torchenv import resolve_device

__all__ = [
    "P",
    "Mesh",
    "Sharded",
    "make_mesh",
    "launch_partition_rules",
    "match_partition_rules",
    "make_shard_fns",
    "sharded_masked_sum_g2",
    "commit_registry_sharded",
    "sharded_pairing_check",
]


class P(tuple):
    """A partition spec, spelled as jax.sharding.PartitionSpec: entry d names
    the mesh axis that dim d is split over, or is None; `P()` replicates.
    A tuple, so a spec compares equal to the reference's."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


class Sharded(tuple):
    """One operand laid out over a mesh: entry i is shard i's tensor, on the
    mesh's device i. `dim` is the split dim, None when every shard holds the
    whole operand."""

    def __new__(cls, shards, dim):
        obj = super().__new__(cls, shards)
        obj.dim = dim
        return obj


def _leaves(tree) -> list:
    if isinstance(tree, tuple):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


class Mesh:
    """K shard devices on one named axis, with one CUDA stream a shard.
    `shape[axis]` is K, as on the reference's Mesh."""

    def __init__(self, devices, axis: str = "dp"):
        self.devices = tuple(devices)
        self.axis = axis
        self.size = len(self.devices)
        self.shape = {axis: self.size}
        self.streams = tuple(
            torch.cuda.Stream(d) if d.type == "cuda" else None for d in self.devices
        )

    # -- moves between the caller's stream and the shards' -------------------

    def scatter(self, tree, i: int):
        """A tensor tree from the caller's current stream onto shard i: a
        copy when it lies on another device (made on the source's current
        stream, which PyTorch fences against shard i's stream both ways), a
        contiguous view when it is shard i's device already (`run` makes the
        shard's stream wait for the caller's first). Host tensors are copied
        to the card from pinned memory."""
        dev, stream = self.devices[i], self.streams[i]

        def move(a):
            if a.device == dev:
                a = a.contiguous()
                if stream is not None:
                    a.record_stream(stream)  # read on the shard's stream
                return a
            with torch.cuda.stream(stream):
                if a.device.type == "cpu" and dev.type == "cuda":
                    a = a.contiguous().pin_memory()
                return a.contiguous().to(dev, non_blocking=True)

        return _tree_map(move, tree)

    def run(self, fn, shard_args) -> list:
        """fn(i, *shard_args[i]) for every shard i in turn, with shard i's
        device current and its stream the current stream; the shard's stream
        first waits for the caller's current stream on that device. Returns
        [(out_i, done_i)], `done_i` the CUDA event after shard i's last op
        (None on the CPU)."""
        ready = {}
        for d in self.devices:
            if d.type == "cuda" and d not in ready:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(d))
                ready[d] = ev
        out = []
        for i, (dev, stream) in enumerate(zip(self.devices, self.streams)):
            if stream is None:
                out.append((fn(i, *shard_args[i]), None))
                continue
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                stream.wait_event(ready[dev])
                res = fn(i, *shard_args[i])
                done = torch.cuda.Event()
                done.record(stream)
            out.append((res, done))
        return out

    def gather(self, tree, i: int, done):
        """Shard i's output tree onto the first shard's device, ordered on
        the caller's current stream there: a device-to-device copy from
        shard i's stream, or, on the same device, a wait on `done`."""
        dev0 = self.devices[0]
        if self.devices[i] == dev0:
            if done is not None:
                caller = torch.cuda.current_stream(dev0)
                caller.wait_event(done)
                for a in _leaves(tree):
                    a.record_stream(caller)
            return tree
        with torch.cuda.stream(self.streams[i]):
            return _tree_map(lambda a: a.to(dev0, non_blocking=True), tree)


def make_mesh(n_devices: int | None = None, devices=None, axis: str = "dp") -> Mesh:
    """A mesh of `n_devices` shards: `cuda:0 … cuda:K-1` by default, or the
    first K of `devices` (which may repeat a device, e.g. `["cpu"] * 8` or
    `[cuda:0] * 2`). Raises ValueError naming the count when fewer are
    there; nothing falls back to the CPU or to fewer shards."""
    if devices is None:
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = n_devices or visible
        if n < 1 or n > visible:
            raise ValueError(
                f"mesh of {n_devices or 'all'} devices requested but only "
                f"{visible} visible (platform cuda); pass devices=[...] to "
                f"place the shards explicitly (e.g. ['cpu'] * K)"
            )
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = [resolve_device(d) for d in devices]
        n = n_devices or len(devs)
        if n > len(devs):
            raise ValueError(
                f"mesh of {n} devices requested but only {len(devs)} devices listed"
            )
        devs = devs[:n]
    return Mesh(devs, axis)


def launch_partition_rules(axis: str = "dp"):
    """(regex, spec) rules for one whole-mesh verify launch's operands,
    matched by name, as the reference's table: the mesh-resident banks
    (registry coordinates, prefix table) and resident residue planes
    (`res_*` / `resident_*`) shard their point (last) axis, the per-launch
    candidate mask its registry-major rows; everything per candidate
    (signatures, H(m), validity, range bounds) stays replicated —
    `sharded_pairing_check` re-shards candidates itself. The RLC launch
    class's per-candidate operands `r_bits`, `group_oh` and `g_occ` are
    named replicated so the mask rule never captures them."""
    return (
        (r"^(reg|prefix)", P(None, axis)),
        (r"^res(ident)?_", P(None, axis)),
        (r"^mask$", P(axis, None)),
        (r"^(r_bits|group_oh|g_occ)$", P()),
        (r"", P()),
    )


def match_partition_rules(rules, names) -> dict:
    """{name: spec} by the FIRST matching rule (searched, not fullmatched);
    a catch-all `(r"", P())` terminal makes a table total."""
    out = {}
    for name in names:
        for pat, spec in rules:
            if re.search(pat, name):
                out[name] = spec
                break
        else:
            raise ValueError(f"no partition rule matches operand {name!r}")
    return out


def _split_dim(spec, axis: str):
    dims = [d for d, part in enumerate(spec) if part == axis]
    return dims[0] if dims else None


def _place(mesh: Mesh, a, spec) -> Sharded:
    t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
    d = _split_dim(spec, mesh.axis)
    k = mesh.size
    if d is None:
        return Sharded([mesh.scatter(t, i) for i in range(k)], None)
    pad = (-t.shape[d]) % k
    if pad:  # zero rows: a padded mask row selects nothing
        shape = list(t.shape)
        shape[d] = pad
        t = torch.cat([t, torch.zeros(shape, dtype=t.dtype, device=t.device)], dim=d)
    local = t.shape[d] // k
    return Sharded(
        [mesh.scatter(t.narrow(d, i * local, local), i) for i in range(k)], d
    )


def make_shard_fns(mesh: Mesh, specs: dict) -> dict:
    """{name: placement fn} from matched specs: each fn takes a host array
    or tensor and returns its `Sharded` layout on the mesh — split along
    the spec's axis dim (zero-padded up to the device multiple), or one
    whole copy a shard."""
    return {
        name: (lambda a, _spec=spec: _place(mesh, a, _spec))
        for name, spec in specs.items()
    }


def _curves_on(curves, device):
    """A curves object of `curves`' family and field backend on `device`:
    one a shard, so that each shard's field caches its device constants on
    its own stream."""
    return type(curves)(device=device, backend=curves.F.backend)


def _cat_trees(trees):
    """Point trees of batch b each -> one tree of batch len(trees)*b."""
    if isinstance(trees[0], tuple):
        return tuple(_cat_trees([t[j] for t in trees]) for j in range(len(trees[0])))
    return torch.cat(trees, dim=1)


def _split_tree(tree, k: int):
    """Inverse of `_cat_trees`: a tree of batch k*b -> k trees of batch b."""
    if isinstance(tree, tuple):
        parts = [_split_tree(t, k) for t in tree]
        return [tuple(p[j] for p in parts) for j in range(k)]
    return list(tree.chunk(k, dim=1))


def _combine_tree(g2, pts: list):
    """The reference's log-depth point-add tree over the gathered partials:
    lo/hi halves, the odd tail carried to the next level. Each level is one
    stacked add over the halves' lanes (the reference vmaps the add over
    the leading device axis; the add is lane-wise, so the limbs are the
    same)."""
    k = len(pts)
    while k > 1:
        half = k // 2
        s = _split_tree(
            g2.add(_cat_trees(pts[:half]), _cat_trees(pts[half : 2 * half])), half
        )
        if k % 2:
            s = s + pts[2 * half : k]
            k = half + 1
        else:
            k = half
        pts = s
    return pts[0]


def _edge_pad(a: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad the last axis with `pad` copies of its last column."""
    return torch.cat([a, a[:, -1:].expand(a.shape[0], pad)], dim=1) if pad else a


def sharded_masked_sum_g2(curves, mesh: Mesh, n_registry: int, batch: int, axis: str = "dp"):
    """Masked G2 aggregation sharded over the registry axis.

    Returns fn(reg_x0, reg_x1, reg_y0, reg_y1, mask) -> projective G2 batch
    on the mesh's first device. reg_* are (L, N) limb tensors (or their
    `commit_registry_sharded` shards), mask is (N, batch) bool (or its
    `make_shard_fns` shards). Each shard owns N/K registry points and
    computes its partial masked tree-sum for all `batch` candidates; the
    partials are gathered and combined with ceil(log2 K) further point-add
    stages. A registry that K does not divide is padded to the next
    multiple with edge-replicated points masked out of every sum; padded
    inputs (width N + pad) keep their layout. `curves` must be on the
    mesh's first device, where the combine runs."""
    ndev = mesh.shape[axis]
    if curves.device != mesh.devices[0]:
        raise ValueError(
            f"curves on {curves.device}, the mesh's first shard on {mesh.devices[0]}"
        )
    pad_n = (-n_registry) % ndev
    local_n = (n_registry + pad_n) // ndev
    shard_curves = [_curves_on(curves, d) for d in mesh.devices]

    def block(i, rx0, rx1, ry0, ry1, m):
        g2 = shard_curves[i].g2
        tile = lambda a: a.repeat_interleave(batch, dim=1)  # noqa: E731
        Ppt = g2.from_affine((tile(rx0), tile(rx1)), (tile(ry0), tile(ry1)))
        return g2.masked_sum(Ppt, m.reshape(-1), local_n)

    def shards_of(a, fill_edge: bool):
        if isinstance(a, Sharded):
            return a
        if fill_edge:  # registry (L, N): edge-replicated points
            if a.shape[1] == n_registry:
                a = _edge_pad(a, pad_n)
            return _place(mesh, a, P(None, axis))
        return _place(mesh, a, P(axis, None))  # mask (N, batch): False rows

    def fn(reg_x0, reg_x1, reg_y0, reg_y1, mask):
        regs = [shards_of(a, True) for a in (reg_x0, reg_x1, reg_y0, reg_y1)]
        m = shards_of(mask, False)
        outs = mesh.run(block, [tuple(r[i] for r in regs) + (m[i],) for i in range(ndev)])
        parts = [mesh.gather(out, i, done) for i, (out, done) in enumerate(outs)]
        return _combine_tree(curves.g2, parts)

    return fn


def commit_registry_sharded(mesh: Mesh, reg_x, reg_y, n_registry: int, axis: str = "dp"):
    """Commit a registry's (L, N) G2 coordinates to the mesh once, one shard
    a device: padded to the device multiple with edge-replicated points (the
    padded columns are masked out of every sum), split along the point
    axis. Returns ((x0, x1), (y0, y1)) `Sharded` operands. The copies are
    complete when this returns (it synchronizes the mesh's cards): a commit
    happens at construction and at an epoch flip, with no launch in
    flight."""
    ndev = mesh.shape[axis]
    pad_n = (-n_registry) % ndev

    def put(a):
        return _place(mesh, _edge_pad(a, pad_n), P(None, axis))

    out = ((put(reg_x[0]), put(reg_x[1])), (put(reg_y[0]), put(reg_y[1])))
    for d in set(mesh.devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    return out


def sharded_pairing_check(pairing, mesh: Mesh, groups: int, pairs: int = 2, axis: str = "dp"):
    """Product-of-pairings verdicts with candidates sharded over the mesh.

    Returns fn(ps, qs, mask) -> (groups,) bool on the first device, where
      ps = tuple of `pairs` G1 points, each (x, y) with (L, groups) leaves,
      qs = tuple of `pairs` G2 points, each ((x0, x1), (y0, y1)),
      mask = (groups,) per-candidate validity.
    Pair i of candidate j is ps[i]/qs[i] lane j, so a candidate's whole
    product lives on one shard; a shard runs `pairing_check` at
    groups/K lanes a pair, on a pairing of its own on its device. Candidate
    counts that K does not divide are padded with edge lanes masked
    invalid, and the mask is folded into the verdict (`ok & mask`)."""
    ndev = mesh.shape[axis]
    pad_g = (-groups) % ndev
    local = (groups + pad_g) // ndev
    shard_pairings = [
        type(pairing)(_curves_on(pairing.curves, d), resident=pairing.resident)
        for d in mesh.devices
    ]

    def body(i, ps, qs, mask):
        # the local chunk-major lane layout: lane i*local + j holds pair i
        # of local candidate j
        cat = lambda xs: torch.cat(xs, dim=1)  # noqa: E731
        px, py = cat([p[0] for p in ps]), cat([p[1] for p in ps])
        qx = (cat([q[0][0] for q in qs]), cat([q[0][1] for q in qs]))
        qy = (cat([q[1][0] for q in qs]), cat([q[1][1] for q in qs]))
        lane_mask = torch.cat([mask] * len(ps))
        ok = shard_pairings[i].pairing_check((px, py), (qx, qy), lane_mask, local)
        # a fully masked candidate products to 1 (vacuously True): fold
        # validity in so that mask False means verdict False
        return ok & mask

    def fn(ps, qs, mask):
        mask = torch.as_tensor(mask)
        if pad_g:
            ps = _tree_map(lambda a: _edge_pad(a, pad_g), ps)
            qs = _tree_map(lambda a: _edge_pad(a, pad_g), qs)
            mask = torch.cat([mask, torch.zeros(pad_g, dtype=torch.bool, device=mask.device)])
        take = lambda i: (lambda a: a[..., i * local : (i + 1) * local])  # noqa: E731
        args = [
            mesh.scatter((_tree_map(take(i), ps), _tree_map(take(i), qs), take(i)(mask)), i)
            for i in range(ndev)
        ]
        outs = mesh.run(body, args)
        out = torch.cat([mesh.gather(o, i, done) for i, (o, done) in enumerate(outs)])
        return out[:groups]

    return fn
