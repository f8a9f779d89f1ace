"""The near-first walk's tables and its plain version on the CPU: the
child-pair table (`rfx_torch.ops.bvh_pack`) record by record against the
preorder table, its bytes in the `bvh_table_bytes` gauge, the tree's depth
against the stack's capacity, and `bvh_traverse.near_first_closest_hit`
(the kernel's near-first walk in plain PyTorch) against the stackless walk
and brute force, ties at equal t included. The CUDA walk itself is held
against these in tests/test_torch_kernels.py."""

import numpy as np
import pytest
import torch

from rfx_torch import bvh as tbvh
from rfx_torch.bvh import FlatBVH, build_bvh, collapse_bvh
from rfx_torch.geometry import TriangleMesh, make_terrain
from rfx_torch.ops import bvh_pack, bvh_traverse, native_lib
from rfx_torch.ops.bvh_pack import COUNT_BITS, STACK_CAPACITY, pack_bvh
from rfx_torch.ops.bvh_trace import padded_closest_hit
from rfx_torch.sampler import sphere_directions
from rfx_torch.utils import profiling

torch.set_num_threads(1)

CPU = torch.device("cpu")


def tree_bvh(tris, tree, leaf_size) -> FlatBVH:
    """A FlatBVH of the triangles `tris` ((T, 3, 3) f32) shaped as `tree`: a
    leaf is a list of triangle indices, an internal node a (left, right)
    tuple; each box the bounds of its triangles, each leaf padded to
    `leaf_size` with degenerate rows (face -1)."""
    tris = np.asarray(tris, np.float32)
    cols = {k: [] for k in ("mn", "mx", "start", "count", "skip")}
    rows = {k: [] for k in ("v0", "e1", "e2", "face")}

    def rec(node):
        i = len(cols["mn"])
        for c in cols.values():
            c.append(0)
        if isinstance(node, list):
            cols["start"][i], cols["count"][i] = len(rows["face"]), len(node)
            for j in node + [-1] * (-len(node) % leaf_size):
                t = tris[j] if j >= 0 else np.zeros((3, 3), np.float32)
                rows["v0"].append(t[0])
                rows["e1"].append(t[1] - t[0])
                rows["e2"].append(t[2] - t[0])
                rows["face"].append(j)
            pts = tris[node].reshape(-1, 3)
        else:
            pts = np.concatenate([rec(child) for child in node])
        cols["mn"][i], cols["mx"][i] = pts.min(0), pts.max(0)
        cols["skip"][i] = len(cols["mn"])
        return pts

    rec(tree)
    f32 = lambda k, src: np.asarray(src[k], np.float32).reshape(-1, 3)  # noqa: E731
    return FlatBVH(aabb_min=f32("mn", cols), aabb_max=f32("mx", cols),
                   tri_start=np.asarray(cols["start"], np.int32),
                   tri_count=np.asarray(cols["count"], np.int32),
                   skip=np.asarray(cols["skip"], np.int32), tri_v0=f32("v0", rows),
                   tri_e1=f32("e1", rows), tri_e2=f32("e2", rows),
                   tri_face=np.asarray(rows["face"], np.int32), leaf_size=leaf_size)


def chain_bvh(levels: int) -> FlatBVH:
    """A degenerate chain of `levels` levels: internal node k holds leaf k
    on its left and the rest of the chain on its right; leaf k is one
    triangle in the plane x = k, facing the x axis."""
    tris = [[[k, -1.0, -1.0], [k, 2.0, -1.0], [k, -1.0, 2.0]] for k in range(levels)]
    tree = [levels - 1]
    for k in range(levels - 2, -1, -1):
        tree = ([k], tree)
    return tree_bvh(tris, tree, leaf_size=1)


def tie_bvh() -> FlatBVH:
    """Triangle 0 on the left, its duplicate 1 on the right beside
    triangle 2, which lies off the z axis near z = 9: a ray down the z axis
    from z = 10 enters the right box (z up to 9) before the left one (z = 0)
    and meets the duplicate first, at the t of triangle 0."""
    a = [[-1.0, -1.0, 0.0], [2.0, -1.0, 0.0], [-1.0, 2.0, 0.0]]
    c = [[3.0, 3.0, 9.0], [4.0, 3.0, 9.0], [3.0, 4.0, 9.0]]
    return tree_bvh([a, a, c], ([0], [1, 2]), leaf_size=2)


def _terrain_bvh(method, grid=20, leaf_size=8, seed=4):
    return build_bvh(make_terrain(grid=grid, extent=30.0, seed=seed), leaf_size=leaf_size,
                     method=method)


def _need_native(method):
    if method == "native" and not native_lib.native_available():
        pytest.skip(f"no native builder here: {native_lib.unavailable_reason()}")


@pytest.mark.parametrize("method, leaf_size", [("numpy", 8), ("numpy", 16), ("native", 8)])
def test_child_pair_table_holds_both_children_of_every_internal_node(method, leaf_size):
    """Record k is the k-th internal node in preorder, the root first: its
    left child (node i+1) and its right child (node skip[i+1]) with the
    preorder table's boxes bit for bit, a leaf child's ref its preorder
    `leaf` lane, an internal child's ref its record << COUNT_BITS, and the
    lanes after each hi box 0."""
    _need_native(method)
    flat = _terrain_bvh(method, leaf_size=leaf_size)
    p = pack_bvh(flat, CPU)
    nodes = p.nodes.numpy()
    nbits = nodes.view(np.int32)
    pairs = p.pairs.numpy()
    pbits = pairs.view(np.int32)
    internal = np.flatnonzero(flat.tri_count == 0)
    assert internal[0] == 0 and pairs.shape == (internal.size, 16) and p.pairs.is_contiguous()
    assert internal.size == int((flat.tri_count > 0).sum()) - 1  # a binary tree
    record = {int(i): k for k, i in enumerate(internal)}
    for k, i in enumerate(internal):
        left = i + 1
        right = int(flat.skip[left])
        assert flat.skip[right] == flat.skip[i]  # the last child
        for half, child in ((0, left), (8, right)):
            np.testing.assert_array_equal(pairs[k, half:half + 3], nodes[child, 0:3])
            np.testing.assert_array_equal(pairs[k, half + 4:half + 7], nodes[child, 4:7])
            assert pbits[k, half + 7] == 0
            if flat.tri_count[child] > 0:
                assert pbits[k, half + 3] == nbits[child, 7] != 0
                assert pbits[k, half + 3] >> COUNT_BITS == flat.tri_start[child]
                assert pbits[k, half + 3] & bvh_pack.MAX_LEAF_TRIS == flat.tri_count[child]
            else:
                assert pbits[k, half + 3] == record[child] << COUNT_BITS


def test_a_tree_that_is_not_binary_or_one_leaf_has_no_child_pair_table():
    flat = _terrain_bvh("numpy")
    wide = pack_bvh(collapse_bvh(flat, 4), CPU)
    leaf = pack_bvh(tree_bvh([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], [0], leaf_size=1), CPU)
    for p in (wide, leaf):
        assert p.pairs is None and not p.near_first
    assert leaf.max_depth == 1


def test_the_table_bytes_gauge_counts_the_child_pair_table(monkeypatch):
    """`bvh_table_bytes` adds the child-pair table's 64 bytes a record to the
    preorder nodes, triangles and face ids; the pair table is about the
    preorder table's size (n - 1 records of 64 bytes against 2n - 1 nodes of
    32)."""
    monkeypatch.setattr(profiling, "_GAUGES", {})
    flat = _terrain_bvh("numpy")
    p = pack_bvh(flat, CPU)
    assert p.pairs.nbytes == 64 * int((flat.tri_count == 0).sum())
    assert profiling.counters()["bvh_table_bytes"] == (
        p.nodes.nbytes + p.pairs.nbytes + p.tri.nbytes + p.tri_face.nbytes)
    assert p.nodes.nbytes - 32 == p.pairs.nbytes
    assert bvh_pack.table_bytes(p) == profiling.counters()["bvh_table_bytes"]


@pytest.mark.parametrize("builder", ["bench_terrain_numpy", "large_terrain_native"])
def test_the_stack_holds_the_cells_trees(builder):
    """The two CIR scenes' builders at a small grid (the bench terrain's numpy
    SAH build, the large terrain's native one): the packed depth is
    `FlatBVH.max_depth`, the tree is binary and the stack holds it."""
    method = "native" if builder.endswith("native") else "numpy"
    _need_native(method)
    extent = 60.0 if method == "numpy" else 120.0
    flat = build_bvh(make_terrain(grid=64, extent=extent, seed=0), leaf_size=8, method=method)
    p = pack_bvh(flat, CPU)
    assert p.max_depth == flat.max_depth() > 1
    assert p.max_depth - 1 <= STACK_CAPACITY
    assert p.pairs is not None and p.near_first


@pytest.mark.parametrize("levels, near_first", [(STACK_CAPACITY + 1, True),
                                                (STACK_CAPACITY + 2, False)])
def test_a_tree_deeper_than_the_stack_is_walked_in_preorder(levels, near_first):
    """A chain of STACK_CAPACITY + 1 levels needs the whole stack and takes
    the near-first walk; one level more, and it takes the preorder walk."""
    flat = chain_bvh(levels)
    p = pack_bvh(flat, CPU)
    assert p.max_depth == flat.max_depth() == levels
    assert p.pairs is not None and p.near_first is near_first


@pytest.mark.parametrize("arity", [2, 4])
def test_max_depth_reads_the_depth_of_any_arity(arity):
    """`FlatBVH.max_depth` (a running sum over the skip pointers) against a
    walk down `children`, on a binary tree, a 4-ary one and a chain."""
    def walked(flat, i=0):
        kids = flat.children(i) if flat.tri_count[i] == 0 else []
        return 1 + max((walked(flat, c) for c in kids), default=0)

    for flat in (collapse_bvh(_terrain_bvh("numpy", grid=24), arity), chain_bvh(12)):
        assert flat.max_depth() == walked(flat)


def _rays(n, seed, origin):
    d = sphere_directions(n, generator=torch.Generator().manual_seed(seed), device="cpu")
    return torch.tensor([origin], dtype=torch.float32).expand(n, 3).contiguous(), d


@pytest.mark.parametrize("method, grid", [("numpy", 16), ("numpy", 40), ("native", 40)])
def test_near_first_walk_finds_the_closest_hits_of_the_stackless_walk(method, grid):
    """From a transmitter above the terrain, from points below it looking up
    (second-bounce-like queries), and from a ray parked far away: t bit for
    bit, and the padded index, equal to the stackless walk's and to brute
    force's on every hit."""
    _need_native(method)
    p = pack_bvh(_terrain_bvh(method, grid=grid, seed=0), CPU)
    o, d = _rays(4096, grid, [2.0, 1.0, 12.0])
    sets = {"tx": (o, d), "back": (o + 6.0 * d, -d),
            "parked": (torch.full((3, 3), 1e9), torch.tensor([[0.0, 0.0, 1.0]] * 3))}
    for name, (oo, dd) in sets.items():
        t, idx = bvh_traverse.near_first_closest_hit(p, oo, dd)
        wt, widx = bvh_traverse.walk_closest_hit(p, oo, dd)
        bt, bidx = padded_closest_hit(oo, dd, p.tri)
        hit = idx >= 0
        assert torch.equal(t, wt) and torch.equal(idx, widx), name
        assert torch.equal(t, bt) and torch.equal(idx[hit], bidx[hit]), name
        if name != "parked":
            assert int(hit.sum()) > 100, name


def test_near_first_walk_fills_the_whole_stack():
    """Rays down the chain from its far end enter the rest of the chain
    before each leaf, so they push a leaf at every level: a full stack, and
    the nearest triangle's hit."""
    levels = STACK_CAPACITY + 1
    p = pack_bvh(chain_bvh(levels), CPU)
    n = 64
    o = torch.tensor([[levels + 1.0, 0.2, 0.3]]).expand(n, 3).contiguous()
    d = torch.nn.functional.normalize(
        torch.tensor([[-1.0, 0.0, 0.0]]) + 0.05 * torch.rand(n, 3, generator=torch.Generator()
                                                              .manual_seed(1)), dim=1)
    t, idx = bvh_traverse.near_first_closest_hit(p, o, d)
    bt, bidx = padded_closest_hit(o, d, p.tri)
    assert torch.equal(t, bt) and torch.equal(idx, bidx)
    assert bool((p.tri_face[idx] == levels - 1).all())


def test_near_first_walk_breaks_ties_at_equal_t_by_the_lower_index():
    """The near-first walk meets triangle 0's duplicate first (the right box
    is entered first), then triangle 0 at the same t: the lower padded index
    wins, as in brute force and the stackless walk. For about a quarter of
    these tilted rays the left box's f32 slab entry rounds above the hit's
    t, so only the walk's widened cut keeps the box. On a terrain whose every
    face is listed twice, every hit is the lower index of its pair too."""
    p = pack_bvh(tie_bvh(), CPU)
    n = 4096
    gen = torch.Generator().manual_seed(5)
    d = torch.nn.functional.normalize(
        torch.tensor([[0.0, 0.0, -1.0]]) + 0.02 * torch.randn(n, 3, generator=gen), dim=1)
    o = torch.tensor([[0.1, 0.2, 10.0]]).expand(n, 3).contiguous()
    t, idx = bvh_traverse.near_first_closest_hit(p, o, d)
    hit = idx >= 0
    root = p.pairs[0].expand(n, 16)
    inv_d = bvh_traverse._inv_dir(d)
    near = [bvh_traverse._slab(root[:, h:h + 3], root[:, h + 4:h + 7], o, inv_d,
                               torch.full((n,), 1e30))[0] for h in (0, 8)]
    assert bool((near[1] < near[0]).all())
    assert int((near[0][hit] > t[hit]).sum()) > n // 10
    assert int(hit.sum()) > n // 2 and bool((idx[hit] == 0).all())
    assert torch.equal(p.tri_face[2], torch.tensor(1, dtype=torch.int32))  # the duplicate
    wt, widx = bvh_traverse.walk_closest_hit(p, o, d)
    bt, bidx = padded_closest_hit(o, d, p.tri)
    assert torch.equal(t, wt) and torch.equal(idx, widx)
    assert torch.equal(t, bt) and torch.equal(idx[hit], bidx[hit])

    m = make_terrain(grid=16, extent=30.0, seed=0)
    twice = TriangleMesh(m.vertices, np.concatenate([m.faces, m.faces]))
    p = pack_bvh(tbvh.build_bvh(twice, leaf_size=1, method="numpy"), CPU)
    o, d = _rays(4096, 3, [2.0, 1.0, 12.0])
    t, idx = bvh_traverse.near_first_closest_hit(p, o, d)
    bt, bidx = padded_closest_hit(o, d, p.tri)
    hit = idx >= 0
    assert int(hit.sum()) > 100
    assert torch.equal(t, bt) and torch.equal(idx[hit], bidx[hit])
