"""BVH construction (host side) -> flat skip-pointer arrays for the device.

The port's own copy of rfx/bvh.py (numpy only; the port imports nothing of
the JAX package), held against the original field for field by
tests/test_torch_host_copies.py. It replaces the BVH that warp builds inside
`wp.Mesh` (ref tracer.py:24 — C++/CUDA LBVH in the warp-lang dependency). The
traversal consumers (the plain walk of rfx_torch.ops.bvh_traverse and the
CUDA walk of rfx_torch/csrc/bvh_walk.cuh) want a *stackless* linear layout:

- nodes stored in DFS preorder;
- internal node: on AABB hit continue to node i+1, on miss jump to skip[i];
- leaf node: test its triangle range, then continue to skip[i] (== i+1 in
  preorder);
- leaf triangle ranges are contiguous in a reordered triangle array, padded
  to LEAF_PAD so fixed-size vector loads never run out of bounds.

Builder: binned median/SAH split over centroids (NumPy). A C++ builder with
the same output layout (native/bvh_builder.cpp, compiled at first use by
rfx_torch.ops.native_lib) takes large meshes; `build_bvh(..., method=...)`
selects.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from rfx_torch.geometry import TriangleMesh
from rfx_torch.utils.logging import get_logger
from rfx_torch.utils.profiling import set_gauge, span

__all__ = ["FlatBVH", "build_bvh", "collapse_bvh", "as_flat_bvh", "resolve_flat_bvh",
           "LEAF_SIZE", "NATIVE_MIN_FACES"]

LEAF_SIZE = 8  # max triangles per leaf; also the pad quantum
#: `build_bvh(method="auto")` takes the native builder above this many faces,
#: where the numpy build time becomes material.
NATIVE_MIN_FACES = 100_000


@dataclass
class FlatBVH:
    """Flat skip-pointer BVH + leaf-reordered triangle SoA (host numpy)."""

    aabb_min: np.ndarray  # (n_nodes, 3) f32
    aabb_max: np.ndarray  # (n_nodes, 3) f32
    tri_start: np.ndarray  # (n_nodes,) i32 — first padded-tri index (leaves)
    tri_count: np.ndarray  # (n_nodes,) i32 — 0 for internal nodes
    skip: np.ndarray  # (n_nodes,) i32 — next preorder node if subtree skipped
    # Leaf-padded triangle SoA; padded entries are degenerate (never hit) and
    # map to face -1.
    tri_v0: np.ndarray  # (P, 3) f32
    tri_e1: np.ndarray  # (P, 3) f32
    tri_e2: np.ndarray  # (P, 3) f32
    tri_face: np.ndarray  # (P,) i32 — original face index, -1 for padding
    leaf_size: int = LEAF_SIZE  # pad quantum used at build time

    @property
    def n_nodes(self) -> int:
        return int(self.aabb_min.shape[0])

    @property
    def n_padded_tris(self) -> int:
        return int(self.tri_v0.shape[0])

    def children(self, i: int) -> list[int]:
        """Direct children of node i in the preorder/skip layout (any arity):
        first child at i+1, each next sibling at the previous child's skip."""
        out = []
        c = i + 1
        end = int(self.skip[i])
        while c < end:
            out.append(c)
            c = int(self.skip[c])
        return out

    def max_depth(self) -> int:
        """Levels of the tree, the root's included, for any arity, without a
        walk: internal node j is an ancestor of nodes j+1 .. skip[j]-1, so a
        node's ancestors are a running sum of +1 at j+1 and -1 at skip[j]."""
        skip = np.asarray(self.skip, np.int64)
        n = skip.shape[0]
        j = np.flatnonzero(np.asarray(self.tri_count) == 0)
        step = np.bincount(j + 1, minlength=n + 1) - np.bincount(skip[j], minlength=n + 1)
        return 1 + int(np.cumsum(step[:n]).max())


def _centroid_split(order, lo, hi, centroids, bounds_min, bounds_max):
    """Median split on the widest centroid axis; returns mid index."""
    c = centroids[order[lo:hi]]
    ext = c.max(axis=0) - c.min(axis=0)
    axis = int(np.argmax(ext))
    mid = (lo + hi) // 2
    sel = np.argpartition(c[:, axis], mid - lo)
    order[lo:hi] = order[lo:hi][sel]
    return mid


_SAH_BINS = 16


def _sah_split(order, lo, hi, centroids, bounds_min, bounds_max):
    """Binned surface-area-heuristic split (16 bins, all 3 axes); returns the
    mid index, falling back to the median split when SAH degenerates.

    Minimizes SA_L * n_L + SA_R * n_R over bin boundaries — tighter child
    boxes than the median split (15% lower total node surface area on the
    terrain scene), which matters doubly for the tile-uniform Pallas walk: a
    tile visits the UNION of nodes any of its rays hits, so box overlap
    compounds across the tile. Measured: ~3.5% fewer device-ms summed over
    the first three bounce states vs median — modest, and free at trace time.
    """
    sel_idx = order[lo:hi]
    c = centroids[sel_idx]
    n = hi - lo
    cmin = c.min(axis=0)
    cmax = c.max(axis=0)
    ext = cmax - cmin
    best = (np.inf, -1, -1)  # (cost, axis, bin)
    binids_by_axis = {}
    for axis in range(3):
        if ext[axis] <= 0:
            continue
        b = np.minimum(
            ((c[:, axis] - cmin[axis]) / ext[axis] * _SAH_BINS).astype(np.int64),
            _SAH_BINS - 1,
        )
        binids_by_axis[axis] = b
        counts = np.bincount(b, minlength=_SAH_BINS)
        # per-bin bounds from triangle AABBs
        bmin = np.full((_SAH_BINS, 3), np.inf, np.float64)
        bmax = np.full((_SAH_BINS, 3), -np.inf, np.float64)
        np.minimum.at(bmin, b, bounds_min[sel_idx])
        np.maximum.at(bmax, b, bounds_max[sel_idx])
        # prefix (left) and suffix (right) accumulations
        lmin = np.minimum.accumulate(bmin, axis=0)
        lmax = np.maximum.accumulate(bmax, axis=0)
        rmin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1]
        rmax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1]
        lcnt = np.cumsum(counts)
        rcnt = n - lcnt

        def area(mn, mx):
            d = np.maximum(mx - mn, 0.0)
            return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

        # split after bin k (k = 0.._SAH_BINS-2)
        la = area(lmin, lmax)[:-1]
        ra = area(rmin, rmax)[1:]
        cost = np.where(
            (lcnt[:-1] > 0) & (rcnt[:-1] > 0),
            la * lcnt[:-1] + ra * rcnt[:-1],
            np.inf,
        )
        k = int(np.argmin(cost))
        if cost[k] < best[0]:
            best = (float(cost[k]), axis, k)
    if best[1] < 0:
        return _centroid_split(order, lo, hi, centroids, bounds_min, bounds_max)
    axis, k = best[1], best[2]
    left = binids_by_axis[axis] <= k
    nl = int(left.sum())
    if nl == 0 or nl == n:
        return _centroid_split(order, lo, hi, centroids, bounds_min, bounds_max)
    order[lo:hi] = np.concatenate([sel_idx[left], sel_idx[~left]])
    return lo + nl


def collapse_bvh(flat: FlatBVH, arity: int) -> FlatBVH:
    """Collapse a binary skip-pointer BVH into an n-ary one (round-5 walk
    optimization): repeatedly replace an internal child by its own children
    (largest-surface-area child first) until each node has up to `arity`
    children, then re-emit preorder + skip pointers.

    Leaves — and therefore the padded triangle SoA — are untouched; only the
    internal-node set shrinks (binary: L-1 internals for L leaves; n-ary:
    ~(L-1)/(arity-1)). The tile-uniform Pallas walk visits preorder nodes in
    speculative windows at a roughly fixed cost per window regardless of how
    many node tests are useful (PROFILE_r04 revised roofline), so fewer,
    fatter nodes => fewer windows => faster walk. Traversal results are
    identical by construction (same leaves, each still guarded by its own
    AABB; only intermediate culling levels are removed).
    """
    if arity <= 2:
        return flat
    is_leaf = flat.tri_count > 0
    ext = np.maximum(flat.aabb_max - flat.aabb_min, 0.0)
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]

    def wide_children(i):
        kids = flat.children(i)
        while len(kids) < arity:
            best, best_a = -1, -1.0
            for j, k in enumerate(kids):
                if not is_leaf[k] and area[k] > best_a:
                    best_a, best = float(area[k]), j
            if best < 0:
                break
            kids[best : best + 1] = flat.children(kids[best])
        return kids

    new_min, new_max, new_start, new_count, new_skip = [], [], [], [], []
    # Iterative preorder emit with explicit close markers (no recursion limit).
    stack = [(0, False)]
    while stack:
        i, closing = stack.pop()
        if closing:
            new_skip[i] = len(new_min)  # i is a NEW index here
            continue
        idx = len(new_min)
        new_min.append(flat.aabb_min[i])
        new_max.append(flat.aabb_max[i])
        new_skip.append(0)
        if is_leaf[i]:
            new_start.append(int(flat.tri_start[i]))
            new_count.append(int(flat.tri_count[i]))
            new_skip[idx] = idx + 1
        else:
            new_start.append(0)
            new_count.append(0)
            stack.append((idx, True))
            for c in reversed(wide_children(i)):
                stack.append((c, False))
    return FlatBVH(
        aabb_min=np.asarray(new_min, np.float32),
        aabb_max=np.asarray(new_max, np.float32),
        tri_start=np.asarray(new_start, np.int32),
        tri_count=np.asarray(new_count, np.int32),
        skip=np.asarray(new_skip, np.int32),
        tri_v0=flat.tri_v0,
        tri_e1=flat.tri_e1,
        tri_e2=flat.tri_e2,
        tri_face=flat.tri_face,
        leaf_size=flat.leaf_size,
    )


def build_bvh(
    mesh: TriangleMesh, leaf_size: int = LEAF_SIZE, method: str = "auto", split: str = "sah",
    arity: int = 2,
) -> FlatBVH:
    """Build the flat BVH. method: 'numpy' | 'native' | 'auto' (native above
    NATIVE_MIN_FACES faces; the numpy builder, with a logged warning, where
    the native one cannot be compiled). 'native' raises where it cannot be
    compiled. The two builders give the same layout contract, not the same
    tree. split: 'sah' (binned surface-area heuristic) or 'median' (centroid
    median). arity > 2 collapses the binary tree into an n-ary one (see
    collapse_bvh). The build runs in the span `rfx.bvh.build` and sets the
    gauges `bvh_build_s` and `bvh_native` of `profiling.counters()`."""
    if method not in ("auto", "numpy", "native"):
        raise ValueError(f"unknown BVH build method: {method}")
    if method == "auto":
        method = "numpy"
        if mesh.num_faces > NATIVE_MIN_FACES:
            from rfx_torch.ops import native_lib

            if native_lib.native_available():
                method = "native"
            else:
                get_logger("rfx_torch.bvh").warning(
                    "native BVH builder unavailable (%s): building %d faces with the recursive "
                    "numpy builder, which is slow at this size (minutes for 10^6 faces)",
                    native_lib.unavailable_reason(), mesh.num_faces)
    t0 = time.perf_counter()
    with span("rfx.bvh.build"):
        if method == "native":
            from rfx_torch.ops.native_lib import build_bvh_native

            flat = build_bvh_native(mesh, leaf_size, split=split)
        else:
            flat = _build_numpy(mesh, leaf_size, split)
        flat = collapse_bvh(flat, arity)
    set_gauge("bvh_build_s", time.perf_counter() - t0)
    set_gauge("bvh_native", int(method == "native"))
    return flat


def _build_numpy(mesh: TriangleMesh, leaf_size: int, split: str) -> FlatBVH:
    tri = mesh.triangles().astype(np.float32)  # (F, 3, 3)
    f = tri.shape[0]
    tmin = tri.min(axis=1)
    tmax = tri.max(axis=1)
    centroids = tri.mean(axis=1)
    split_fn = _sah_split if split == "sah" else _centroid_split

    order = np.arange(f, dtype=np.int64)

    # Iterative preorder build with an explicit stack; children pushed right
    # first so the left child lands at i+1.
    aabb_min, aabb_max, tri_start, tri_count, skips = [], [], [], [], []
    leaf_ranges = []  # (padded_start, count, order_lo) per leaf, for reorder
    padded_cursor = 0

    # Stack holds (lo, hi, parent_fixup) where parent_fixup is the index whose
    # skip must be set once this subtree's extent is known. We instead compute
    # skip in a second pass using subtree sizes, so the stack holds spans and
    # we record each node's subtree extent.
    def rec(lo, hi):
        nonlocal padded_cursor
        idx = len(aabb_min)
        sel = order[lo:hi]
        aabb_min.append(tmin[sel].min(axis=0))
        aabb_max.append(tmax[sel].max(axis=0))
        tri_start.append(0)
        tri_count.append(0)
        skips.append(0)
        if hi - lo <= leaf_size:
            count = hi - lo
            padded = -(-count // leaf_size) * leaf_size
            tri_start[idx] = padded_cursor
            tri_count[idx] = count
            leaf_ranges.append((padded_cursor, lo, count))
            padded_cursor += padded
        else:
            mid = split_fn(order, lo, hi, centroids, tmin, tmax)
            if mid == lo or mid == hi:  # degenerate split: force halve
                mid = (lo + hi) // 2
            rec(lo, mid)
            rec(mid, hi)
        skips[idx] = len(aabb_min)  # preorder index just past this subtree
        return idx

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * int(np.log2(max(f, 2)) + 2) * 64))
    try:
        rec(0, f)
    finally:
        sys.setrecursionlimit(old_limit)

    n_nodes = len(aabb_min)
    # Reorder + pad triangles.
    P = padded_cursor
    tri_v0 = np.zeros((P, 3), np.float32)
    tri_e1 = np.zeros((P, 3), np.float32)
    tri_e2 = np.zeros((P, 3), np.float32)
    tri_face = np.full((P,), -1, np.int32)
    for pstart, olo, count in leaf_ranges:
        sel = order[olo : olo + count]
        t = tri[sel]
        tri_v0[pstart : pstart + count] = t[:, 0]
        tri_e1[pstart : pstart + count] = t[:, 1] - t[:, 0]
        tri_e2[pstart : pstart + count] = t[:, 2] - t[:, 0]
        tri_face[pstart : pstart + count] = sel.astype(np.int32)

    return FlatBVH(
        aabb_min=np.asarray(aabb_min, np.float32),
        aabb_max=np.asarray(aabb_max, np.float32),
        tri_start=np.asarray(tri_start, np.int32),
        tri_count=np.asarray(tri_count, np.int32),
        skip=np.asarray(skips, np.int32),
        tri_v0=tri_v0,
        tri_e1=tri_e1,
        tri_e2=tri_e2,
        tri_face=tri_face,
        leaf_size=leaf_size,
    )


_FLAT_FIELDS = ("aabb_min", "aabb_max", "tri_start", "tri_count", "skip", "tri_v0", "tri_e1",
                "tri_e2", "tri_face")


def as_flat_bvh(obj) -> FlatBVH | None:
    """`obj` itself if it is a FlatBVH; a FlatBVH of numpy copies, carried
    across field by field, if it has every field of one (the JAX package's
    own `FlatBVH` is another type); None otherwise."""
    if isinstance(obj, FlatBVH):
        return obj
    if not all(hasattr(obj, f) for f in _FLAT_FIELDS):
        return None
    f32 = ("aabb_min", "aabb_max", "tri_v0", "tri_e1", "tri_e2")
    fields = {f: np.array(getattr(obj, f), np.float32 if f in f32 else np.int32)
              for f in _FLAT_FIELDS}
    return FlatBVH(**fields, leaf_size=int(getattr(obj, "leaf_size", LEAF_SIZE)))


def resolve_flat_bvh(mesh_or_flat, leaf_size: int = LEAF_SIZE, method: str = "auto") -> FlatBVH:
    """A FlatBVH from a prebuilt one (see as_flat_bvh) or, for a mesh, from
    `build_bvh(mesh, leaf_size, method)`."""
    flat = as_flat_bvh(mesh_or_flat)
    if flat is not None:
        return flat
    if not (hasattr(mesh_or_flat, "triangles") and hasattr(mesh_or_flat, "num_faces")):
        raise TypeError(f"expected a FlatBVH or a TriangleMesh, got {type(mesh_or_flat).__name__}")
    return build_bvh(mesh_or_flat, leaf_size=leaf_size, method=method)
