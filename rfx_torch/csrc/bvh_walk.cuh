// Closest hit of one ray over a BVH, in two walks that share the slab test
// and the triangle test, so that no two kernels can disagree on a box or on a
// triangle's t:
//   - bvh_closest_hit, the stackless preorder / skip-pointer walk over the
//     preorder table (rfx/bvh.py's layout). The per-query kernel
//     (closest_hit.cu) and the counted fused trace (fused_trace.cu's
//     fused_trace_counted_kernel) take it: their walk counters are defined
//     as its visits (rfx_torch/ops/bvh_traverse.py counts the same), and the
//     fused trace falls back on it where a tree has no child-pair table or
//     is deeper than the near-first walk's stack;
//   - bvh_closest_hit_near_first, the ordered walk over the child-pair table
//     (Aila & Laine, "Understanding the Efficiency of Ray Traversal on GPUs",
//     HPG 2009): the uncounted fused trace (fused_trace_kernel, both
//     receivers) takes it wherever the tree fits the stack.
//
// The preorder walk: a box that is hit sends the walk to node i+1, a missed
// box to skip[i]; a leaf tests its tri_count triangles and then goes to
// skip[i]. It visits a node's children in build order.
//
// The near-first walk: a visit reads one record, both children's boxes,
// and slab-tests both; the lane goes into the hit child whose box it enters
// first (the smaller t_near, the left child on a tie) and pushes the other,
// if hit, with its t_near onto a per-thread stack of kNearFirstStack
// entries. When neither child is hit, or after a leaf, it pops; an entry
// whose t_near is above the best t found since it was pushed is dropped.
// Near hits found first let the slab test cut the far subtrees that the
// preorder walk descends before it. The root's own box is not tested: the
// children's boxes lie inside it, so a ray that misses it misses both.
// Both the slab test and the drop compare t_near with the best t widened by
// kNearSlack (2^-16, relative), not with the best t itself: a box's f32
// slab entry can round above the f32 Moller-Trumbore t of a triangle inside
// it (one ulp above for about a quarter of tests/test_torch_near_first.py's
// tilted rays into a flat box), and an exact cut would then drop a box that holds a
// triangle at the best t and a lower index, which the preorder walk, taking
// the lower indices first, never drops. The slack costs a visit only where
// a box's entry lies within it of the best t.
//
// Both walks: the slab test is `t_near <= min(t_far, t_best) && t_far >=
// T_MIN_EPS` (rfx/ops/pallas_fused.py:249-263), Moller-Trumbore is that of
// the Pallas row_work (:192-208) with |det| > 1e-12 and t > 1e-4, and a hit
// replaces the best one where its (t, padded index) is smaller: the smallest
// t wins, and among equal t the lowest index, as in the Pallas select-min
// fold (:209-220), whatever order the triangles are tested in (the preorder
// walk tests them in increasing index, where the rule is a strict `<`).
//
// Table layouts (rfx_torch/ops/bvh_pack.py):
//   nodes: the preorder table, 2 float4 per node, one aligned 32-byte
//          sector: (lo.x, lo.y, lo.z, skip), (hi.x, hi.y, hi.z, leaf);
//          `skip` and `leaf` are int32 bit patterns in the float lanes,
//          leaf = tri_start << 6 | tri_count, and tri_count == 0 (leaf == 0)
//          marks an internal node;
//   pairs: the child-pair table, 4 float4 per internal node in preorder,
//          one aligned 64-byte record: (lo.xyz, ref), (hi.xyz, 0) of the left
//          child, then of the right; ref = tri_start << 6 | tri_count for a
//          leaf child and k << 6 for an internal one, k its record (record 0
//          is the root);
//   tris:  3 float4 per padded triangle, the 12 floats v0, e1, e2, unit
//          normal; padding rows are degenerate and never hit.
//
// What bounds a walk on an H100 is the chain of dependent loads, each an L2
// round trip (an HBM one where the tables outgrow the L2), and the lanes of
// a warp that wait for each other; the arithmetic per visit is small. What
// the walks do about it:
//   - a preorder visit is two 16-byte loads of one sector (it was three
//     loads from two arrays); a near-first visit is four 16-byte loads of
//     one record, issued together, so both children's boxes cost one round
//     trip;
//   - both have the while-while form: every lane steps through nodes until
//     it holds a leaf or has left the tree, and then the lanes that hold a
//     leaf test their triangles together, so a lane inside a leaf no longer
//     holds up the lanes that are still stepping through boxes. Nothing is
//     speculated.
//   - a leaf's triangles can be loaded several at a time before the first
//     test (`WalkLoads`, a template parameter). Measured on the card (PERF.md
//     has the times): it made the fused trace slower, because the registers
//     that hold the batch cost more warps than the round trips saved, so the
//     fused trace keeps one at a time; the per-query kernel, whose grids are
//     small or whose walks are long and incoherent, gains 2-11% from four.
// Measured for the per-query kernel and not kept: loading a node together
// with its preorder successor (one 64-byte request; 5-19% slower: most steps
// skip, and the second box is wasted traffic and registers).
//
// The preorder walk is a template on a counting policy: NoCount's calls are
// empty, so that instantiation compiles to the walk without counters;
// WalkCount tallies per ray the nodes visited (`nodes`), the leaves whose
// box was hit (`leaves`) and the triangles tested (`tris`), what the counted
// fused trace sums per bounce (fused_trace.cu) and what the plain stackless
// walk counts (rfx_torch/ops/bvh_traverse.py). The near-first walk's plain
// version is rfx_torch/ops/bvh_traverse.py:near_first_closest_hit.
//
// Built with -fmad=false (rfx_torch/ops/_build.py): every product and sum
// rounds as PyTorch's elementwise operations do in the plain versions.

#pragma once

#include <cuda_runtime.h>

namespace rfx {

constexpr float kTMin = 1e-4f;            // rfx.ops.intersect.T_MIN_EPS
constexpr float kMiss = 1e30f;            // rfx.ops.intersect.MISS
constexpr float kMissThreshold = 1e29f;   // rfx.ops.intersect.MISS_THRESHOLD
constexpr float kDetEps = 1e-12f;
constexpr float kInvEps = 1e-30f;
constexpr int kCountBits = 6;             // rfx_torch.ops.bvh_pack.COUNT_BITS
constexpr int kCountMask = (1 << kCountBits) - 1;
// Entries of the near-first walk's stack: rfx_torch.ops.bvh_pack.STACK_CAPACITY.
// A launch whose tree needs more takes the preorder walk.
constexpr int kNearFirstStack = 32;
// The near-first walk's cut: t_near <= t_best * kNearSlack (see above);
// rfx_torch.ops.bvh_traverse.NEAR_SLACK.
constexpr float kNearSlack = 1.0f + 1.0f / 65536.0f;

__device__ __forceinline__ float inv_dir(float v) {
  return fabsf(v) > kInvEps ? 1.0f / v : kMiss;
}

struct NoCount {
  __device__ __forceinline__ void node() {}
  __device__ __forceinline__ void leaf(int) {}
};

struct WalkCount {
  unsigned nodes = 0, leaves = 0, tris = 0;
  __device__ __forceinline__ void node() { ++nodes; }
  __device__ __forceinline__ void leaf(int n_tris) {
    ++leaves;
    tris += static_cast<unsigned>(n_tris);
  }
};

struct Hit {
  float t = kMiss;
  int tri = -1;
};

// Moller-Trumbore of the ray against padded triangle j, given its lanes 0-8
// (a: v0.xyz, e1.x; c: e1.yz, e2.xy; e2z); a hit of smaller (t, j) replaces
// `hit`.
__device__ __forceinline__ void test_triangle(
    float ox, float oy, float oz, float dx, float dy, float dz,
    const float4 a, const float4 c, const float e2z, int j, Hit& hit) {
  const float v0x = a.x, v0y = a.y, v0z = a.z;
  const float e1x = a.w, e1y = c.x, e1z = c.y;
  const float e2x = c.z, e2y = c.w;
  const float px = e2z * dy - e2y * dz;
  const float py = e2x * dz - e2z * dx;
  const float pz = e2y * dx - e2x * dy;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool valid = fabsf(det) > kDetEps;
  const float inv_det = valid ? 1.0f / det : 0.0f;
  const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
  const float u = (tvx * px + tvy * py + tvz * pz) * inv_det;
  const float qx = tvy * e1z - tvz * e1y;
  const float qy = tvz * e1x - tvx * e1z;
  const float qz = tvx * e1y - tvy * e1x;
  const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  const bool ok = valid && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > kTMin);
  if (ok && (t < hit.t || (t == hit.t && j < hit.tri))) {
    hit.t = t;
    hit.tri = j;
  }
}

// The slab test of the box (lo, hi) for the ray from (ox, oy, oz) with
// inverse direction (ix, iy, iz): whether the ray enters it at or before
// t_best (the preorder walk's best t, the near-first walk's widened one) and
// leaves it at or after kTMin; `t_near` is where it enters.
__device__ __forceinline__ bool box_hit(const float4 lo, const float4 hi, float ox, float oy,
                                        float oz, float ix, float iy, float iz, float t_best,
                                        float& t_near) {
  const float lox = (lo.x - ox) * ix, hix = (hi.x - ox) * ix;
  const float loy = (lo.y - oy) * iy, hiy = (hi.y - oy) * iy;
  const float loz = (lo.z - oz) * iz, hiz = (hi.z - oz) * iz;
  t_near = fmaxf(fmaxf(fminf(lox, hix), fminf(loy, hiy)), fminf(loz, hiz));
  const float t_far = fminf(fminf(fmaxf(lox, hix), fmaxf(loy, hiy)), fmaxf(loz, hiz));
  return (t_near <= fminf(t_far, t_best)) && (t_far >= kTMin);
}

// How a walk loads a leaf: its triangles are loaded kLeafBatch at a time
// before the first of them is tested, so a leaf of n triangles waits for
// ceil(n / kLeafBatch) round trips instead of n. The results do not depend on
// it: every policy tests the same triangles in the same order. The fused
// trace keeps 1 (the batch's registers cost it more warps than the round
// trips saved); the per-query kernel takes 4 (closest_hit.cu).
struct WalkLoads {
  static constexpr int kLeafBatch = 1;
};

// The `count` triangles from padded index `start`, in increasing index.
template <class Loads>
__device__ __forceinline__ void test_leaf(
    float ox, float oy, float oz, float dx, float dy, float dz,
    const float4* __restrict__ tris, int start, int count, Hit& hit) {
  constexpr int kBatch = Loads::kLeafBatch;
  const int end = start + count;
  for (int j0 = start; j0 < end; j0 += kBatch) {
    float4 a[kBatch], c[kBatch];
    float e2z[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int j = j0 + b < end ? j0 + b : end - 1;
      const float4* row = tris + 3 * static_cast<size_t>(j);
      a[b] = row[0];
      c[b] = row[1];
      e2z[b] = reinterpret_cast<const float*>(row + 2)[0];
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (j0 + b < end) test_triangle(ox, oy, oz, dx, dy, dz, a[b], c[b], e2z[b], j0 + b, hit);
    }
  }
}

// Walks the BVH from the root for the ray (o, d); returns the closest t
// (kMiss on a miss) and writes the padded index of its triangle to *best
// (-1 on a miss). A ray parked far outside the scene (|o| ~ 1e9) misses the
// root box and returns at once.
template <class Counter, class Loads = WalkLoads>
__device__ __forceinline__ float bvh_closest_hit(
    float ox, float oy, float oz, float dx, float dy, float dz,
    const float4* __restrict__ nodes, int n_nodes, const float4* __restrict__ tris,
    int* best_out, Counter& counter) {
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  Hit hit;
  int node = 0;
  while (node < n_nodes) {
    // Step through nodes until this lane holds a leaf (`leaf` != 0) or has
    // left the tree.
    int leaf = 0;
    do {
      counter.node();
      const float4 lo = nodes[2 * node];
      const float4 hi = nodes[2 * node + 1];
      float t_near;
      const bool hit_box = box_hit(lo, hi, ox, oy, oz, ix, iy, iz, hit.t, t_near);
      const int packed = __float_as_int(hi.w);
      if (!hit_box) {
        node = __float_as_int(lo.w);
      } else if (packed == 0) {
        node = node + 1;
      } else {
        leaf = packed;
        node = __float_as_int(lo.w);
      }
    } while (leaf == 0 && node < n_nodes);
    if (leaf != 0) {
      const int count = leaf & kCountMask;
      counter.leaf(count);
      test_leaf<Loads>(ox, oy, oz, dx, dy, dz, tris, leaf >> kCountBits, count, hit);
    }
  }
  *best_out = hit.tri;
  return hit.t;
}

__device__ __forceinline__ float bvh_closest_hit(
    float ox, float oy, float oz, float dx, float dy, float dz,
    const float4* __restrict__ nodes, int n_nodes, const float4* __restrict__ tris,
    int* best_out) {
  NoCount counter;
  return bvh_closest_hit(ox, oy, oz, dx, dy, dz, nodes, n_nodes, tris, best_out, counter);
}

constexpr int kWalkDone = -1;  // no ref: every ref of the child-pair table is >= 0

// The next entry of the near-first stack (sp entries, (t_near, ref bits))
// whose box the ray enters at or before `bound`, dropping those it enters
// later; kWalkDone when none is left.
__device__ __forceinline__ int pop_near(const float2* stack, int& sp, float bound) {
  while (sp > 0) {
    const float2 e = stack[--sp];
    if (e.x <= bound) return __float_as_int(e.y);
  }
  return kWalkDone;
}

// The near-first walk of the ray (o, d) over the child-pair table `pairs`,
// whose tree has at most kNearFirstStack + 1 levels; returns what
// bvh_closest_hit returns.
template <class Loads = WalkLoads>
__device__ __forceinline__ float bvh_closest_hit_near_first(
    float ox, float oy, float oz, float dx, float dy, float dz,
    const float4* __restrict__ pairs, const float4* __restrict__ tris, int* best_out) {
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  Hit hit;
  float2 stack[kNearFirstStack];
  int sp = 0;
  int ref = 0;  // the root's record
  while (ref != kWalkDone) {
    // Step through internal nodes until this lane holds a leaf or is done.
    while (ref != kWalkDone && (ref & kCountMask) == 0) {
      const float4* rec = pairs + 4 * static_cast<size_t>(ref >> kCountBits);
      const float4 lo0 = rec[0], hi0 = rec[1], lo1 = rec[2], hi1 = rec[3];
      const float bound = hit.t * kNearSlack;
      float near0, near1;
      const bool hit0 = box_hit(lo0, hi0, ox, oy, oz, ix, iy, iz, bound, near0);
      const bool hit1 = box_hit(lo1, hi1, ox, oy, oz, ix, iy, iz, bound, near1);
      const int ref0 = __float_as_int(lo0.w), ref1 = __float_as_int(lo1.w);
      if (hit0 && hit1) {
        const bool left_first = near0 <= near1;
        stack[sp++] = make_float2(left_first ? near1 : near0,
                                  __int_as_float(left_first ? ref1 : ref0));
        ref = left_first ? ref0 : ref1;
      } else if (hit0) {
        ref = ref0;
      } else if (hit1) {
        ref = ref1;
      } else {
        ref = pop_near(stack, sp, bound);
      }
    }
    if (ref != kWalkDone) {
      test_leaf<Loads>(ox, oy, oz, dx, dy, dz, tris, ref >> kCountBits, ref & kCountMask, hit);
      ref = pop_near(stack, sp, hit.t * kNearSlack);
    }
  }
  *best_out = hit.tri;
  return hit.t;
}

}  // namespace rfx
