// Closest hit of one ray over the flat preorder / skip-pointer BVH
// (rfx/bvh.py), shared by the fused bounce-loop kernel (fused_trace.cu) and
// the per-query kernel (closest_hit.cu), so that the two can never disagree
// on a hit.
//
// A box that is hit sends the walk to node i+1, a missed box to skip[i]; a
// leaf tests its tri_count triangles and then goes to skip[i]. The slab test
// is `t_near <= min(t_far, t_best) && t_far >= T_MIN_EPS`
// (rfx/ops/pallas_fused.py:249-263), Moller-Trumbore is that of the Pallas
// row_work (:192-208) with |det| > 1e-12 and t > 1e-4, and the update is a
// strict `<` in increasing padded-triangle index, so ties go to the lowest
// index as in the Pallas select-min fold (:209-220).
//
// Table layouts (rfx_torch/ops/bvh_pack.py):
//   nodes: 2 float4 per node, one aligned 32-byte sector:
//          (lo.x, lo.y, lo.z, skip), (hi.x, hi.y, hi.z, leaf); `skip` and
//          `leaf` are int32 bit patterns in the float lanes, leaf =
//          tri_start << 6 | tri_count, and tri_count == 0 (leaf == 0) marks an
//          internal node;
//   tris:  3 float4 per padded triangle, the 12 floats v0, e1, e2, unit
//          normal; padding rows are degenerate and never hit.
//
// What bounds the walk on an H100 is the chain of dependent loads, each an
// L2 round trip, and the lanes of a warp that wait for each other; the
// arithmetic per visit is small. What the walk does about it:
//   - a node visit is two 16-byte loads of one sector (it was three loads
//     from two arrays);
//   - the walk has the while-while form: every lane steps through nodes until
//     it holds a leaf or has left the tree, and then the lanes that hold a
//     leaf test their triangles together, so a lane inside a leaf no longer
//     holds up the lanes that are still stepping through boxes. Nothing is
//     speculated: each lane visits the nodes it visited before, in the same
//     order.
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
// The walk is a template on a counting policy: NoCount's calls are empty, so
// that instantiation compiles to the walk without counters; WalkCount tallies
// per ray the nodes visited (`nodes`), the leaves whose box was hit
// (`leaves`) and the triangles tested (`tris`), what the counted fused trace
// sums per bounce (fused_trace.cu) and what the plain stackless walk counts
// (rfx_torch/ops/bvh_traverse.py).
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
// (a: v0.xyz, e1.x; c: e1.yz, e2.xy; e2z); a closer hit replaces `hit`.
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
  if (ok && t < hit.t) {
    hit.t = t;
    hit.tri = j;
  }
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
      const float lox = (lo.x - ox) * ix, hix = (hi.x - ox) * ix;
      const float loy = (lo.y - oy) * iy, hiy = (hi.y - oy) * iy;
      const float loz = (lo.z - oz) * iz, hiz = (hi.z - oz) * iz;
      const float t_near = fmaxf(fmaxf(fminf(lox, hix), fminf(loy, hiy)), fminf(loz, hiz));
      const float t_far = fminf(fminf(fmaxf(lox, hix), fmaxf(loy, hiy)), fmaxf(loz, hiz));
      const bool box_hit = (t_near <= fminf(t_far, hit.t)) && (t_far >= kTMin);
      const int packed = __float_as_int(hi.w);
      if (!box_hit) {
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

}  // namespace rfx
