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
//   node_box:  2 float4 per node, (lo.x, lo.y, lo.z, 0), (hi.x, hi.y, hi.z, 0);
//   node_meta: int4 per node, (tri_start, tri_count, skip, 0); tri_count == 0
//              marks an internal node;
//   tris:      3 float4 per padded triangle, the 12 floats v0, e1, e2, unit
//              normal; padding rows are degenerate and never hit.
//
// The walk is a template on a counting policy: NoCount's calls are empty, so
// that instantiation compiles to the walk without counters; WalkCount tallies
// per ray the loop's iterations (`nodes`), the leaves whose box was hit
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

// Walks the BVH from the root for the ray (o, d); returns the closest t
// (kMiss on a miss) and writes the padded index of its triangle to *best
// (-1 on a miss). A ray parked far outside the scene (|o| ~ 1e9) misses the
// root box and returns at once.
template <class Counter>
__device__ __forceinline__ float bvh_closest_hit(
    float ox, float oy, float oz, float dx, float dy, float dz,
    const float4* __restrict__ node_box, const int4* __restrict__ node_meta,
    int n_nodes, const float4* __restrict__ tris, int* best_out, Counter& counter) {
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  float t_best = kMiss;
  int best = -1;
  int node = 0;
  while (node < n_nodes) {
    counter.node();
    const float4 lo = node_box[2 * node];
    const float4 hi = node_box[2 * node + 1];
    const int4 meta = node_meta[node];
    const float lox = (lo.x - ox) * ix, hix = (hi.x - ox) * ix;
    const float loy = (lo.y - oy) * iy, hiy = (hi.y - oy) * iy;
    const float loz = (lo.z - oz) * iz, hiz = (hi.z - oz) * iz;
    const float t_near = fmaxf(fmaxf(fminf(lox, hix), fminf(loy, hiy)), fminf(loz, hiz));
    const float t_far = fminf(fminf(fmaxf(lox, hix), fmaxf(loy, hiy)), fmaxf(loz, hiz));
    const bool box_hit = (t_near <= fminf(t_far, t_best)) && (t_far >= kTMin);
    if (!box_hit) {
      node = meta.z;
      continue;
    }
    if (meta.y == 0) {
      node = node + 1;
      continue;
    }
    counter.leaf(meta.y);
    for (int k = 0; k < meta.y; ++k) {
      const int j = meta.x + k;
      const float4 a = tris[3 * j];      // v0.xyz, e1.x
      const float4 c = tris[3 * j + 1];  // e1.yz, e2.xy
      const float4 e = tris[3 * j + 2];  // e2.z, normal
      const float v0x = a.x, v0y = a.y, v0z = a.z;
      const float e1x = a.w, e1y = c.x, e1z = c.y;
      const float e2x = c.z, e2y = c.w, e2z = e.x;
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
      if (ok && t < t_best) {
        t_best = t;
        best = j;
      }
    }
    node = meta.z;
  }
  *best_out = best;
  return t_best;
}

__device__ __forceinline__ float bvh_closest_hit(
    float ox, float oy, float oz, float dx, float dy, float dz,
    const float4* __restrict__ node_box, const int4* __restrict__ node_meta,
    int n_nodes, const float4* __restrict__ tris, int* best_out) {
  NoCount counter;
  return bvh_closest_hit(ox, oy, oz, dx, dy, dz, node_box, node_meta, n_nodes, tris, best_out,
                         counter);
}

}  // namespace rfx
