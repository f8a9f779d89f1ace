// Fused multi-bounce trace: one thread per ray, the whole bounce loop inside
// the thread (the form of warp's mesh_query_ray).
//
// Replaces rfx/ops/pallas_fused.py:_fused_kernel, the TPU kernel launched by
// fused_trace_planes. Per bounce and per ray:
//   1. closest hit over the flat preorder/skip-pointer BVH (rfx/bvh.py):
//      a box that is hit sends the walk to node i+1, a missed box to skip[i],
//      a leaf tests its tri_count triangles and then goes to skip[i];
//      slab test `t_near <= min(t_far, t_best) && t_far >= T_MIN_EPS`
//      (pallas_fused.py:249-263), Moller-Trumbore exactly as row_work
//      (:192-208) with |det| > 1e-12 and t > 1e-4, and a strict `<` update
//      in increasing padded-triangle index, so ties go to the lowest index as
//      in the Pallas select-min fold (:209-220);
//   2. analytic receiver sphere and the capture rule
//      alive & t_rx < 1e29 & t_env > t_rx (:509-523);
//   3. specular reflection and the algebraic s-pol Fresnel factor
//      (:535-549). A ray that is captured or escapes leaves the loop; its
//      outputs are those the Pallas kernel gives the parked ray.
//
// The TPU kernel's tile-uniform walk, speculative node windows, SMEM leaf
// ring and HBM streaming all exist because of TPU limits (no per-lane
// control flow, no lane-dynamic loads) and are not carried over.
//
// What bounds it on an H100: dependent, divergent loads of BVH nodes and
// triangles; the arithmetic per visit is small. The bench scene (32,258
// triangles at leaf 8) is about 0.3 MB of nodes and 2.6 MB of triangles, far
// inside the 50 MB L2, so the walk is bound by load latency and warp
// divergence, not by DRAM bandwidth. What the design does about it:
// Morton-ordered rays (rfx_torch.sampler.morton_sphere_directions) keep the
// 32 walks of a warp coherent, nodes are two aligned float4 loads plus one
// int4, triangles three float4 loads, and every table is read through
// `const __restrict__` pointers so the loads can use the read-only path.
//
// Rounding: the source is built with -fmad=false (rfx_torch/ops/_build.py),
// so every product and sum rounds as PyTorch's elementwise operations do in
// the plain version (rfx_torch/ops/fused.py:fused_trace_plain); a contracted
// multiply-add can flip the Moller-Trumbore edge tests of a grazing ray.
// Division and sqrt are IEEE (no --use_fast_math).

#include <cuda_runtime.h>

namespace {

constexpr float kTMin = 1e-4f;            // rfx.ops.intersect.T_MIN_EPS
constexpr float kMiss = 1e30f;            // rfx.ops.intersect.MISS
constexpr float kMissThreshold = 1e29f;   // rfx.ops.intersect.MISS_THRESHOLD
constexpr float kDetEps = 1e-12f;
constexpr float kInvEps = 1e-30f;
constexpr int kThreads = 128;

__device__ __forceinline__ float inv_dir(float v) {
  return fabsf(v) > kInvEps ? 1.0f / v : kMiss;
}

// node_box: 2 float4 per node, (lo.x, lo.y, lo.z, 0), (hi.x, hi.y, hi.z, 0).
// node_meta: int4 per node, (tri_start, tri_count, skip, 0); tri_count == 0
//            marks an internal node.
// tris: 3 float4 per padded triangle, the 12 floats v0, e1, e2, unit normal.
__global__ void __launch_bounds__(kThreads) fused_trace_kernel(
    const float* __restrict__ dirs, int n,
    const float4* __restrict__ node_box, const int4* __restrict__ node_meta,
    int n_nodes, const float4* __restrict__ tris,
    float tx0, float tx1, float tx2, float rx0, float rx1, float rx2,
    float r2, float n1, float n2, int max_bounces,
    bool* __restrict__ captured, float* __restrict__ cap_amp,
    float* __restrict__ cap_dist, int* __restrict__ num_bounces) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n) return;

  float ox = tx0, oy = tx1, oz = tx2;
  float dx = dirs[3 * ray], dy = dirs[3 * ray + 1], dz = dirs[3 * ray + 2];
  float amp = 1.0f, dist = 0.0f;
  bool capt = false;
  float camp = 0.0f, cdist = 0.0f;
  int nb = 0;

  for (int b = 0; b < max_bounces; ++b) {
    const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
    float t_best = kMiss;
    int best = -1;
    int node = 0;
    while (node < n_nodes) {
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

    // Analytic receiver sphere (rfx.ops.intersect.ray_sphere_hit).
    const float ocx = ox - rx0, ocy = oy - rx1, ocz = oz - rx2;
    const float bq = ocx * dx + ocy * dy + ocz * dz;
    const float cq = ocx * ocx + ocy * ocy + ocz * ocz - r2;
    const float disc = bq * bq - cq;
    float t_rx = kMiss;
    if (disc > 0.0f) {
      const float s = sqrtf(disc);
      const float t0 = -bq - s;
      const float t1 = -bq + s;
      t_rx = t0 > kTMin ? t0 : (t1 > kTMin ? t1 : kMiss);
    }

    if (t_rx < kMissThreshold && t_best > t_rx) {  // the receiver wins
      capt = true;
      camp = amp;
      cdist = dist + t_rx;
      break;
    }
    if (!(t_best < kMissThreshold)) break;  // escaped
    nb += 1;

    // Specular reflection + algebraic s-pol Fresnel:
    // w = d.n, sin(theta) = sqrt(1 - w^2), cos(theta) = |w|.
    const float4 e = tris[3 * best + 2];
    const float nx = e.y, ny = e.z, nz = e.w;
    const float w = dx * nx + dy * ny + dz * nz;
    const float rdx = dx - 2.0f * w * nx;
    const float rdy = dy - 2.0f * w * ny;
    const float rdz = dz - 2.0f * w * nz;
    const float aw = fabsf(w);
    const float sin_t = sqrtf(fmaxf(1.0f - aw * aw, 0.0f));
    const float sr = (n2 * sin_t) / n1;
    const float cos_i = sqrtf(fmaxf(1.0f - sr * sr, 0.0f));
    const float num = n2 * cos_i - n1 * aw;
    const float den = n2 * cos_i + n1 * aw;
    const bool den_ok = den != 0.0f;
    const float ratio = num / (den_ok ? den : 1.0f);
    const float fres = (sr <= 1.0f && den_ok) ? fminf(ratio * ratio, 1.0f) : 0.0f;

    ox = ox + dx * t_best;
    oy = oy + dy * t_best;
    oz = oz + dz * t_best;
    dx = rdx;
    dy = rdy;
    dz = rdz;
    amp = amp * fres;
    dist = dist + t_best;
  }

  captured[ray] = capt;
  cap_amp[ray] = camp;
  cap_dist[ray] = cdist;
  num_bounces[ray] = nb;
}

}  // namespace

extern "C" int rfx_fused_trace(
    const void* dirs, int n, const void* node_box, const void* node_meta,
    int n_nodes, const void* tris, float tx0, float tx1, float tx2,
    float rx0, float rx1, float rx2, float r2, float n1, float n2,
    int max_bounces, void* captured, void* cap_amp, void* cap_dist,
    void* num_bounces, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    fused_trace_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(dirs), n, static_cast<const float4*>(node_box),
        static_cast<const int4*>(node_meta), n_nodes, static_cast<const float4*>(tris),
        tx0, tx1, tx2, rx0, rx1, rx2, r2, n1, n2, max_bounces,
        static_cast<bool*>(captured), static_cast<float*>(cap_amp),
        static_cast<float*>(cap_dist), static_cast<int*>(num_bounces));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rfx_fused_trace_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
