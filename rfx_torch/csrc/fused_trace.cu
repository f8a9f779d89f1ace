// Fused multi-bounce trace: one thread per ray, the whole bounce loop inside
// the thread (the form of warp's mesh_query_ray).
//
// Replaces rfx/ops/pallas_fused.py:_fused_kernel, the TPU kernel launched by
// fused_trace_planes. Per bounce and per ray:
//   1. closest hit over the flat BVH: rfx::bvh_closest_hit (bvh_walk.cuh),
//      the walk the per-query kernel (closest_hit.cu) runs too;
//   2. analytic receiver sphere and the capture rule
//      alive & t_rx < 1e29 & t_env > t_rx (:509-523);
//   3. specular reflection and the algebraic s-pol Fresnel factor
//      (:535-549). A ray that is captured or escapes leaves the loop; its
//      outputs are those the Pallas kernel gives the parked ray.
// With a face table (record_faces, :531-533), bounce b of a ray records the
// original face id of its hit where the ray env-bounced at b, and -1
// otherwise, including every bounce after the ray left the loop: the record
// the differentiable replay backward reads (rfx_torch/ops/fused.py).
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
// The face record is (B, N) int32, so a warp's writes for one bounce are
// contiguous.
//
// Rounding: the source is built with -fmad=false (rfx_torch/ops/_build.py),
// so every product and sum rounds as PyTorch's elementwise operations do in
// the plain version (rfx_torch/ops/fused.py:fused_trace_plain); a contracted
// multiply-add can flip the Moller-Trumbore edge tests of a grazing ray.
// Division and sqrt are IEEE (no --use_fast_math).

#include <cuda_runtime.h>

#include "bvh_walk.cuh"

namespace {

using rfx::kMiss;
using rfx::kMissThreshold;
using rfx::kTMin;

constexpr int kThreads = 128;

// tri_face and faces are null unless the face record is asked for.
__global__ void __launch_bounds__(kThreads) fused_trace_kernel(
    const float* __restrict__ dirs, int n,
    const float4* __restrict__ node_box, const int4* __restrict__ node_meta,
    int n_nodes, const float4* __restrict__ tris, const int* __restrict__ tri_face,
    float tx0, float tx1, float tx2, float rx0, float rx1, float rx2,
    float r2, float n1, float n2, int max_bounces,
    bool* __restrict__ captured, float* __restrict__ cap_amp,
    float* __restrict__ cap_dist, int* __restrict__ num_bounces, int* __restrict__ faces) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n) return;

  float ox = tx0, oy = tx1, oz = tx2;
  float dx = dirs[3 * ray], dy = dirs[3 * ray + 1], dz = dirs[3 * ray + 2];
  float amp = 1.0f, dist = 0.0f;
  bool capt = false;
  float camp = 0.0f, cdist = 0.0f;
  int nb = 0;

  for (int b = 0; b < max_bounces; ++b) {
    int best;
    const float t_best = rfx::bvh_closest_hit(ox, oy, oz, dx, dy, dz, node_box, node_meta,
                                              n_nodes, tris, &best);

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
    if (faces != nullptr) faces[static_cast<size_t>(b) * n + ray] = tri_face[best];
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

  if (faces != nullptr) {
    for (int b = nb; b < max_bounces; ++b) faces[static_cast<size_t>(b) * n + ray] = -1;
  }
  captured[ray] = capt;
  cap_amp[ray] = camp;
  cap_dist[ray] = cdist;
  num_bounces[ray] = nb;
}

}  // namespace

// tri_face and faces may be null (no face record); faces is (max_bounces, n).
extern "C" int rfx_fused_trace(
    const void* dirs, int n, const void* node_box, const void* node_meta,
    int n_nodes, const void* tris, const void* tri_face, float tx0, float tx1, float tx2,
    float rx0, float rx1, float rx2, float r2, float n1, float n2,
    int max_bounces, void* captured, void* cap_amp, void* cap_dist,
    void* num_bounces, void* faces, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    fused_trace_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(dirs), n, static_cast<const float4*>(node_box),
        static_cast<const int4*>(node_meta), n_nodes, static_cast<const float4*>(tris),
        static_cast<const int*>(tri_face), tx0, tx1, tx2, rx0, rx1, rx2, r2, n1, n2, max_bounces,
        static_cast<bool*>(captured), static_cast<float*>(cap_amp),
        static_cast<float*>(cap_dist), static_cast<int*>(num_bounces),
        static_cast<int*>(faces));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rfx_fused_trace_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
