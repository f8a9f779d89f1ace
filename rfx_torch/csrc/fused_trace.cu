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
// Walk counters (the TPU kernel's count_stats, :484-492: windows and leaf
// visits per tile and bounce). fused_trace_counted_kernel is the same bounce
// loop, through the same `bounce` function, with the walk's WalkCount policy:
// per bounce b it adds to stats[b] the rays' `nodes` (iterations of the
// walk's loop), `leaves` (leaves whose box was hit) and `tris` (triangles
// tested), and `warp_steps`, the largest `nodes` of any lane summed over
// warps: 32 * warp_steps / nodes is how much of the SIMT width divergence
// wastes, the card's counterpart of the TPU's windows. Lanes that are done
// stay in the counted loop with zero counts, so every warp vote has all 32
// lanes; a warp leaves the loop when none of its lanes is live. Sums go lane
// -> warp (__reduce_add_sync, __reduce_max_sync, 32 bits: the wrapper bounds
// the table sizes) -> block (64-bit atomics in shared memory) -> one 64-bit
// global atomic per block and counter. Integer adds commute, so the counters
// are deterministic. The uncounted kernel instantiates `bounce` with NoCount
// and has no vote, no atomic and no shared memory: its trace is what it was.
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
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kStatsPerBounce = 4;  // nodes, leaves, tris, warp_steps

// What every ray of a launch shares, gathered from the kernel's arguments
// (which stay `const __restrict__` pointers, so the tables' loads can take the
// read-only path). tri_face is null unless the face record is asked for.
struct Scene {
  const float4* node_box;
  const int4* node_meta;
  int n_nodes;
  const float4* tris;
  const int* tri_face;
  float rx0, rx1, rx2, r2, n1, n2;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float amp = 1.0f, dist = 0.0f;
  bool capt = false;
  float camp = 0.0f, cdist = 0.0f;
  int nb = 0;
};

// One bounce of one ray; false when the ray is captured or escapes. `faces`
// is null unless the face record is asked for.
template <class Counter>
__device__ __forceinline__ bool bounce(Ray& r, const Scene& s, int b, int ray, int n,
                                       int* __restrict__ faces, Counter& counter) {
  int best;
  const float t_best = rfx::bvh_closest_hit(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, s.node_box,
                                            s.node_meta, s.n_nodes, s.tris, &best, counter);

  // Analytic receiver sphere (rfx.ops.intersect.ray_sphere_hit).
  const float ocx = r.ox - s.rx0, ocy = r.oy - s.rx1, ocz = r.oz - s.rx2;
  const float bq = ocx * r.dx + ocy * r.dy + ocz * r.dz;
  const float cq = ocx * ocx + ocy * ocy + ocz * ocz - s.r2;
  const float disc = bq * bq - cq;
  float t_rx = kMiss;
  if (disc > 0.0f) {
    const float sq = sqrtf(disc);
    const float t0 = -bq - sq;
    const float t1 = -bq + sq;
    t_rx = t0 > kTMin ? t0 : (t1 > kTMin ? t1 : kMiss);
  }

  if (t_rx < kMissThreshold && t_best > t_rx) {  // the receiver wins
    r.capt = true;
    r.camp = r.amp;
    r.cdist = r.dist + t_rx;
    return false;
  }
  if (!(t_best < kMissThreshold)) return false;  // escaped
  if (faces != nullptr) faces[static_cast<size_t>(b) * n + ray] = s.tri_face[best];
  r.nb += 1;

  // Specular reflection + algebraic s-pol Fresnel:
  // w = d.n, sin(theta) = sqrt(1 - w^2), cos(theta) = |w|.
  const float4 e = s.tris[3 * best + 2];
  const float nx = e.y, ny = e.z, nz = e.w;
  const float w = r.dx * nx + r.dy * ny + r.dz * nz;
  const float rdx = r.dx - 2.0f * w * nx;
  const float rdy = r.dy - 2.0f * w * ny;
  const float rdz = r.dz - 2.0f * w * nz;
  const float aw = fabsf(w);
  const float sin_t = sqrtf(fmaxf(1.0f - aw * aw, 0.0f));
  const float sr = (s.n2 * sin_t) / s.n1;
  const float cos_i = sqrtf(fmaxf(1.0f - sr * sr, 0.0f));
  const float num = s.n2 * cos_i - s.n1 * aw;
  const float den = s.n2 * cos_i + s.n1 * aw;
  const bool den_ok = den != 0.0f;
  const float ratio = num / (den_ok ? den : 1.0f);
  const float fres = (sr <= 1.0f && den_ok) ? fminf(ratio * ratio, 1.0f) : 0.0f;

  r.ox = r.ox + r.dx * t_best;
  r.oy = r.oy + r.dy * t_best;
  r.oz = r.oz + r.dz * t_best;
  r.dx = rdx;
  r.dy = rdy;
  r.dz = rdz;
  r.amp = r.amp * fres;
  r.dist = r.dist + t_best;
  return true;
}

__device__ __forceinline__ Ray ray_from(const float* __restrict__ dirs, int ray, float tx0,
                                        float tx1, float tx2) {
  Ray r;
  r.ox = tx0;
  r.oy = tx1;
  r.oz = tx2;
  r.dx = dirs[3 * ray];
  r.dy = dirs[3 * ray + 1];
  r.dz = dirs[3 * ray + 2];
  return r;
}

__device__ __forceinline__ void store(const Ray& r, int ray, int n, int max_bounces,
                                      bool* __restrict__ captured, float* __restrict__ cap_amp,
                                      float* __restrict__ cap_dist, int* __restrict__ num_bounces,
                                      int* __restrict__ faces) {
  if (faces != nullptr) {
    for (int b = r.nb; b < max_bounces; ++b) faces[static_cast<size_t>(b) * n + ray] = -1;
  }
  captured[ray] = r.capt;
  cap_amp[ray] = r.camp;
  cap_dist[ray] = r.cdist;
  num_bounces[ray] = r.nb;
}

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
  const Scene scene{node_box, node_meta, n_nodes, tris, tri_face, rx0, rx1, rx2, r2, n1, n2};
  Ray r = ray_from(dirs, ray, tx0, tx1, tx2);
  rfx::NoCount counter;
  for (int b = 0; b < max_bounces; ++b) {
    if (!bounce(r, scene, b, ray, n, faces, counter)) break;
  }
  store(r, ray, n, max_bounces, captured, cap_amp, cap_dist, num_bounces, faces);
}

// stats is (max_bounces, kStatsPerBounce) unsigned 64-bit, zeroed by the
// caller; dynamic shared memory holds the block's copy of it.
__global__ void __launch_bounds__(kThreads) fused_trace_counted_kernel(
    const float* __restrict__ dirs, int n,
    const float4* __restrict__ node_box, const int4* __restrict__ node_meta,
    int n_nodes, const float4* __restrict__ tris, const int* __restrict__ tri_face,
    float tx0, float tx1, float tx2, float rx0, float rx1, float rx2,
    float r2, float n1, float n2, int max_bounces,
    bool* __restrict__ captured, float* __restrict__ cap_amp,
    float* __restrict__ cap_dist, int* __restrict__ num_bounces, int* __restrict__ faces,
    unsigned long long* __restrict__ stats) {
  extern __shared__ unsigned long long block_stats[];
  const int n_stats = kStatsPerBounce * max_bounces;
  for (int i = threadIdx.x; i < n_stats; i += blockDim.x) block_stats[i] = 0ull;
  __syncthreads();

  // No lane returns early: every vote below names all 32 lanes of the warp.
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  bool live = ray < n;
  const Scene scene{node_box, node_meta, n_nodes, tris, tri_face, rx0, rx1, rx2, r2, n1, n2};
  Ray r;
  if (live) r = ray_from(dirs, ray, tx0, tx1, tx2);
  for (int b = 0; b < max_bounces; ++b) {
    rfx::WalkCount counter;
    if (live) live = bounce(r, scene, b, ray, n, faces, counter);
    const unsigned nodes = __reduce_add_sync(kFullWarp, counter.nodes);
    const unsigned leaves = __reduce_add_sync(kFullWarp, counter.leaves);
    const unsigned tris = __reduce_add_sync(kFullWarp, counter.tris);
    const unsigned steps = __reduce_max_sync(kFullWarp, counter.nodes);
    if ((threadIdx.x & 31) == 0 && nodes != 0u) {
      unsigned long long* row = block_stats + kStatsPerBounce * b;
      atomicAdd(row + 0, static_cast<unsigned long long>(nodes));
      atomicAdd(row + 1, static_cast<unsigned long long>(leaves));
      atomicAdd(row + 2, static_cast<unsigned long long>(tris));
      atomicAdd(row + 3, static_cast<unsigned long long>(steps));
    }
    if (!__any_sync(kFullWarp, live)) break;  // warp-uniform
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_stats; i += blockDim.x) {
    if (block_stats[i] != 0ull) atomicAdd(stats + i, block_stats[i]);
  }
  if (ray < n) store(r, ray, n, max_bounces, captured, cap_amp, cap_dist, num_bounces, faces);
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
        static_cast<const int*>(tri_face), tx0, tx1, tx2, rx0, rx1, rx2, r2, n1, n2, max_bounces, static_cast<bool*>(captured), static_cast<float*>(cap_amp),
        static_cast<float*>(cap_dist), static_cast<int*>(num_bounces),
        static_cast<int*>(faces));
  }
  return static_cast<int>(cudaGetLastError());
}

// The counted instantiation: as rfx_fused_trace, and adds each bounce's
// (nodes, leaves, tris, warp_steps) to stats, (max_bounces, 4) unsigned
// 64-bit that the caller has zeroed.
extern "C" int rfx_fused_trace_counted(
    const void* dirs, int n, const void* node_box, const void* node_meta,
    int n_nodes, const void* tris, const void* tri_face, float tx0, float tx1, float tx2,
    float rx0, float rx1, float rx2, float r2, float n1, float n2,
    int max_bounces, void* captured, void* cap_amp, void* cap_dist,
    void* num_bounces, void* faces, void* stats, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    const size_t shared = sizeof(unsigned long long) * kStatsPerBounce * max_bounces;
    fused_trace_counted_kernel<<<blocks, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(dirs), n, static_cast<const float4*>(node_box),
        static_cast<const int4*>(node_meta), n_nodes, static_cast<const float4*>(tris),
        static_cast<const int*>(tri_face), tx0, tx1, tx2, rx0, rx1, rx2, r2, n1, n2, max_bounces, static_cast<bool*>(captured), static_cast<float*>(cap_amp),
        static_cast<float*>(cap_dist), static_cast<int*>(num_bounces),
        static_cast<int*>(faces), static_cast<unsigned long long*>(stats));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rfx_fused_trace_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* rfx_fused_trace_counted_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
