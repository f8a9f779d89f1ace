// Fused multi-bounce trace: one thread per ray, the whole bounce loop inside
// the thread (the form of warp's mesh_query_ray).
//
// Replaces rfx/ops/pallas_fused.py:_fused_kernel, the TPU kernel launched by
// fused_trace_planes. Per bounce and per ray:
//   1. closest hit over the BVH (bvh_walk.cuh): the near-first walk over the
//      child-pair table where the launch is given one (a binary tree that
//      fits the walk's stack: rfx_torch.ops.bvh_pack.PackedBVH.near_first),
//      else the preorder walk the per-query kernel (closest_hit.cu) runs
//      too; a template policy each (NearFirstWalk, PreorderWalk), chosen
//      for the whole launch;
//   2. the receiver, chosen at compile time (a template policy, no runtime
//      branch in the walk): the analytic sphere of the TPU kernel, or the
//      reference's 80-face icosphere (rfx/tracer.py:87-104, which the TPU
//      path ran only in the scan tracer); then the capture rule
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
// triangles, each an L2 round trip; the arithmetic per visit is small. The
// bench scene (32,258 triangles at leaf 8) is about 0.2 MB of nodes and 2.6 MB
// of triangles, far inside the 50 MB L2, and even the 1,045,458-triangle
// terrain's 10.9 MB of nodes are, so the walk is bound by load latency and by
// the lanes of a warp that wait for each other, not by DRAM bandwidth. What
// the design does about it: the near-first walk of bvh_walk.cuh (both
// children's boxes in one 64-byte record, the nearer child first, so a near
// hit found early cuts the far subtrees; lanes step through boxes together
// and test leaves together);
// the rays are walked in direction-cell order, so the 32 walks of a warp
// stay coherent whatever order the caller's rays come in: the wrapper sorts
// the ray indices by the octahedral cell of each direction (ray_order.cu, a
// counting sort in one memset and two kernels), thread i traces ray
// order[i] and leaves its outputs in slot i, one 16-byte record (and its
// faces), and walk_put_back_kernel gathers each ray's record back to the
// ray's own index, so each output keeps its bits. Writing the outputs at
// order[i] from the walk instead scatters 4-byte stores over 68 MB at
// 5,242,880 rays, and measured 0.86-0.90 ms slower than the walk and the
// gather together (PERF.md); every table is read through
// `const __restrict__` pointers so the loads can use the read-only path; the
// face record is (B, N) int32, so a warp's writes for one bounce are
// contiguous.
//
// Measured on the card and not kept (PERF.md has the times): a persistent
// grid whose warps take new rays from a global counter once half their lanes
// idle (the refilled lanes walk from the root while their neighbours are deep
// in the tree, and the coherence lost costs what the full warps gain), an
// access-policy window that keeps the node table resident in the L2, and
// blocks of 64 or 256 threads.
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
// The icosphere receiver (rfx_fused_trace_ico): each bounce first runs the
// bounding-sphere cull of the brute closest hit (brute_hit.cuh:cull_pass,
// center rx and radius r), about 30 operations; only a ray that passes it runs
// the 80 Moller-Trumbore tests (brute_hit.cuh:mt_t, t window (1e-4, 1e6)) in
// ascending face order and keeps the smallest t, the t of the brute closest
// hit's first smallest face (rfx_torch.ops.intersect.ray_mesh_closest_hit_brute).
// Face f is formed in the kernel from the unit table
// (rfx_torch.ops.intersect.unit_icosphere_tris, (80, 9), read through the
// read-only path) as icosphere_tris forms it: v0 = unit_v0 * r + rx, e1 =
// unit_e1 * r, e2 = unit_e2 * r, the same bits without contraction. Of the
// bench request's 5,242,880 rays 4,095 pass the cull of its 1.0-m receiver at
// the first bounce (fewer at the CIR cells' 0.1 m), and in direction-cell
// order those rays share few warps, so the tests run in a function of their
// own (__noinline__) and the walk keeps its registers (48, as the analytic
// instantiation's); lanes that pass nothing wait at the call, and no vote is
// taken, since lanes of one warp are at different bounces or have left the
// loop.
//
// Rounding: the source is built with -fmad=false (rfx_torch/ops/_build.py),
// so every product and sum rounds as PyTorch's elementwise operations do in
// the plain version (rfx_torch/ops/fused.py:fused_trace_plain); a contracted
// multiply-add can flip the Moller-Trumbore edge tests of a grazing ray.
// Division and sqrt are IEEE (no --use_fast_math).

#include <cuda_runtime.h>

#include "brute_hit.cuh"
#include "bvh_walk.cuh"

namespace {

using rfx::kMiss;
using rfx::kMissThreshold;
using rfx::kTMin;

constexpr int kThreads = 128;
constexpr int kPutBackThreads = 256;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kStatsPerBounce = 4;  // nodes, leaves, tris, warp_steps

// What every ray of a launch shares, gathered from the kernel's arguments
// (which stay `const __restrict__` pointers, so the tables' loads can take the
// read-only path). tri_face is null unless the face record is asked for;
// pairs is null where the launch walks in preorder.
struct Scene {
  const float4* nodes;
  int n_nodes;
  const float4* pairs;
  const float4* tris;
  const int* tri_face;
  float n1, n2;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float amp = 1.0f, dist = 0.0f;
  bool capt = false;
  float camp = 0.0f, cdist = 0.0f;
  int nb = 0;
};

// The receivers: t_rx(r), the ray's t at the receiver, kMiss on a miss.

// The analytic receiver sphere (rfx.ops.intersect.ray_sphere_hit) about
// (cx, cy, cz), r2 its radius squared in f32.
struct AnalyticSphere {
  float cx, cy, cz, r2;

  __device__ __forceinline__ float t_rx(const Ray& r) const {
    const float ocx = r.ox - cx, ocy = r.oy - cy, ocz = r.oz - cz;
    const float bq = ocx * r.dx + ocy * r.dy + ocz * r.dz;
    const float cq = ocx * ocx + ocy * ocy + ocz * ocz - r2;
    const float disc = bq * bq - cq;
    float t = kMiss;
    if (disc > 0.0f) {
      const float sq = sqrtf(disc);
      const float t0 = -bq - sq;
      const float t1 = -bq + sq;
      t = t0 > kTMin ? t0 : (t1 > kTMin ? t1 : kMiss);
    }
    return t;
  }
};

// The smallest t of the ray over the 80 faces of the icosphere of radius
// `radius` about (cx, cy, cz), formed from the unit faces `unit` ((80, 9):
// v0, e1, e2) by ico_face, in ascending face order; kMiss where no face is
// hit.
__device__ __noinline__ float icosphere_t(const rfx_brute::Ray q, const float* unit, float cx,
                                          float cy, float cz, float radius) {
  float best = kMiss;
  for (int f = 0; f < rfx_brute::kIcoFaces; ++f) {
    float tri[rfx_brute::kTriFloats];
    rfx_brute::ico_face(unit, f, cx, cy, cz, radius, tri);
    best = fminf(best, rfx_brute::mt_t(q, tri, rfx_brute::kTMin, rfx_brute::kTMax));
  }
  return best;
}

// The reference's 80-face icosphere receiver about (cx, cy, cz): the cull,
// then, where the ray passes it, the 80 tests (icosphere_t).
struct Icosphere {
  const float* unit;  // (80, 9) f32, the unit icosphere's faces
  float cx, cy, cz, radius;

  __device__ __forceinline__ float t_rx(const Ray& r) const {
    const rfx_brute::Ray q{r.ox, r.oy, r.oz, r.dx, r.dy, r.dz};
    if (!rfx_brute::cull_pass(q, cx, cy, cz, radius)) return kMiss;
    return icosphere_t(q, unit, cx, cy, cz, radius);
  }
};

// The walks: the closest hit's t of the ray over the scene, and its padded
// triangle in *best.

// The preorder walk over the preorder table, counted by `counter`.
struct PreorderWalk {
  template <class Counter>
  __device__ __forceinline__ static float closest_hit(const Ray& r, const Scene& s, int* best,
                                                      Counter& counter) {
    return rfx::bvh_closest_hit(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, s.nodes, s.n_nodes, s.tris,
                                best, counter);
  }
};

// The near-first walk over the child-pair table (uncounted).
struct NearFirstWalk {
  __device__ __forceinline__ static float closest_hit(const Ray& r, const Scene& s, int* best,
                                                      rfx::NoCount&) {
    return rfx::bvh_closest_hit_near_first(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, s.pairs, s.tris,
                                           best);
  }
};

// One bounce of one ray; false when the ray is captured or escapes. `faces`
// is null unless the face record is asked for.
template <class Walk, class Counter, class Receiver>
__device__ __forceinline__ bool bounce(Ray& r, const Scene& s, const Receiver& rx, int b, int ray,
                                       int n, int* __restrict__ faces, Counter& counter) {
  int best;
  const float t_best = Walk::closest_hit(r, s, &best, counter);
  const float t_rx = rx.t_rx(r);

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

// -1 in the face record's rows of the bounces the ray did not make.
__device__ __forceinline__ void fill_unbounced(const Ray& r, int slot, int n, int max_bounces,
                                               int* __restrict__ faces) {
  if (faces != nullptr) {
    for (int b = r.nb; b < max_bounces; ++b) faces[static_cast<size_t>(b) * n + slot] = -1;
  }
}

__device__ __forceinline__ void store(const Ray& r, int ray, int n, int max_bounces,
                                      bool* __restrict__ captured, float* __restrict__ cap_amp,
                                      float* __restrict__ cap_dist, int* __restrict__ num_bounces,
                                      int* __restrict__ faces) {
  fill_unbounced(r, ray, n, max_bounces, faces);
  captured[ray] = r.capt;
  cap_amp[ray] = r.camp;
  cap_dist[ray] = r.cdist;
  num_bounces[ray] = r.nb;
}

template <class Receiver, class Walk>
__global__ void __launch_bounds__(kThreads) fused_trace_kernel(
    const float* __restrict__ dirs, int n,
    const float4* __restrict__ nodes, int n_nodes, const float4* __restrict__ pairs,
    const float4* __restrict__ tris, const int* __restrict__ tri_face,
    float tx0, float tx1, float tx2, const Receiver rx, float n1, float n2, int max_bounces,
    bool* __restrict__ captured, float* __restrict__ cap_amp,
    float* __restrict__ cap_dist, int* __restrict__ num_bounces, int* __restrict__ faces,
    const int* __restrict__ order, float4* __restrict__ walked) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int ray = order != nullptr ? order[i] : i;
  const Scene scene{nodes, n_nodes, pairs, tris, tri_face, n1, n2};
  Ray r = ray_from(dirs, ray, tx0, tx1, tx2);
  rfx::NoCount counter;
  // The face record goes to slot i: the ray's own index in the caller's
  // order, the walk's scratch in cell order.
  for (int b = 0; b < max_bounces; ++b) {
    if (!bounce<Walk>(r, scene, rx, b, i, n, faces, counter)) break;
  }
  if (walked == nullptr) {
    store(r, i, n, max_bounces, captured, cap_amp, cap_dist, num_bounces, faces);
    return;
  }
  fill_unbounced(r, i, n, max_bounces, faces);
  walked[i] = make_float4(r.camp, r.cdist, __int_as_float(r.nb), __int_as_float(r.capt ? 1 : 0));
}

// Cell order's outputs back at each ray's own index: ray i's record is the
// walk's slot rank[i]. A gather, so every write is coalesced and each ray
// reads one 16-byte record (and its faces) from where the walk left it.
__global__ void __launch_bounds__(kPutBackThreads) walk_put_back_kernel(
    const float4* __restrict__ walked, const int* __restrict__ walked_faces,
    const int* __restrict__ rank, int n, int max_bounces, bool* __restrict__ captured,
    float* __restrict__ cap_amp, float* __restrict__ cap_dist, int* __restrict__ num_bounces,
    int* __restrict__ faces) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int j = rank[i];
  const float4 q = walked[j];
  captured[i] = __float_as_int(q.w) != 0;
  cap_amp[i] = q.x;
  cap_dist[i] = q.y;
  num_bounces[i] = __float_as_int(q.z);
  if (faces != nullptr) {
    for (int b = 0; b < max_bounces; ++b) {
      faces[static_cast<size_t>(b) * n + i] = walked_faces[static_cast<size_t>(b) * n + j];
    }
  }
}

// stats is (max_bounces, kStatsPerBounce) unsigned 64-bit, zeroed by the
// caller; dynamic shared memory holds the block's copy of it.
__global__ void __launch_bounds__(kThreads) fused_trace_counted_kernel(
    const float* __restrict__ dirs, int n,
    const float4* __restrict__ nodes, int n_nodes, const float4* __restrict__ tris,
    const int* __restrict__ tri_face,
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
  const Scene scene{nodes, n_nodes, nullptr, tris, tri_face, n1, n2};
  const AnalyticSphere rx{rx0, rx1, rx2, r2};
  Ray r;
  if (live) r = ray_from(dirs, ray, tx0, tx1, tx2);
  for (int b = 0; b < max_bounces; ++b) {
    rfx::WalkCount counter;
    if (live) live = bounce<PreorderWalk>(r, scene, rx, b, ray, n, faces, counter);
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

// The launch of fused_trace_kernel with the receiver rx and the walk the
// tables allow (near-first where pairs is given), then, in cell order, of
// walk_put_back_kernel.
template <class Receiver>
int launch(const void* dirs, int n, const void* nodes, int n_nodes, const void* tris,
           const void* tri_face, float tx0, float tx1, float tx2, const Receiver& rx, float n1,
           float n2, int max_bounces, void* captured, void* cap_amp, void* cap_dist,
           void* num_bounces, void* faces, const void* order, const void* rank, void* walked,
           void* walked_faces, const void* pairs, void* stream) {
  if (n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool ordered = order != nullptr;
    const int blocks = (n + kThreads - 1) / kThreads;
    auto trace = pairs != nullptr ? &fused_trace_kernel<Receiver, NearFirstWalk>
                                  : &fused_trace_kernel<Receiver, PreorderWalk>;
    trace<<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(dirs), n, static_cast<const float4*>(nodes), n_nodes,
        static_cast<const float4*>(pairs), static_cast<const float4*>(tris),
        static_cast<const int*>(tri_face), tx0, tx1, tx2, rx, n1, n2, max_bounces,
        static_cast<bool*>(captured), static_cast<float*>(cap_amp), static_cast<float*>(cap_dist),
        static_cast<int*>(num_bounces), static_cast<int*>(ordered ? walked_faces : faces),
        static_cast<const int*>(order), ordered ? static_cast<float4*>(walked) : nullptr);
    if (ordered) {
      walk_put_back_kernel<<<(n + kPutBackThreads - 1) / kPutBackThreads, kPutBackThreads, 0, s>>>(
          static_cast<const float4*>(walked), static_cast<const int*>(walked_faces),
          static_cast<const int*>(rank), n, max_bounces, static_cast<bool*>(captured),
          static_cast<float*>(cap_amp), static_cast<float*>(cap_dist),
          static_cast<int*>(num_bounces), static_cast<int*>(faces));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tri_face and faces may be null (no face record); faces is (max_bounces, n).
// order and rank may be null (the caller's order), or an (n,) int32
// permutation and its inverse (rfx_ray_order): thread i then traces ray
// order[i] into slot i of walked, (n,) float4 records (amplitude, distance,
// bounces, captured), and of walked_faces, (max_bounces, n) int32 where faces
// are recorded, and walk_put_back_kernel puts them back at each ray's index.
// pairs is null (the preorder walk over nodes) or the tree's child-pair
// table, (n_internal, 16) f32, whose tree has at most kNearFirstStack + 1
// levels (the near-first walk). The receiver is the analytic sphere about
// (rx0, rx1, rx2), r2 its radius squared.
extern "C" int rfx_fused_trace(
    const void* dirs, int n, const void* nodes, int n_nodes, const void* tris,
    const void* tri_face, float tx0, float tx1, float tx2,
    float rx0, float rx1, float rx2, float r2, float n1, float n2,
    int max_bounces, void* captured, void* cap_amp, void* cap_dist,
    void* num_bounces, void* faces, const void* order, const void* rank, void* walked,
    void* walked_faces, const void* pairs, void* stream) {
  return launch(dirs, n, nodes, n_nodes, tris, tri_face, tx0, tx1, tx2,
                AnalyticSphere{rx0, rx1, rx2, r2}, n1, n2, max_bounces, captured, cap_amp,
                cap_dist, num_bounces, faces, order, rank, walked, walked_faces, pairs, stream);
}

// rfx_fused_trace with the reference's 80-face icosphere receiver of radius
// `radius` about (rx0, rx1, rx2): unit is the (80, 9) f32 unit icosphere on
// the device (rfx_torch.ops.intersect.unit_icosphere_tris); pairs as there.
extern "C" int rfx_fused_trace_ico(
    const void* dirs, int n, const void* nodes, int n_nodes, const void* tris,
    const void* tri_face, float tx0, float tx1, float tx2,
    float rx0, float rx1, float rx2, float radius, float n1, float n2,
    int max_bounces, void* captured, void* cap_amp, void* cap_dist,
    void* num_bounces, void* faces, const void* order, const void* rank, void* walked,
    void* walked_faces, const void* pairs, const void* unit, void* stream) {
  return launch(dirs, n, nodes, n_nodes, tris, tri_face, tx0, tx1, tx2,
                Icosphere{static_cast<const float*>(unit), rx0, rx1, rx2, radius}, n1, n2,
                max_bounces, captured, cap_amp, cap_dist, num_bounces, faces, order, rank, walked,
                walked_faces, pairs, stream);
}

// The counted instantiation: as rfx_fused_trace, and adds each bounce's
// (nodes, leaves, tris, warp_steps) to stats, (max_bounces, 4) unsigned
// 64-bit that the caller has zeroed.
extern "C" int rfx_fused_trace_counted(
    const void* dirs, int n, const void* nodes, int n_nodes, const void* tris,
    const void* tri_face, float tx0, float tx1, float tx2,
    float rx0, float rx1, float rx2, float r2, float n1, float n2,
    int max_bounces, void* captured, void* cap_amp, void* cap_dist,
    void* num_bounces, void* faces, void* stats, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    const size_t shared = sizeof(unsigned long long) * kStatsPerBounce * max_bounces;
    fused_trace_counted_kernel<<<blocks, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(dirs), n, static_cast<const float4*>(nodes), n_nodes,
        static_cast<const float4*>(tris), static_cast<const int*>(tri_face), tx0, tx1, tx2, rx0,
        rx1, rx2, r2, n1, n2, max_bounces, static_cast<bool*>(captured),
        static_cast<float*>(cap_amp), static_cast<float*>(cap_dist),
        static_cast<int*>(num_bounces), static_cast<int*>(faces),
        static_cast<unsigned long long*>(stats));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rfx_fused_trace_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* rfx_fused_trace_counted_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* rfx_fused_trace_ico_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
