// Per-query closest hit: one thread per ray, from arbitrary origins.
//
// Replaces rfx/ops/pallas_trace.py:_kernel, the TPU kernel launched by
// _pallas_hit_tiled (via pallas_hit_planes / pallas_closest_hit /
// make_pallas_env_hit): one closest-hit query per ray, returning t, the
// padded-triangle index, the original face id and the unit normal of the
// hit; a miss gives 1e30 / -1 / -1 / (0, 0, 0) (:117-119). It serves the
// bounce-loop tracers that need a per-bounce query (the scan tracer's
// gradients, recorded paths, the icosphere receiver, the coverage engine's
// env trace). The walk is rfx::bvh_closest_hit (bvh_walk.cuh), the same
// function the fused bounce-loop kernel runs, so the two agree on every hit.
// A ray parked far outside the scene (|o| ~ 1e9) misses the root box and
// stops at once.
//
// The triangle table is either the packed one or a live repack from the
// caller's vertices (rfx_torch.ops.bvh_trace.live_tri, differentiable
// triangles); the normal returned is that table's lanes 9-11. The node boxes
// stay the host-built ones either way, as in the reference
// (pallas_trace.py:735-738).
//
// Not carried over from the TPU kernel: the per-tile cone table, the
// tile-uniform walk, the k_spec node windows and HBM streaming, which exist
// because a TPU core has no per-lane control flow or lane-dynamic loads.
//
// What bounds it on an H100: the latency of the longest walks of the grid.
// The dependent node and triangle loads along a walk are L2 round trips (the
// 32,258-triangle bench terrain is about 0.2 MB of nodes and 2.6 MB of
// triangles, far inside the 50 MB L2) and a query does little arithmetic per
// visit. The counted entry point (`rfx_closest_hit_counted`, the WalkCount
// instantiation of the same kernel: per query the nodes visited, the leaves
// entered, the triangles tested) shows it: 65,536 rays from the transmitter
// visit 7.5 nodes on average and 87 at most, and the kernel takes as long as
// some 90 dependent round trips; second-bounce queries visit 37 on average
// and 313 at most, and a warp waits for its longest lane (mean of the
// per-warp maximum 57). Bytes and operations bound it 30-40 times lower. The
// rays' own traffic is 24 bytes in and 24 out.
//
// What the design does about it: the walk of bvh_walk.cuh (a node visit is
// two 16-byte loads of one 32-byte sector; lanes step through boxes together
// and test leaves together), with this kernel's own load policy: a leaf's
// triangles are loaded four at a time before the first test, which the fused
// trace cannot afford in registers and this kernel can (2-11% on eleven of
// twelve query sets, 2-7% slower on the first bounce at 1M rays and above).
// Callers pass Morton-ordered rays, so a warp's walks stay coherent; the
// tables are read through `const __restrict__` pointers. Measured and not
// kept (PERF.md has the times): a node loaded together with its preorder
// successor; 32, 64 and 256 threads a block; and, outside the kernel,
// compacted second-bounce queries sorted by origin (4% faster than in ray
// order) or left in place among parked lanes (4% slower): the order is not
// what costs the later bounces their time, the length of their walks is.

#include <cuda_runtime.h>

#include "bvh_walk.cuh"

namespace {

constexpr int kThreads = 128;

// This kernel's walk loads a leaf's triangles four at a time (bvh_walk.cuh).
struct QueryLoads {
  static constexpr int kLeafBatch = 4;
};

struct NoCounts {
  __device__ __forceinline__ void write(int, const rfx::NoCount&) const {}
};

// (n, 3) int32: nodes visited, leaves entered, triangles tested.
struct QueryCounts {
  int* out;
  __device__ __forceinline__ void write(int ray, const rfx::WalkCount& c) const {
    out[3 * ray] = static_cast<int>(c.nodes);
    out[3 * ray + 1] = static_cast<int>(c.leaves);
    out[3 * ray + 2] = static_cast<int>(c.tris);
  }
};

template <class Counter, class Counts>
__global__ void __launch_bounds__(kThreads) closest_hit_kernel(
    const float* __restrict__ orig, const float* __restrict__ dirs, int n,
    const float4* __restrict__ nodes, int n_nodes, const float4* __restrict__ tris,
    const int* __restrict__ tri_face,
    float* __restrict__ t_out, int* __restrict__ idx_out, int* __restrict__ face_out,
    float* __restrict__ nrm_out, Counts counts) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n) return;
  const float ox = orig[3 * ray], oy = orig[3 * ray + 1], oz = orig[3 * ray + 2];
  const float dx = dirs[3 * ray], dy = dirs[3 * ray + 1], dz = dirs[3 * ray + 2];
  int best;
  Counter counter;
  const float t = rfx::bvh_closest_hit<Counter, QueryLoads>(ox, oy, oz, dx, dy, dz, nodes,
                                                            n_nodes, tris, &best, counter);
  float nx = 0.0f, ny = 0.0f, nz = 0.0f;
  int face = -1;
  if (best >= 0) {
    const float4 e = tris[3 * best + 2];
    nx = e.y;
    ny = e.z;
    nz = e.w;
    face = tri_face[best];
  }
  t_out[ray] = t;
  idx_out[ray] = best;
  face_out[ray] = face;
  nrm_out[3 * ray] = nx;
  nrm_out[3 * ray + 1] = ny;
  nrm_out[3 * ray + 2] = nz;
  counts.write(ray, counter);
}

template <class Counter, class Counts>
int launch(const void* orig, const void* dirs, int n, const void* nodes, int n_nodes,
           const void* tris, const void* tri_face, void* t, void* idx, void* face, void* nrm,
           Counts counts, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    closest_hit_kernel<Counter, Counts><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(orig), static_cast<const float*>(dirs), n,
        static_cast<const float4*>(nodes), n_nodes, static_cast<const float4*>(tris),
        static_cast<const int*>(tri_face),
        static_cast<float*>(t), static_cast<int*>(idx), static_cast<int*>(face),
        static_cast<float*>(nrm), counts);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// orig, dirs: (n, 3) f32; tris: (P, 12) f32; tri_face: (P,) i32.
// Outputs: t (n,) f32, idx (n,) i32, face (n,) i32, nrm (n, 3) f32.
extern "C" int rfx_closest_hit(const void* orig, const void* dirs, int n, const void* nodes,
                               int n_nodes, const void* tris, const void* tri_face, void* t,
                               void* idx, void* face, void* nrm, void* stream) {
  return launch<rfx::NoCount>(orig, dirs, n, nodes, n_nodes, tris, tri_face, t, idx, face, nrm,
                              NoCounts{}, stream);
}

// The same kernel with the walk's counters: counts (n, 3) i32, per query the
// nodes visited, the leaves entered and the triangles tested.
extern "C" int rfx_closest_hit_counted(const void* orig, const void* dirs, int n,
                                       const void* nodes, int n_nodes, const void* tris,
                                       const void* tri_face, void* t, void* idx, void* face,
                                       void* nrm, void* counts, void* stream) {
  return launch<rfx::WalkCount>(orig, dirs, n, nodes, n_nodes, tris, tri_face, t, idx, face, nrm,
                                QueryCounts{static_cast<int*>(counts)}, stream);
}

extern "C" const char* rfx_closest_hit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* rfx_closest_hit_counted_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
