// Brute closest hit: the Moller-Trumbore test of every ray against every
// triangle of a short list, one thread a ray.
//
// Replaces the XLA program of rfx/ops/intersect.py:75-113 (_mt_chunk under
// ray_mesh_closest_hit_brute, rfx/ops/intersect.py:132): t of each ray's
// closest hit (1e30 on a miss) and its face (-1), t_min 1e-4 < t < t_max
// 1e6, ties to the lowest face index. It serves the facade's `brute`
// environment backend (meshes of at most 2,048 faces, such as the 12-face
// room) and the scan tracer's icosphere receiver (the reference's 80-face
// receiver, rfx/tracer.py:87-104); the test and the cull are brute_hit.cuh's,
// shared with the map engine's icosphere capture pass. The gradient is the
// selected face's closed-form t (rfx_torch/ops/intersect.py:_ClosestHit), which
// stays elementwise PyTorch.
//
// What bounds it on an H100: the tests, 54 f32 operations each (an
// instruction each without contraction) and the hit rule's compares and
// selects: 2,097,152 queries of the room's coverage trace against its 12
// faces are 1.36e9 operations, 0.02 ms at 67 TFLOP/s, but about 85
// instructions a test issue in ~0.07 ms on 528 schedulers. The receiver
// icosphere has 80 faces, but a ray whose line passes outside the bounding
// sphere's reach (the cull, given the center and radius) tests none: at the
// bench workload about one ray in 10^4 passes, so the receiver's query is
// bound by the rays' bytes and the cull's ~30 operations a ray.
//
// The design: a thread a ray, its origin and direction in registers; the
// triangles staged through shared memory in tiles of 256, each as three
// float4 (v0, e1, e2, each padded to 16 bytes: 12 KB a tile, three
// broadcast loads a test), so any count works; a block whose rays the cull
// rejects all stages nothing, and a warp none of whose rays passes it skips
// the tests. Each test runs in two halves (brute_hit.cuh: mt_head, then
// mt_tail): after u the warp votes, and where no lane's test can still
// accept (|det| <= 1e-12, u outside [0, 1] or NaN: u + v rounds to at least
// u where v >= 0, so those pairs are rejected whatever v is) the warp skips
// q, v, t and the hit rule for that face. The skip drops no hit and changes
// no operation of a test that runs. Each thread tests the tile's faces in
// ascending order and keeps the first smallest t (strict <), so its face is
// torch.argmin's.
//
// Not carried over from the TPU: nothing; rfx runs this as XLA's fusion of
// the (chunk, T) broadcast.

#include <cuda_runtime.h>

#include "brute_hit.cuh"

namespace {

using namespace rfx_brute;

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kThreads = 256;   // rays a block, one a thread
constexpr int kTileTris = 256;  // triangles staged in shared memory at once

__global__ void __launch_bounds__(kThreads) brute_hit_kernel(
    const float* __restrict__ o, const float* __restrict__ d, int n,
    const float4* __restrict__ tris, int n_tris, float t_min, float t_max,
    const float* __restrict__ cull, float* __restrict__ t_out, int* __restrict__ face_out) {
  __shared__ float4 s_tri[kTileTris * 3];  // a face: v0, e1, e2, each with a pad lane
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool in = i < n;
  Ray r{};
  if (in) {
    r.ox = o[3 * i];
    r.oy = o[3 * i + 1];
    r.oz = o[3 * i + 2];
    r.dx = d[3 * i];
    r.dy = d[3 * i + 1];
    r.dz = d[3 * i + 2];
  }
  const bool test = in && (cull == nullptr || cull_pass(r, cull[0], cull[1], cull[2], cull[3]));
  float best = kMiss;
  int face = -1;
  if (__syncthreads_or(test)) {
    const bool warp_tests = __any_sync(kFullWarp, test);
    for (int base = 0; base < n_tris; base += kTileTris) {
      const int count = min(kTileTris, n_tris - base);
      __syncthreads();  // the last tile is read no more
      const float4* src = tris + 3 * static_cast<long long>(base);
      for (int k = threadIdx.x; k < 3 * count; k += kThreads) s_tri[k] = src[k];
      __syncthreads();
      if (warp_tests) {  // every lane of the warp runs the loop and reaches its votes
        for (int f = 0; f < count; ++f) {
          const float4 v0 = s_tri[3 * f], e1 = s_tri[3 * f + 1], e2 = s_tri[3 * f + 2];
          const MtHead h = mt_head(r, v0.x, v0.y, v0.z, e1.x, e1.y, e1.z, e2.x, e2.y, e2.z);
          if (__any_sync(kFullWarp, test && mt_may_hit(h))) {
            const float t = mt_tail(r, h, e1.x, e1.y, e1.z, e2.x, e2.y, e2.z, t_min, t_max);
            if (test && t < best) {
              best = t;
              face = base + f;
            }
          }
        }
      }
    }
  }
  if (!(best < kMissThreshold)) face = -1;
  if (in) {
    t_out[i] = best;
    face_out[i] = face;
  }
}

}  // namespace

// o, d: (n, 3) f32; tris: (n_tris, 12) f32, 16-byte aligned, each row v0,
// 0, e1, 0, e2, 0 (the kernel's own layout: three float4 a face;
// rfx_torch.ops.intersect.brute_hit builds it); cull: null, or 4 f32 on the
// device (cx, cy, cz, r), the bounding sphere of an icosphere whose vertices
// are unit * r + c (brute_hit.cuh). t_out: (n,) f32, face_out: (n,) int32,
// every element written. n, n_tris >= 1.
extern "C" int rfx_brute_hit(const void* o, const void* d, int n, const void* tris, int n_tris,
                             float t_min, float t_max, const void* cull, void* t_out,
                             void* face_out, void* stream) {
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(n) + kThreads - 1) / kThreads);
  brute_hit_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d), n,
      static_cast<const float4*>(tris), n_tris, t_min, t_max, static_cast<const float*>(cull),
      static_cast<float*>(t_out), static_cast<int*>(face_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rfx_brute_hit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
