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
// selected face's closed-form t (rfx_torch/ops/intersect.py:_BruteHit), which
// stays elementwise PyTorch.
//
// What bounds it on an H100: the tests, about 55 f32 operations each (an
// instruction each without contraction): 5,242,880 rays against the 12-face
// room are 3.5e9 operations, 0.05 ms at 67 TFLOP/s, against 0.05 ms of
// reading 24 and writing 8 bytes a ray. The receiver icosphere has 80 faces,
// but a ray whose line passes outside the bounding sphere's reach (the
// cull, given the center and radius) tests none: at the bench workload
// about one ray in 10^4 passes, so the receiver's query is bound by the
// rays' bytes and the cull's ~30 operations a ray.
//
// The design: a thread a ray, its origin and direction in registers; the
// triangles staged through shared memory in tiles of 256 (9 KB as v0, e1,
// e2), so any count works; a block whose rays the cull rejects all stages
// nothing. Each thread tests the tile's faces in ascending order and keeps
// the first smallest t (strict <), so its face is torch.argmin's.
//
// Not carried over from the TPU: nothing; rfx runs this as XLA's fusion of
// the (chunk, T) broadcast.

#include <cuda_runtime.h>

#include "brute_hit.cuh"

namespace {

using namespace rfx_brute;

constexpr int kThreads = 256;   // rays a block, one a thread
constexpr int kTileTris = 256;  // triangles staged in shared memory at once

__global__ void __launch_bounds__(kThreads) brute_hit_kernel(
    const float* __restrict__ o, const float* __restrict__ d, int n,
    const float* __restrict__ tris, int n_tris, float t_min, float t_max,
    const float* __restrict__ cull, float* __restrict__ t_out, int* __restrict__ face_out) {
  __shared__ float s_tri[kTileTris * kTriFloats];
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
    for (int base = 0; base < n_tris; base += kTileTris) {
      const int count = min(kTileTris, n_tris - base);
      __syncthreads();  // the last tile is read no more
      const float* src = tris + static_cast<long long>(base) * kTriFloats;
      for (int k = threadIdx.x; k < count * kTriFloats; k += kThreads) s_tri[k] = src[k];
      __syncthreads();
      if (test) {
        for (int f = 0; f < count; ++f) {
          const float t = mt_t(r, s_tri + kTriFloats * f, t_min, t_max);
          if (t < best) {
            best = t;
            face = base + f;
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

// o, d: (n, 3) f32; tris: (n_tris, 9) f32, each row v0, e1, e2; cull: null,
// or 4 f32 on the device (cx, cy, cz, r), the bounding sphere of an
// icosphere whose vertices are unit * r + c (brute_hit.cuh). t_out: (n,) f32,
// face_out: (n,) int32, every element written. n, n_tris >= 1.
extern "C" int rfx_brute_hit(const void* o, const void* d, int n, const void* tris, int n_tris,
                             float t_min, float t_max, const void* cull, void* t_out,
                             void* face_out, void* stream) {
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(n) + kThreads - 1) / kThreads);
  brute_hit_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d), n,
      static_cast<const float*>(tris), n_tris, t_min, t_max, static_cast<const float*>(cull),
      static_cast<float*>(t_out), static_cast<int*>(face_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rfx_brute_hit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
