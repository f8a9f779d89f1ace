// The map engine's capture pass: for a chunk of receiver spheres, the first
// capture of each receiver along each ray's bounces, and its backward.
//
// Replaces the XLA program of rfx/coverage.py:56-81 (_rx_ir_from_segments,
// under the vmap / lax.map of :185-203) up to the histogram, with the custom
// VJP of the receiver sphere (rfx/ops/intersect.py:206-251) and what jax.grad
// takes through the capture's `where`s and the histogram's scatter. Per
// receiver r and segment (b, n): the analytic sphere hit t_rx, a capture
// where the segment is alive, t_rx < 1e29 and t_env > t_rx, and the first
// capture along the bounce axis ends the receiver's view of the ray
// (sphere.cuh: the device code of the coverage kernels).
//
// rfx_map_capture (forward) writes what the IR histogram (histogram.cu,
// K-H) takes: for each receiver a row of B x N entries in the (b, n) order
// of the segments, amp * scale and dist + t_rx at the captures and 0
// elsewhere, and the capture mask. So the histogram sees the plain map
// engine's rows bit for bit (rfx_torch/ops/map_capture.py:map_capture_plain)
// and the IRs are its bits. Nothing of size (R, B, N) is kept for the
// backward: it finds the captures again.
//
// rfx_map_capture_backward, given the IRs' cotangent g (R, nbins), adds for
// each capture (r, b, n), with delay = (dist + t_rx) / c * rate as K-H bins
// it:
//   hard: g_a = g[r, int(delay)] (0 outside the window), g_dist = 0;
//   soft: lo = floor(delay), w = delay - lo,
//         g_a = (1 - w) g[r, lo] + w g[r, lo + 1],
//         g_dist = amp scale (g[r, lo + 1] - g[r, lo]) rate / c;
// g_amplitude += g_a scale, g_distance += g_dist, and through the sphere's
// implicit-function derivative, with q = o + t_rx d - C and q.d clamped away
// from 0 at qd_floor = 1e-6 max(radius, 1e-6) (the clamp of
// rfx_torch/ops/intersect.py:_SphereHit), gg = g_dist / q.d:
// g_origin += -gg q, g_direction += -(gg t_rx) q, and the receiver's center
// gains gg q. A segment's sums run over the receivers in ascending order from
// +0, with no atomics: the same bits from run to run, and the plain
// version's (map_capture_backward_plain) expressions in its order. The
// centers' gradient, where asked for, is per-block partials (the block's rays
// summed in thread order) added in block order. So are, where asked for, the
// sums that the gradients in scale and radius take, over every capture:
// g_a amp (d IR / d scale) and gg (d IR / d radius is their sum times the
// radius, the sphere's dt/dr = r / q.d); these add each f32 term in double,
// so that their order hardly shows in the f32 result.
//
// What bounds them on an H100: the sphere tests (R x B x N, 268,435,456 at
// the inverse solve's 64 receivers x 4 bounces x 1,048,576 rays, ~17 f32
// operations each, an instruction each without contraction), and for the
// forward the dense rows it writes, 9 bytes an entry (2.4 GB at that shape).
// The design is the simple one: a thread a ray, its bounces in order, the
// receivers' centers broadcast from shared memory, a bit mask a tile of 32
// receivers for the first-capture rule; the forward's stores coalesce across
// the threads of a warp (neighbouring rays), and the backward touches its
// ray's outputs only where a tile captured at that bounce. A compact record
// for K-H in place of the dense rows, and holding a ray's bounces in
// registers across tiles, are left for a later change.
//
// Not carried over from the TPU: nothing; rfx runs this as XLA's fusion of
// the broadcast.

#include <cuda_runtime.h>

#include "sphere.cuh"

namespace {

using namespace rfx_capture;  // sphere_capture, delay_bin, Segment

constexpr int kThreads = 256;      // rays of a forward block, one a thread
constexpr int kTile = 32;          // receivers a tile: one bit each in `done`
constexpr int kBackThreads = 128;  // rays of a backward block, one a thread
constexpr int kStage = 512;        // centers the backward stages in shared memory at once
constexpr int kGcStride = kBackThreads + 1;  // a row of the centers' scratch, padded

// The geometry and life of segment `at`; t_env too, the rest on a capture.
__device__ __forceinline__ Segment load_geometry(const float* __restrict__ origin,
                                                 const float* __restrict__ dir,
                                                 const float* __restrict__ t_env,
                                                 const bool* __restrict__ alive, long long at) {
  Segment s;
  s.ox = origin[3 * at];
  s.oy = origin[3 * at + 1];
  s.oz = origin[3 * at + 2];
  s.dx = dir[3 * at];
  s.dy = dir[3 * at + 1];
  s.dz = dir[3 * at + 2];
  s.te = t_env[at];
  s.dist = 0.0f;
  s.amp = 0.0f;
  s.live = alive[at];
  return s;
}

// A block: kThreads rays x the kTile receivers of blockIdx.y. Every entry of
// the block's rows is written.
__global__ void __launch_bounds__(kThreads) map_capture_kernel(
    const float* __restrict__ origin, const float* __restrict__ dir,
    const float* __restrict__ t_env, const float* __restrict__ amp,
    const float* __restrict__ dist, const bool* __restrict__ alive, int nb, int n,
    const float* __restrict__ centers, int m, float r2, float scale,
    float* __restrict__ out_amp, float* __restrict__ out_dist, bool* __restrict__ out_cap) {
  __shared__ float4 s_ctr[kTile];
  const int r0 = blockIdx.y * kTile;
  const int tile = min(kTile, m - r0);
  if (threadIdx.x < tile) {
    const long long r = r0 + threadIdx.x;
    s_ctr[threadIdx.x] = make_float4(centers[3 * r], centers[3 * r + 1], centers[3 * r + 2], 0.0f);
  }
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long row = static_cast<long long>(nb) * n;
  unsigned done = 0u;
  for (int b = 0; b < nb; ++b) {
    const long long at = static_cast<long long>(b) * n + i;
    Segment s = load_geometry(origin, dir, t_env, alive, at);
    s.amp = amp[at];
    s.dist = dist[at];
    for (int q = 0; q < tile; ++q) {
      float t_rx = 0.0f;
      const bool cap = s.live && !((done >> q) & 1u) && sphere_capture(s, s_ctr[q], r2, t_rx);
      done |= cap ? 1u << q : 0u;
      const long long out = (r0 + q) * row + at;
      out_amp[out] = cap ? s.amp * scale : 0.0f;
      out_dist[out] = cap ? s.dist + t_rx : 0.0f;
      out_cap[out] = cap;
    }
  }
}

struct BackArgs {
  const float* amp;
  const float* dist;
  const float* g;  // (m, nbins)
  float r2, scale, c, rate, qd_floor;
  int nbins;
  bool soft;
  double* sums_partials;  // null, or (blocks, 2): a block's sums of g_a amp and gg
};

// A thread a ray: its outputs zeroed, then for each tile of kTile receivers
// its bounces in order, the tile's receivers in ascending order at each; a
// bounce with a capture reads its sums, adds the captures' terms and writes
// them back. kCenters: each capture's gg q goes to the block's scratch, which
// the block sums per receiver in thread order after the tile. Every capture's
// g_a amp and gg add to the thread's sums, which the block adds in thread
// order at the end where a.sums_partials asks for them.
template <bool kCenters>
__global__ void __launch_bounds__(kBackThreads) map_capture_backward_kernel(
    const float* __restrict__ origin, const float* __restrict__ dir,
    const float* __restrict__ t_env, const bool* __restrict__ alive, int nb, int n,
    const float* __restrict__ centers, int m, BackArgs a, float* __restrict__ g_origin,
    float* __restrict__ g_dir, float* __restrict__ g_amp, float* __restrict__ g_dist,
    float* __restrict__ gc_partials) {
  __shared__ float4 s_ctr[kStage];
  __shared__ double s_sums[2][kBackThreads];
  extern __shared__ float s_gc[];  // kCenters: (kTile * 3) rows of kGcStride
  const int tid = threadIdx.x;
  double sum_amp = 0.0, sum_gg = 0.0;
  const long long i = static_cast<long long>(blockIdx.x) * kBackThreads + tid;
  const bool in = i < n;
  if (in) {
    for (int b = 0; b < nb; ++b) {
      const long long at = static_cast<long long>(b) * n + i;
      for (int k = 0; k < 3; ++k) {
        g_origin[3 * at + k] = 0.0f;
        g_dir[3 * at + k] = 0.0f;
      }
      g_amp[at] = 0.0f;
      g_dist[at] = 0.0f;
    }
  }
  for (int s0 = 0; s0 < m; s0 += kStage) {
    const int staged = min(kStage, m - s0);
    __syncthreads();  // the last stage's centers are read no more
    for (int k = tid; k < staged; k += kBackThreads) {
      const long long r = s0 + k;
      s_ctr[k] = make_float4(centers[3 * r], centers[3 * r + 1], centers[3 * r + 2], 0.0f);
    }
    __syncthreads();
    for (int q0 = 0; q0 < staged; q0 += kTile) {
      const int tile = min(kTile, staged - q0);
      if (kCenters) {
        for (int j = 0; j < 3 * kTile; ++j) s_gc[j * kGcStride + tid] = 0.0f;
      }
      unsigned done = 0u;
      for (int b = 0; in && b < nb; ++b) {
        const long long at = static_cast<long long>(b) * n + i;
        Segment s = load_geometry(origin, dir, t_env, alive, at);
        if (!s.live) continue;
        bool any = false;
        float acc_o[3], acc_d[3], acc_a = 0.0f, acc_dist = 0.0f;
        for (int q = 0; q < tile; ++q) {
          if ((done >> q) & 1u) continue;
          const float4 ctr = s_ctr[q0 + q];
          float t;
          if (!sphere_capture(s, ctr, a.r2, t)) continue;
          done |= 1u << q;
          if (!any) {
            any = true;
            s.amp = a.amp[at];
            s.dist = a.dist[at];
            for (int k = 0; k < 3; ++k) {
              acc_o[k] = g_origin[3 * at + k];
              acc_d[k] = g_dir[3 * at + k];
            }
            acc_a = g_amp[at];
            acc_dist = g_dist[at];
          }
          const float* gr = a.g + static_cast<long long>(s0 + q0 + q) * a.nbins;
          const float delay = (s.dist + t) / a.c * a.rate;
          float ga;
          if (!a.soft) {
            const int k = delay_bin(delay);
            ga = (k >= 0 && k < a.nbins) ? gr[k] : 0.0f;
            acc_a = acc_a + ga * a.scale;
            sum_amp += static_cast<double>(ga * s.amp);
            continue;
          }
          const float lo = floorf(delay);
          const float w = delay - lo;
          float g_lo = 0.0f, g_hi = 0.0f;
          if (lo >= -1.0f && lo < 2147483647.0f) {
            const int k = static_cast<int>(lo);
            if (k >= 0 && k < a.nbins) g_lo = gr[k];
            if (k + 1 < a.nbins) g_hi = gr[k + 1];
          }
          ga = (1.0f - w) * g_lo + w * g_hi;
          const float amp_row = s.amp * a.scale;
          const float gd = amp_row * (g_hi - g_lo) * a.rate / a.c;
          acc_a = acc_a + ga * a.scale;
          acc_dist = acc_dist + gd;
          const float qv[3] = {(s.ox + t * s.dx) - ctr.x, (s.oy + t * s.dy) - ctr.y,
                               (s.oz + t * s.dz) - ctr.z};
          const float qd = qv[0] * s.dx + qv[1] * s.dy + qv[2] * s.dz;
          const float mag = fmaxf(fabsf(qd), a.qd_floor);
          const float qd_safe = qd < 0.0f ? -mag : mag;
          const float gg = gd / qd_safe;
          const float ggt = gg * t;
          sum_amp += static_cast<double>(ga * s.amp);
          sum_gg += static_cast<double>(gg);
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            acc_o[k] = acc_o[k] + -gg * qv[k];
            acc_d[k] = acc_d[k] + -ggt * qv[k];
            if (kCenters) s_gc[(3 * q + k) * kGcStride + tid] = gg * qv[k];
          }
        }
        if (any) {
          for (int k = 0; k < 3; ++k) {
            g_origin[3 * at + k] = acc_o[k];
            g_dir[3 * at + k] = acc_d[k];
          }
          g_amp[at] = acc_a;
          g_dist[at] = acc_dist;
        }
      }
      if (kCenters) {
        __syncthreads();
        for (int j = tid; j < 3 * tile; j += kBackThreads) {
          const float* row = s_gc + j * kGcStride;
          float sum = 0.0f;
          for (int t = 0; t < kBackThreads; ++t) sum = sum + row[t];
          gc_partials[(static_cast<long long>(blockIdx.x) * m + s0 + q0) * 3 + j] = sum;
        }
        __syncthreads();  // the scratch is zeroed again by the next tile
      }
    }
  }
  if (a.sums_partials != nullptr) {
    s_sums[0][tid] = sum_amp;
    s_sums[1][tid] = sum_gg;
    __syncthreads();
    if (tid < 2) {
      double acc = 0.0;
      for (int t = 0; t < kBackThreads; ++t) acc += s_sums[tid][t];
      a.sums_partials[2 * static_cast<long long>(blockIdx.x) + tid] = acc;
    }
  }
}

// out[w] = the blocks' partials of sum w, (blocks, 2), in double: a warp a
// sum, lane l adding blocks l, l + 32, ... in order, then a fixed tree.
__global__ void __launch_bounds__(64) sums_reduce_kernel(const double* __restrict__ partials,
                                                         int blocks, float* __restrict__ out) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  double acc = 0.0;
  for (int k = lane; k < blocks; k += 32) acc += partials[2 * static_cast<long long>(k) + w];
  for (int off = 16; off > 0; off /= 2) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[w] = static_cast<float>(acc);
}

int backward_blocks(int n) {
  return static_cast<int>((static_cast<long long>(n) + kBackThreads - 1) / kBackThreads);
}

// out[j] = the blocks' partials of entry j, (blocks, total), added in block
// order from +0; eight loads in flight.
__global__ void __launch_bounds__(256) centers_reduce_kernel(const float* __restrict__ partials,
                                                             int blocks, int total,
                                                             float* __restrict__ out) {
  const int j = blockIdx.x * 256 + threadIdx.x;
  if (j >= total) return;
  constexpr int kAhead = 8;
  float acc = 0.0f;
  int k = 0;
  for (; k + kAhead <= blocks; k += kAhead) {
    float v[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) v[u] = partials[static_cast<long long>(k + u) * total + j];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) acc = acc + v[u];
  }
  for (; k < blocks; ++k) acc = acc + partials[static_cast<long long>(k) * total + j];
  out[j] = acc;
}

}  // namespace

// origin, dir: (nb, n, 3) f32; t_env, amp, dist: (nb, n) f32; alive: (nb, n)
// bool; centers: (m, 3) f32. out_amp, out_dist: (m, nb * n) f32 and out_cap:
// (m, nb * n) bool, every entry written. m, n, nb >= 1; m over 65535 * 32
// (the grid's second dimension) fails the launch.
extern "C" int rfx_map_capture(const void* origin, const void* dir, const void* t_env,
                               const void* amp, const void* dist, const void* alive, int nb, int n,
                               const void* centers, int m, float radius, float scale,
                               void* out_amp, void* out_dist, void* out_cap, void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, (m + kTile - 1) / kTile);
  map_capture_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(origin), static_cast<const float*>(dir),
      static_cast<const float*>(t_env), static_cast<const float*>(amp),
      static_cast<const float*>(dist), static_cast<const bool*>(alive), nb, n,
      static_cast<const float*>(centers), m, radius * radius, scale,
      static_cast<float*>(out_amp), static_cast<float*>(out_dist), static_cast<bool*>(out_cap));
  return static_cast<int>(cudaGetLastError());
}

// The segments and centers as rfx_map_capture takes them; g: (m, nbins) f32,
// the IRs' cotangent; soft: 0 or 1; qd_floor = f32(1e-6 * max(radius,
// 1e-6)). g_origin, g_dir: (nb, n, 3) f32, g_amp, g_dist: (nb, n) f32, every
// element written. With blocks = rfx_map_capture_backward_blocks(n):
// gc_partials is null, or (blocks, m, 3) f32 scratch, and then g_centers
// (m, 3) f32 gets the centers' gradient; sums_partials is null, or (blocks,
// 2) f64 scratch, and then sums (2,) f32 gets the sums over every capture of
// g_a amp and of gg. m, n, nb, nbins >= 1.
extern "C" int rfx_map_capture_backward(const void* origin, const void* dir, const void* t_env,
                                        const void* amp, const void* dist, const void* alive,
                                        int nb, int n, const void* centers, int m, float radius,
                                        float scale, float c, float rate, int nbins, int soft,
                                        float qd_floor, const void* g, void* g_origin,
                                        void* g_dir, void* g_amp, void* g_dist,
                                        void* gc_partials, void* g_centers, void* sums_partials,
                                        void* sums, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BackArgs a{static_cast<const float*>(amp), static_cast<const float*>(dist),
                   static_cast<const float*>(g), radius * radius, scale, c, rate, qd_floor,
                   nbins, soft != 0, static_cast<double*>(sums_partials)};
  const int blocks = backward_blocks(n);
#define RFX_MAP_BACKWARD(KC, SMEM)                                                             \
  map_capture_backward_kernel<KC><<<blocks, kBackThreads, SMEM, s>>>(                          \
      static_cast<const float*>(origin), static_cast<const float*>(dir),                       \
      static_cast<const float*>(t_env), static_cast<const bool*>(alive), nb, n,                \
      static_cast<const float*>(centers), m, a, static_cast<float*>(g_origin),                 \
      static_cast<float*>(g_dir), static_cast<float*>(g_amp), static_cast<float*>(g_dist),     \
      static_cast<float*>(gc_partials))
  cudaError_t err;
  if (gc_partials == nullptr) {
    RFX_MAP_BACKWARD(false, 0);
  } else {
    const int smem = static_cast<int>(sizeof(float)) * 3 * kTile * kGcStride;
    err = cudaFuncSetAttribute(map_capture_backward_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    RFX_MAP_BACKWARD(true, smem);
  }
#undef RFX_MAP_BACKWARD
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (gc_partials != nullptr) {
    const int total = 3 * m;
    centers_reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(
        static_cast<const float*>(gc_partials), blocks, total, static_cast<float*>(g_centers));
  }
  if (sums_partials != nullptr) {
    sums_reduce_kernel<<<1, 64, 0, s>>>(static_cast<const double*>(sums_partials), blocks,
                                        static_cast<float*>(sums));
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward's block count for n rays: the first dimension of its scratch.
extern "C" int rfx_map_capture_backward_blocks(int n) { return backward_blocks(n); }

extern "C" const char* rfx_map_capture_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* rfx_map_capture_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
