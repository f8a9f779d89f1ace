// Exact coverage: the hard impulse response of every receiver sphere from
// the segments of one environment trace.
//
// Replaces rfx/ops/pallas_coverage.py:_kernel, the TPU kernel launched by
// coverage_hist_pallas (the `batched` coverage engine). For each receiver
// and each ray, over the ray's segments b = 0..B-1 in order: the analytic
// sphere hit t_rx (the algebra of rfx_torch/ops/intersect.py:sphere_t:
// oc = o - c, b = oc.d and c = oc.oc - r^2 summed x + y + z, disc = b^2 - c,
// a hit iff disc > 0, the first root above 1e-4); a win where the segment is
// alive, t_rx < 1e29 and t_env > t_rx; the ray's first win for that
// receiver ends the receiver's view of the ray. The win goes into bin
// int((dist + t_rx) / c * rate), two IEEE operations in that order and
// truncated toward zero, with weight amp (already scaled by tx_power /
// num_rays); a bin outside [0, nbins) drops the path.
//
// Layout: one block per group of up to kMaxRx receivers, over all rays. Each
// receiver's histogram lives in shared memory (10,000 bins = 40 KB), so the
// wrapper picks how many receivers a block holds from the card's shared
// memory and raises when one histogram does not fit. One thread takes one
// ray of a 512-ray chunk and loops over its bounces, which gives the first
// capture for free. The captures of a chunk are compacted per receiver in
// ray order (warp ballots and a prefix over warps), and one thread per
// receiver adds them in that order to the receiver's histogram. No float
// atomics: every receiver's IR is summed in ray order, the same on every
// run and for any grouping of receivers into blocks.
//
// Not carried over from the TPU kernel: the one-hot MXU histogram, its
// transposed accumulator, the 128-segment subtile gating and the padding of
// receivers (R_TILE) and rays (C_CHUNK), which exist for the TPU's matrix
// unit and tiling.
//
// What bounds it on an H100: the sphere tests, B x N x M of them (4.3e9 for
// 2,048 receivers and 2 x 1,048,576 segments), about 20 f32 operations each;
// captures are sparse. Every block reads all segments (37 bytes each, 78 MB
// at 2 x 1,048,576); the blocks in flight walk the rays at about the same
// pace, so most of those reads come from L2.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRx = 8;
constexpr float kTMin = 1e-4f;
constexpr float kMiss = 1e30f;
constexpr float kMissThreshold = 1e29f;

// Shared memory of one receiver: its histogram, its capture list and its
// per-warp offsets.
constexpr size_t per_rx_bytes(int nbins) {
  return static_cast<size_t>(nbins) * 4 + kThreads * 8 + (kWarps + 1) * 4;
}

__device__ __forceinline__ float sphere_t(float ox, float oy, float oz, float dx, float dy,
                                          float dz, float cx, float cy, float cz, float r2) {
  const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
  const float b = ocx * dx + ocy * dy + ocz * dz;
  const float c = ocx * ocx + ocy * ocy + ocz * ocz - r2;
  const float disc = b * b - c;
  if (!(disc > 0.0f)) return kMiss;
  const float s = sqrtf(disc);
  const float t0 = -b - s;
  const float t1 = -b + s;
  return t0 > kTMin ? t0 : (t1 > kTMin ? t1 : kMiss);
}

// Truncation toward zero; -1 (dropped) where the delay is NaN or outside
// the int range.
__device__ __forceinline__ int delay_bin(float binf) {
  return (binf > -1.0f && binf < 2147483648.0f) ? static_cast<int>(binf) : -1;
}

// Segment (b, i) of the (B, N) planes is element b * n + i; origin and
// direction are (B, N, 3).
__global__ void __launch_bounds__(kThreads) coverage_hist_kernel(
    const float* __restrict__ origin, const float* __restrict__ dir,
    const float* __restrict__ t_env, const float* __restrict__ amp,
    const float* __restrict__ dist, const bool* __restrict__ alive, int nb, int n,
    const float* __restrict__ centers, int m, float r2, float c, float rate, int nbins,
    int rpb, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* hist = smem;                                                        // rpb * nbins
  int* entry_bin = reinterpret_cast<int*>(hist + static_cast<size_t>(rpb) * nbins);
  float* entry_w = reinterpret_cast<float*>(entry_bin + rpb * kThreads);     // rpb * kThreads
  int* warp_off = reinterpret_cast<int*>(entry_w + rpb * kThreads);          // rpb * (kWarps + 1)

  const int rx0 = blockIdx.x * rpb;
  const int nrx = min(rpb, m - rx0);
  for (long long k = threadIdx.x; k < static_cast<long long>(nrx) * nbins; k += kThreads) {
    hist[k] = 0.0f;
  }
  float cx[kMaxRx], cy[kMaxRx], cz[kMaxRx];
#pragma unroll
  for (int r = 0; r < kMaxRx; ++r) {
    const bool in = r < nrx;
    cx[r] = in ? centers[3 * (rx0 + r)] : 0.0f;
    cy[r] = in ? centers[3 * (rx0 + r) + 1] : 0.0f;
    cz[r] = in ? centers[3 * (rx0 + r) + 2] : 0.0f;
  }
  const unsigned all_rx = (1u << nrx) - 1u;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  for (long long base = 0; base < n; base += kThreads) {
    const long long i = base + threadIdx.x;
    unsigned done = 0, valid = 0;
    int bin[kMaxRx];
    float w[kMaxRx];
#pragma unroll
    for (int r = 0; r < kMaxRx; ++r) {
      bin[r] = 0;
      w[r] = 0.0f;
    }
    if (i < n) {
      for (int b = 0; b < nb && done != all_rx; ++b) {
        const long long s = static_cast<long long>(b) * n + i;
        if (!alive[s]) continue;
        const float ox = origin[3 * s], oy = origin[3 * s + 1], oz = origin[3 * s + 2];
        const float dx = dir[3 * s], dy = dir[3 * s + 1], dz = dir[3 * s + 2];
        const float te = t_env[s];
#pragma unroll
        for (int r = 0; r < kMaxRx; ++r) {
          if (r >= nrx || ((done >> r) & 1u)) continue;
          const float t = sphere_t(ox, oy, oz, dx, dy, dz, cx[r], cy[r], cz[r], r2);
          if (t < kMissThreshold && te > t) {
            done |= 1u << r;
            const int k = delay_bin((dist[s] + t) / c * rate);
            if (k >= 0 && k < nbins) {
              valid |= 1u << r;
              bin[r] = k;
              w[r] = amp[s];
            }
          }
        }
      }
    }
    if (!__syncthreads_or(valid != 0u)) continue;

    unsigned ballot[kMaxRx];
#pragma unroll
    for (int r = 0; r < kMaxRx; ++r) {
      ballot[r] = __ballot_sync(0xffffffffu, (valid >> r) & 1u);
      if (lane == 0 && r < nrx) warp_off[r * (kWarps + 1) + warp] = __popc(ballot[r]);
    }
    __syncthreads();
    if (threadIdx.x < nrx) {
      int* off = warp_off + threadIdx.x * (kWarps + 1);
      int total = 0;
      for (int k = 0; k < kWarps; ++k) {
        const int cnt = off[k];
        off[k] = total;
        total += cnt;
      }
      off[kWarps] = total;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kMaxRx; ++r) {
      if ((valid >> r) & 1u) {
        const int pos = warp_off[r * (kWarps + 1) + warp] + __popc(ballot[r] & lanes_below);
        entry_bin[r * kThreads + pos] = bin[r];
        entry_w[r * kThreads + pos] = w[r];
      }
    }
    __syncthreads();
    if (threadIdx.x < nrx) {
      const int r = threadIdx.x;
      const int total = warp_off[r * (kWarps + 1) + kWarps];
      float* h = hist + static_cast<size_t>(r) * nbins;
      for (int k = 0; k < total; ++k) h[entry_bin[r * kThreads + k]] += entry_w[r * kThreads + k];
    }
    __syncthreads();
  }

  float* dst = out + static_cast<size_t>(rx0) * nbins;
  for (long long k = threadIdx.x; k < static_cast<long long>(nrx) * nbins; k += kThreads) {
    dst[k] = hist[k];
  }
}

int smem_limit() {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return limit;
}

}  // namespace

// The most receivers one block can hold at `nbins` (at most kMaxRx); 0 when
// one receiver's histogram does not fit in shared memory.
extern "C" int rfx_coverage_hist_receivers_per_block(int nbins) {
  const size_t fit = static_cast<size_t>(smem_limit()) / per_rx_bytes(nbins);
  return static_cast<int>(fit < kMaxRx ? fit : kMaxRx);
}

// The most bins one receiver's histogram can have on this card.
extern "C" int rfx_coverage_hist_max_bins() {
  return static_cast<int>((static_cast<size_t>(smem_limit()) - per_rx_bytes(0)) / 4);
}

// origin, dir: (nb, n, 3) f32; t_env, amp, dist: (nb, n) f32; alive: (nb, n)
// bool; centers: (m, 3) f32; out: (m, nbins) f32, every element written.
// rpb receivers per block, 1 <= rpb <= the value of
// rfx_coverage_hist_receivers_per_block(nbins); m >= 1.
extern "C" int rfx_coverage_hist(const void* origin, const void* dir, const void* t_env,
                                 const void* amp, const void* dist, const void* alive, int nb,
                                 int n, const void* centers, int m, float radius, float c,
                                 float rate, int nbins, int rpb, void* out, void* stream) {
  const size_t smem = per_rx_bytes(nbins) * rpb;
  cudaError_t err = cudaFuncSetAttribute(
      coverage_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (m + rpb - 1) / rpb;
  coverage_hist_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(origin), static_cast<const float*>(dir),
      static_cast<const float*>(t_env), static_cast<const float*>(amp),
      static_cast<const float*>(dist), static_cast<const bool*>(alive), nb, n,
      static_cast<const float*>(centers), m, radius * radius, c, rate, nbins, rpb,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rfx_coverage_hist_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
