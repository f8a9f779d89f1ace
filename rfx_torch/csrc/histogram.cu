// Deterministic weighted histogram of captured path amplitudes into delay
// bins: the impulse response (IR).
//
// Replaces rfx/cir.py:_bincount_matmul, the XLA form that
// rfx.cir.bin_impulse_response takes on a TPU (two one-hot matmuls, because
// XLA's TPU scatter is slow). The bin is computed here, from the distance,
// as the two IEEE f32 operations of rfx/cir.py:98 in their order,
// distance / c * rate, then truncated (hard mode, :120) or floored (the two
// halves of soft mode, :104-118). A path that is not captured, or whose bin
// falls outside [0, nbins), is dropped.
//
// The result is bit-identical from run to run: there is no float atomicAdd.
// Pass 1 gives each block a fixed, contiguous range of rays and a private
// histogram in shared memory (20,000 bins = 80 KB); the block compacts each
// 512-ray chunk's captured paths in ray order (warp ballots and a prefix over
// warps) and one thread adds them, in that order, to the shared histogram.
// The block writes its partial histogram to global memory. Pass 2 sums the
// partials per bin in block order.
//
// What bounds it on an H100: reading the per-ray inputs (9 bytes a ray,
// 47 MB at 5,242,880 rays) at device-memory bandwidth; captures are sparse,
// so the serial adds are few. Writing and re-reading the partials costs
// nblocks * nbins * 4 bytes (about 20 MB at 256 blocks and 20,000 bins).
//
// -fmad=false (rfx_torch/ops/_build.py) keeps soft mode's weights rounded
// as the plain PyTorch version rounds them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// mode 0: hard, bin = trunc(delay), weight = amp.
// mode 1: soft low half, bin = floor(delay), weight = amp * (1 - frac).
// mode 2: soft high half, bin = floor(delay) + 1, weight = amp * frac.
__global__ void __launch_bounds__(kThreads) ir_block_partials(
    const float* __restrict__ amp, const float* __restrict__ dist,
    const bool* __restrict__ captured, int n, float c, float rate, int nbins,
    int mode, int rays_per_block, float* __restrict__ partials) {
  extern __shared__ float smem[];
  float* hist = smem;                                  // nbins
  int* entry_bin = reinterpret_cast<int*>(hist + nbins);  // kThreads
  float* entry_w = reinterpret_cast<float*>(entry_bin + kThreads);  // kThreads
  int* warp_off = reinterpret_cast<int*>(entry_w + kThreads);  // kWarps + 1

  for (int b = threadIdx.x; b < nbins; b += kThreads) hist[b] = 0.0f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long begin = static_cast<long long>(blockIdx.x) * rays_per_block;
  const long long stop = begin + rays_per_block;
  const long long end = stop < n ? stop : static_cast<long long>(n);
  for (long long base = begin; base < end; base += kThreads) {
    const long long i = base + threadIdx.x;
    bool valid = false;
    int bin = 0;
    float w = 0.0f;
    if (i < end && captured[i]) {
      const float delay = dist[i] / c * rate;
      if (mode == 0) {
        bin = static_cast<int>(delay);
        w = amp[i];
      } else {
        const float lo = floorf(delay);
        const float frac = delay - lo;
        bin = static_cast<int>(lo) + (mode == 2 ? 1 : 0);
        w = mode == 2 ? amp[i] * frac : amp[i] * (1.0f - frac);
      }
      valid = bin >= 0 && bin < nbins;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, valid);
    if (lane == 0) warp_off[warp] = __popc(ballot);
    __syncthreads();
    if (threadIdx.x == 0) {
      int total = 0;
      for (int k = 0; k < kWarps; ++k) {
        const int cnt = warp_off[k];
        warp_off[k] = total;
        total += cnt;
      }
      warp_off[kWarps] = total;
    }
    __syncthreads();
    if (valid) {
      const int pos = warp_off[warp] + __popc(ballot & ((1u << lane) - 1u));
      entry_bin[pos] = bin;
      entry_w[pos] = w;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const int total = warp_off[kWarps];
      for (int k = 0; k < total; ++k) hist[entry_bin[k]] += entry_w[k];
    }
    __syncthreads();
  }

  float* out = partials + static_cast<size_t>(blockIdx.x) * nbins;
  for (int b = threadIdx.x; b < nbins; b += kThreads) out[b] = hist[b];
}

__global__ void ir_reduce_partials(const float* __restrict__ partials,
                                   int nblocks, int nbins,
                                   float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nbins) return;
  float s = 0.0f;
  for (int k = 0; k < nblocks; ++k) s += partials[static_cast<size_t>(k) * nbins + b];
  out[b] = s;
}

}  // namespace

extern "C" int rfx_ir_histogram_max_bins() {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int fixed = kThreads * 8 + (kWarps + 1) * 4;
  return (limit - fixed) / 4;
}

// partials: (nblocks, nbins) f32 scratch; out: (nbins,) f32.
extern "C" int rfx_ir_histogram(const void* amp, const void* dist,
                                const void* captured, int n, float c,
                                float rate, int nbins, int mode, int nblocks,
                                int rays_per_block, void* partials, void* out,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(nbins) * 4 + kThreads * 8 + (kWarps + 1) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      ir_block_partials, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ir_block_partials<<<nblocks, kThreads, smem, s>>>(
      static_cast<const float*>(amp), static_cast<const float*>(dist),
      static_cast<const bool*>(captured), n, c, rate, nbins, mode,
      rays_per_block, static_cast<float*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ir_reduce_partials<<<(nbins + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partials), nblocks, nbins, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rfx_ir_histogram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
