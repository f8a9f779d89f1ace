// RX power of a batch of impulse responses (IRs): each row convolved with the
// carrier sine in 'same' mode, then the count and the sum of squares of the
// row's nonzero samples.
//
// Replaces the XLA program of rfx/cir.py:160 rx_power_dbm: one
// lax.conv_general_dilated of all (M, nbins) IRs with the flipped carrier
// (:184-190), then the mean square over the nonzero samples (:193-198). For
// row r and output sample j,
//
//   out[r, j] = sum_k ir[r, k] * carrier[j + lo - k],  lo = (nbins - 1) / 2,
//
// over the row's nonzero bins k with 0 <= j + lo - k < nbins. The carrier is
// an input (rfx_torch/cir.py:_carrier, the reference's f32 linspace
// grouping): the kernel never evaluates a sine.
//
// What bounds it on an H100: operations. An IR of the coverage sweep has a
// few hundred nonzero bins of 10,000, and each reaches ~7,500 output samples,
// so a sweep is ~6e9 in-range taps (a multiply and an add each) against
// 164 MB of IRs in and signal out. The metric averages over exactly nonzero
// samples, so zeros must stay exact zeros: no FFT, no matrix product, no TF32.
// What the design does about it:
//
//   1. `compact_rows`: one block a row lists the row's nonzero bins in
//      ascending k, in the row's own slot of `list` (a block-wide scan of the
//      nonzero flags, 256 bins a step), and their number in `list_len`.
//   2. `convolve`: one block a (row, tile of 256 output samples), one thread
//      an output sample. The block stages the row's list 256 bins at a time in
//      shared memory (k and ir[r, k]) and every thread adds the taps of the
//      chunk in list order; a chunk that lies wholly outside the tile's reach
//      is skipped, and one that every sample of the tile reaches runs without
//      the range test. The carrier is read through the L1: for one k the
//      threads of a warp read neighbouring samples.
//   3. `row_power`: one block a row counts the nonzero samples of `out` and
//      sums their squares, each thread over a fixed stride, then a fixed tree.
//
// Every sum has an order fixed by the row alone (ascending k for a sample, the
// stride and the tree for the row), and there is no atomic: the result is the
// same bits from run to run, and a row computed alone is the same bits as in
// a batch. The plain version (rfx_torch/cir.py:convolve_carrier_plain) adds a
// sample's taps in chunks of 256 nonzero bins by torch.sum; the two differ by
// rounding only.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // one thread an output sample; also the chunk of listed bins

__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      const int s = warp_sums[w];
      warp_sums[w] = run;
      run += s;
    }
    *total = run;
  }
  __syncthreads();
  return warp_sums[warp] + incl - v;
}

// list[r * nbins + i] = the i-th nonzero bin of row r, ascending; list_len[r]
// their number. A NaN counts as nonzero, -0.0 as zero (as torch.nonzero).
__global__ void __launch_bounds__(kThreads) compact_rows(const float* __restrict__ ir, int nbins,
                                                         int* __restrict__ list,
                                                         int* __restrict__ list_len) {
  __shared__ int warp_sums[kThreads / 32];
  __shared__ int step_total;
  const size_t row = static_cast<size_t>(blockIdx.x) * nbins;
  int carry = 0;
  for (int base = 0; base < nbins; base += kThreads) {
    const int k = base + threadIdx.x;
    const int nz = k < nbins && ir[row + k] != 0.0f;
    const int at = block_exclusive_scan(nz, warp_sums, &step_total);
    if (nz) list[row + carry + at] = k;
    carry += step_total;
    __syncthreads();  // warp_sums and step_total are reused by the next step
  }
  if (threadIdx.x == 0) list_len[blockIdx.x] = carry;
}

// out[r, j] for the tile of samples [blockIdx.y * kThreads, ...) of row
// blockIdx.x; see the note at the top.
__global__ void __launch_bounds__(kThreads) convolve(const float* __restrict__ ir,
                                                     const float* __restrict__ carrier, int nbins,
                                                     const int* __restrict__ list,
                                                     const int* __restrict__ list_len,
                                                     float* __restrict__ out) {
  __shared__ int s_k[kThreads];
  __shared__ float s_v[kThreads];
  const size_t row = static_cast<size_t>(blockIdx.x) * nbins;
  const int lo = (nbins - 1) / 2;
  const int j0 = blockIdx.y * kThreads;
  const int j1 = min(j0 + kThreads, nbins) - 1;  // the tile's last sample
  const int j = j0 + threadIdx.x;
  // A thread past the row's end computes the last sample's sum, so that its
  // reads stay inside the carrier, and writes nothing.
  const int jl = min(j, nbins - 1) + lo;
  // Bin k reaches sample j iff j + lo - nbins < k <= j + lo: some sample of
  // the tile iff reach_lo <= k <= reach_hi, every one iff all_lo <= k <= all_hi.
  const int reach_lo = j0 + lo - nbins + 1, reach_hi = j1 + lo;
  const int all_lo = j1 + lo - nbins + 1, all_hi = j0 + lo;
  const int len = list_len[blockIdx.x];
  const int* row_list = list + row;
  float acc = 0.0f;
  for (int s = 0; s < len; s += kThreads) {
    const int count = min(kThreads, len - s);
    __syncthreads();  // the previous chunk is read by every thread
    if (threadIdx.x < count) {
      const int k = row_list[s + threadIdx.x];
      s_k[threadIdx.x] = k;
      s_v[threadIdx.x] = ir[row + k];
    }
    __syncthreads();
    const int first = s_k[0], last = s_k[count - 1];
    if (first > reach_hi) break;  // ascending: no later bin reaches the tile
    if (last < reach_lo) continue;
    if (first >= all_lo && last <= all_hi) {
#pragma unroll 4
      for (int q = 0; q < count; ++q) acc = acc + s_v[q] * __ldg(carrier + (jl - s_k[q]));
    } else {
      for (int q = 0; q < count; ++q) {
        const int idx = jl - s_k[q];
        if (idx >= 0 && idx < nbins) acc = acc + s_v[q] * __ldg(carrier + idx);
      }
    }
  }
  if (j < nbins) out[row + j] = acc;
}

// count[r] = nonzero samples of out[r], sumsq[r] = the sum of their squares.
__global__ void __launch_bounds__(kThreads) row_power(const float* __restrict__ out, int nbins,
                                                      int* __restrict__ count,
                                                      float* __restrict__ sumsq) {
  __shared__ int s_n[kThreads];
  __shared__ float s_sq[kThreads];
  const size_t row = static_cast<size_t>(blockIdx.x) * nbins;
  int n = 0;
  float sq = 0.0f;
  for (int j = threadIdx.x; j < nbins; j += kThreads) {
    const float v = out[row + j];
    if (v != 0.0f) {
      ++n;
      sq = sq + v * v;
    }
  }
  s_n[threadIdx.x] = n;
  s_sq[threadIdx.x] = sq;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      s_n[threadIdx.x] += s_n[threadIdx.x + half];
      s_sq[threadIdx.x] = s_sq[threadIdx.x] + s_sq[threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    count[blockIdx.x] = s_n[0];
    sumsq[blockIdx.x] = s_sq[0];
  }
}

}  // namespace

// ir: (m, nbins) f32; carrier: (nbins,) f32; out: (m, nbins) f32, every
// element written; count: (m,) int32; sumsq: (m,) f32; list: (m, nbins) int32
// and list_len: (m,) int32, scratch. m >= 1, 1 <= nbins, and ceil(nbins / 256)
// <= 65535.
extern "C" int rfx_rx_power(const void* ir, const void* carrier, int m, int nbins, void* out,
                            void* count, void* sumsq, void* list, void* list_len, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  compact_rows<<<m, kThreads, 0, s>>>(static_cast<const float*>(ir), nbins,
                                      static_cast<int*>(list), static_cast<int*>(list_len));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(m, (nbins + kThreads - 1) / kThreads);
  convolve<<<grid, kThreads, 0, s>>>(static_cast<const float*>(ir),
                                     static_cast<const float*>(carrier), nbins,
                                     static_cast<const int*>(list),
                                     static_cast<const int*>(list_len), static_cast<float*>(out));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  row_power<<<m, kThreads, 0, s>>>(static_cast<const float*>(out), nbins,
                                   static_cast<int*>(count), static_cast<float*>(sumsq));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rfx_rx_power_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
