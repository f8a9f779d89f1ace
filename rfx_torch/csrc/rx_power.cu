// RX power of a batch of impulse responses (IRs): each row convolved with the
// carrier sine in 'same' mode, then the mean square of the row's nonzero
// samples in dBm.
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
// A tap's multiply and add are two of the SM's 128 f32 lanes a cycle, but a
// tap also needs its carrier value, and the shared-memory pipe gives a warp
// one 32-word access a cycle: one load a tap per lane is the most the SM can
// feed, which makes the load, not the arithmetic, the limit to design for.
// What the design does about it:
//
//   1. `compact_segments`: the row is cut into segments of kSeg bins, one
//      block a (row, segment). The block lists the segment's nonzero bins in
//      ascending k, with their values, as (k, value) pairs in the segment's
//      own slot of `list`, and their number in `seg_count`: a fixed-order
//      scan of warp ballots, no atomic, and every block of a row at work at
//      once (a lone 20,000-bin IR is 20 blocks, not one block stepping
//      through the row).
//   2. `convolve<R>`: one block a (row, tile of 128 R output samples), each
//      lane R samples 32 apart, so that the lanes of a warp read 32
//      neighbouring carrier words for one k. For each segment that reaches
//      the tile, the block copies with cp.async the segment's pairs and the
//      carrier window that they reach from the tile into shared memory,
//      double-buffered: the next segment's copy runs while this one's taps
//      are added. The window holds zeros where the carrier index leaves
//      [0, nbins), so a tap needs no range test: one 8-byte broadcast of
//      (k, value) serves R taps, and a tap is then one shared load, a
//      multiply and an add. R is 8 where the launch has enough blocks to
//      fill the card, else 1 (a lone row: 157 blocks of 128 samples for
//      20,000 bins).
//   3. `row_power`: one block a row counts the nonzero samples of `out` and
//      sums their squares, each thread over a fixed stride, then a fixed
//      tree; its epilogue writes the row's dBm, 10 log10((sum / count) /
//      1e-3), -inf where no sample is nonzero.
//
// Every sum has an order fixed by the row alone: a sample adds its row's taps
// in ascending k whatever R and the tiling (a tap that lies outside the carrier
// adds +-0 to a sum that is never -0, which changes no bit), and the row's
// count and squares go by the stride and the tree. There is no atomic: the
// result is the same bits from run to run, and a row computed alone is the
// same bits as in a batch. The plain version (rfx_torch/cir.py:
// convolve_carrier_plain) adds a sample's taps in chunks of 256 nonzero bins
// by torch.sum; the two differ by rounding only.
//
// The backward (rfx_rx_power_backward) replaces the transpose that jax.grad
// takes of the same lax.conv and mean square. With the row's count n and
// sum of squares sq from the forward's `row_power`, and the cotangents of the
// dBm (g_dbm, one a row) and of the signal (g_out, one a sample), each
// possibly absent:
//
//   g_eff[r, j] = g_out[r, j] + g_dbm[r] (20 / ln 10) / sq[r] * out[r, j]
//                 (the second term only where n > 0, g_dbm != 0, out != 0),
//   g_ir[r, k]  = sum_j g_eff[r, j] * carrier[j + lo - k],
//
// the transposed 'same' convolution: dense in k (a zero bin gets a gradient,
// as under lax.conv's transpose). It is the forward's convolution of g_eff
// with the reversed carrier, carrier'[x] = carrier[nbins - 1 - x], and hi =
// nbins - 1 - lo in place of lo: carrier'[k + hi - j] = carrier[j + lo - k].
// So it runs the forward's two kernels on g_eff: `compact_segments` lists the
// nonzero g_eff[j], formed on the fly from out and the cotangents, and
// `convolve<R>` adds each output's taps in ascending j. What bounds it:
// operations again, now two a tap over every nonzero j (g_eff is dense where
// the signal is: ~1.5e11 in-range taps for 2,048 rows of 10,000 bins, 20x the
// forward's). The same order rules make it the same bits from run to run and
// for a row alone or in a batch.

#include <cuda_runtime.h>

namespace {

constexpr int kSeg = 1024;       // bins of a compaction segment, and of a staged chunk of pairs
constexpr int kThreads = 128;    // threads of a convolve or compaction block
constexpr int kPowerThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullWarp = 0xffffffffu;

// Shared words of one stage of convolve<R>: the carrier window (tile + kSeg
// - 1 words, rounded up to an even count) and up to kSeg (k, value) pairs.
template <int R>
__host__ __device__ constexpr int stage_words() {
  return ((32 * kWarps * R + kSeg - 1 + 1) & ~1) + 2 * kSeg;
}

// The forward's input: bin k of row r of the IRs.
struct IrValues {
  const float* ir;
  int nbins;

  __device__ __forceinline__ void start_row(long long) {}
  __device__ __forceinline__ float operator()(long long row, int k) const {
    return ir[row * nbins + k];
  }
};

// The backward's input, g_eff (see the note at the top), formed from the
// forward's signal and row sums and the cotangents; g_dbm and g_out may be
// null (no cotangent). `sums` holds (sq, count) a row, as row_power writes it.
struct CotangentValues {
  const float* g_dbm;
  const float* g_out;
  const float* out;
  const float* sums;
  int nbins;
  float scale = 0.0f;  // g_dbm (20 / ln 10) / sq of the row, 0 where that term is skipped

  __device__ __forceinline__ void start_row(long long row) {
    constexpr float kDbPerPower = 8.685889638065035f;  // 20 / ln 10
    scale = 0.0f;
    if (g_dbm != nullptr) {
      const float g = g_dbm[row];
      if (g != 0.0f && sums[2 * row + 1] > 0.0f) scale = g * kDbPerPower / sums[2 * row];
    }
  }
  __device__ __forceinline__ float operator()(long long row, int k) const {
    const long long at = row * nbins + k;
    float v = g_out != nullptr ? g_out[at] : 0.0f;
    if (scale != 0.0f) {
      const float o = out[at];
      if (o != 0.0f) v = v + scale * o;
    }
    return v;
  }
};

// list[r * nbins + s * kSeg + i] = (k, bits of value(r, k)) for the i-th
// nonzero value k of segment s of row r, ascending; seg_count[r * n_seg + s]
// their number. A NaN counts as nonzero, -0.0 as zero (as torch.nonzero).
template <class Values>
__global__ void __launch_bounds__(kThreads) compact_segments(Values values, int nbins, int n_seg,
                                                             int2* __restrict__ list,
                                                             int* __restrict__ seg_count) {
  __shared__ int warp_counts[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = blockIdx.x / n_seg;
  const int seg = static_cast<int>(blockIdx.x - row * n_seg);
  const int k0 = seg * kSeg;
  const int k_end = min(k0 + kSeg, nbins);
  values.start_row(row);
  int2* out = list + row * nbins + k0;
  int carry = 0;
  for (int base = k0; base < k_end; base += kThreads) {
    const int k = base + threadIdx.x;
    const float v = k < k_end ? values(row, k) : 0.0f;
    const bool nz = v != 0.0f;
    const unsigned ballot = __ballot_sync(kFullWarp, nz);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? warp_counts[w] : 0;
      total += warp_counts[w];
    }
    if (nz) {
      out[carry + before + __popc(ballot & ((1u << lane) - 1u))] =
          make_int2(k, __float_as_int(v));
    }
    carry += total;
    __syncthreads();  // warp_counts is rewritten by the next step
  }
  if (threadIdx.x == 0) seg_count[row * n_seg + seg] = carry;
}

// An asynchronous copy of kBytes (4 or 8) from global to shared memory;
// where `valid` is false nothing is read and the destination is zeroed.
template <int kBytes>
__device__ __forceinline__ void copy_async(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(gmem),
               "n"(kBytes), "r"(valid ? kBytes : 0));
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// out[r, j] for one tile of 32 * kWarps * R samples of one row; see the note
// at the top (lo = (nbins - 1) / 2 in the forward, hi in the backward). Block
// b takes row b / n_tiles, tile b % n_tiles.
template <int R>
__global__ void __launch_bounds__(kThreads) convolve(const float* __restrict__ carrier, int nbins,
                                                     int lo, int n_seg, int n_tiles,
                                                     const int2* __restrict__ list,
                                                     const int* __restrict__ seg_count,
                                                     float* __restrict__ out) {
  constexpr int kTile = 32 * kWarps * R;
  constexpr int kWindow = kTile + kSeg - 1;
  constexpr int kStage = stage_words<R>();
  constexpr int kPairs = kStage - 2 * kSeg;  // word offset of the pairs in a stage
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = blockIdx.x / n_tiles;
  const int j0 = static_cast<int>(blockIdx.x - row * n_tiles) * kTile;
  const int* counts = seg_count + row * n_seg;
  const int2* row_list = list + row * nbins;
  // Bin k reaches some sample of the tile iff j0 + lo - nbins < k <= j0 +
  // kTile - 1 + lo: the segments s_lo..s_hi.
  const int s_lo = max(0, j0 + lo - nbins + 1) / kSeg;
  const int s_hi = min(nbins - 1, j0 + kTile - 1 + lo) / kSeg;

  // Stage segment s into buffer b: window word x is carrier[wb + x] (zero
  // outside the carrier), wb = j0 + lo - (s * kSeg + kSeg - 1), so that
  // sample j0 + t and bin s * kSeg + kl meet at word t + kSeg - 1 - kl.
  auto stage = [&](int s, int b) {
    float* win = smem + b * kStage;
    int2* pairs = reinterpret_cast<int2*>(win + kPairs);
    const int wb = j0 + lo - (s * kSeg + kSeg - 1);
    for (int x = threadIdx.x; x < kWindow; x += kThreads) {
      const int idx = wb + x;
      const bool in = idx >= 0 && idx < nbins;
      copy_async<4>(win + x, carrier + (in ? idx : 0), in);
    }
    const int n = counts[s];
    const int2* src = row_list + s * kSeg;
    for (int q = threadIdx.x; q < n; q += kThreads) copy_async<8>(pairs + q, src + q, true);
    copy_commit();
  };
  auto next_segment = [&](int s) {
    do {
      ++s;
    } while (s <= s_hi && counts[s] == 0);
    return s;
  };

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;
  const int t0 = warp * 32 * R + lane;  // this lane's first sample in the tile
  int s = next_segment(s_lo - 1);
  int b = 0;
  if (s <= s_hi) stage(s, 0);
  while (s <= s_hi) {
    const int s_next = next_segment(s);
    if (s_next <= s_hi) {
      stage(s_next, b ^ 1);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();
    const float* win = smem + b * kStage;
    const int2* pairs = reinterpret_cast<const int2*>(win + kPairs);
    const int n = counts[s];
    const int first = t0 + kSeg - 1 + s * kSeg;
    for (int q = 0; q < n; ++q) {
      const int2 e = pairs[q];
      const float v = __int_as_float(e.y);
      const float* c = win + (first - e.x);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = acc[r] + v * c[32 * r];
    }
    __syncthreads();  // buffer b is read before it is staged again
    s = s_next;
    b ^= 1;
  }
  float* row_out = out + row * nbins;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = j0 + t0 + 32 * r;
    if (j < nbins) row_out[j] = acc[r];
  }
}

// dbm[r] = the mean square of the nonzero samples of out[r] in dBm, -inf
// where there is none: the count and the sum of squares each thread takes
// over a fixed stride, then a fixed tree. sums[r] = (sum of squares, count),
// what the backward reads.
__global__ void __launch_bounds__(kPowerThreads) row_power(const float* __restrict__ out, int nbins,
                                                           float* __restrict__ dbm,
                                                           float2* __restrict__ sums) {
  __shared__ int s_n[kPowerThreads];
  __shared__ float s_sq[kPowerThreads];
  const size_t row = static_cast<size_t>(blockIdx.x) * nbins;
  int n = 0;
  float sq = 0.0f;
  for (int j = threadIdx.x; j < nbins; j += kPowerThreads) {
    const float v = out[row + j];
    if (v != 0.0f) {
      ++n;
      sq = sq + v * v;
    }
  }
  s_n[threadIdx.x] = n;
  s_sq[threadIdx.x] = sq;
  __syncthreads();
  for (int half = kPowerThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      s_n[threadIdx.x] += s_n[threadIdx.x + half];
      s_sq[threadIdx.x] = s_sq[threadIdx.x] + s_sq[threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    // rfx_torch/cir.py:_dbm_of_sums as PyTorch rounds it on the card: sq /
    // count, then to_dbm, whose division by the scalar 1e-3 PyTorch takes as
    // a product with its f32 reciprocal.
    constexpr float kPerMilliwatt = 1.0f / 1e-3f;
    const int count = s_n[0];
    sums[blockIdx.x] = make_float2(s_sq[0], static_cast<float>(count));  // count < 2^24: exact
    dbm[blockIdx.x] = count > 0
                          ? 10.0f * log10f(s_sq[0] / static_cast<float>(count) * kPerMilliwatt)
                          : -__int_as_float(0x7f800000);
  }
}

template <int R>
cudaError_t launch_convolve(const float* carrier, int m, int nbins, int lo, int n_seg,
                            const int2* list, const int* seg_count, float* out, cudaStream_t s) {
  constexpr int kTile = 32 * kWarps * R;
  constexpr size_t kBytes = 2 * sizeof(float) * stage_words<R>();
  static_assert(kBytes <= 48 * 1024, "two stages fit the default dynamic shared memory");
  const int n_tiles = (nbins + kTile - 1) / kTile;
  convolve<R><<<static_cast<unsigned>(static_cast<long long>(m) * n_tiles), kThreads, kBytes, s>>>(
      carrier, nbins, lo, n_seg, n_tiles, list, seg_count, out);
  return cudaGetLastError();
}

// Compaction of `values` and the convolution of the list with `carrier` at
// offset lo, into out: the forward's and the backward's common launches.
template <class Values>
cudaError_t compact_and_convolve(Values values, const float* carrier, int m, int nbins, int lo,
                                 void* list, void* seg_count, float* out, cudaStream_t s) {
  const int n_seg = (nbins + kSeg - 1) / kSeg;
  compact_segments<<<static_cast<unsigned>(static_cast<long long>(m) * n_seg), kThreads, 0, s>>>(
      values, nbins, n_seg, static_cast<int2*>(list), static_cast<int*>(seg_count));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // Eight samples a lane where that leaves eight blocks an SM or more on an
  // H100's 132; else one, so that a few rows still fill the card. Either
  // gives the same bits.
  const long long wide_blocks = static_cast<long long>(m) * ((nbins + 32 * kWarps * 8 - 1) /
                                                            (32 * kWarps * 8));
  return wide_blocks >= 8 * 132
             ? launch_convolve<8>(carrier, m, nbins, lo, n_seg, static_cast<const int2*>(list),
                                  static_cast<const int*>(seg_count), out, s)
             : launch_convolve<1>(carrier, m, nbins, lo, n_seg, static_cast<const int2*>(list),
                                  static_cast<const int*>(seg_count), out, s);
}

}  // namespace

// ir: (m, nbins) f32; carrier: (nbins,) f32; out: (m, nbins) f32, dbm: (m,)
// f32 and sums: (m, 2) f32 (sum of squares, count), every element written;
// list: (m, nbins) int2 and seg_count: (m, ceil(nbins / 1024)) int32, scratch.
// m >= 1, nbins >= 1, m * ceil(nbins / 128) < 2^31.
extern "C" int rfx_rx_power(const void* ir, const void* carrier, int m, int nbins, void* out,
                            void* dbm, void* sums, void* list, void* seg_count, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = compact_and_convolve(IrValues{static_cast<const float*>(ir), nbins},
                                         static_cast<const float*>(carrier), m, nbins,
                                         (nbins - 1) / 2, list, seg_count,
                                         static_cast<float*>(out), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  row_power<<<m, kPowerThreads, 0, s>>>(static_cast<const float*>(out), nbins,
                                        static_cast<float*>(dbm), static_cast<float2*>(sums));
  return static_cast<int>(cudaGetLastError());
}

// The backward of rfx_rx_power: g_dbm (m,) f32 and g_out (m, nbins) f32, the
// cotangents of dbm and out, each null where absent; out and sums as
// rfx_rx_power wrote them; reversed_carrier: (nbins,) f32, the carrier back
// to front. g_ir: (m, nbins) f32, every element written; list and seg_count
// as rfx_rx_power's scratch. The bounds of rfx_rx_power.
extern "C" int rfx_rx_power_backward(const void* g_dbm, const void* g_out, const void* out,
                                     const void* sums, const void* reversed_carrier, int m,
                                     int nbins, void* g_ir, void* list, void* seg_count,
                                     void* stream) {
  const CotangentValues values{static_cast<const float*>(g_dbm), static_cast<const float*>(g_out),
                               static_cast<const float*>(out), static_cast<const float*>(sums),
                               nbins};
  return static_cast<int>(compact_and_convolve(values, static_cast<const float*>(reversed_carrier),
                                               m, nbins, nbins - 1 - (nbins - 1) / 2, list,
                                               seg_count, static_cast<float*>(g_ir),
                                               static_cast<cudaStream_t>(stream)));
}

extern "C" const char* rfx_rx_power_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* rfx_rx_power_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
