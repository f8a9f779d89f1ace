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
// as under lax.conv's transpose). With the reversed carrier, carrier'[x] =
// carrier[nbins - 1 - x], and hi = nbins - 1 - lo it is a convolution like
// the forward's: carrier'[k + hi - j] = carrier[j + lo - k].
//
// What bounds it on an H100: operations, and a different mix from the
// forward's. g_eff is dense where the signal is (83-95% nonzero on the
// coverage sweep's rows), so ~1.5e11 in-range taps for 2,048 rows of 10,000
// bins, 20x the forward's. Feeding each tap its carrier word from shared
// memory, one 32-word access a cycle an SM, caps it at ~8e12 taps/s, a
// fifth of the card's FMA rate. What the design does about it:
//
//   1. `stage_cotangent` forms g_eff row by row into scratch, padded to whole
//      1,024-bin segments, and flags the segments that hold a nonzero value.
//      No compaction: a segment with any nonzero value is taken whole.
//   2. `convolve_back<Q, kSplit>`: a block takes Q = 8 rows (1 where the
//      launch has fewer rows) and a tile of 512 outputs, each lane 4
//      neighbouring outputs. It stages, double-buffered with cp.async, the
//      carrier window of a 512-bin chunk of j once for all Q rows, and the Q
//      rows' g_eff of that chunk. For 4 values of j a lane reads 7 carrier
//      words (two 16-byte loads: the lanes of a warp read 512 neighbouring
//      bytes, no bank conflict) and one 16-byte broadcast of g_eff a row, and
//      does 16 FMAs a row: 128 FMAs for 10 shared loads, so the FP32 pipe,
//      not the shared-memory pipe, is the limit. A tap is one explicit
//      __fmaf_rn. -fmad=false stops only the contractions the compiler
//      chooses; the backward has no threshold event (no count of nonzero
//      samples rests on its bits), so its taps may round once. The forward
//      keeps its separate multiply and add: its nonzero count does rest on
//      them.
//   3. The order is fixed by nbins alone: for each output k, the taps of a
//      1,024-bin segment s of j form one FMA chain in ascending j from +0
//      (the partial p_s), and g_ir[k] = ((p_0 + p_1) + p_2) + ... in
//      segment order. A zero tap, of a zero g_eff or of a carrier word past
//      its ends, adds fma(0, c, acc) = acc to a chain that is never -0, and
//      a skipped segment's partial is +0, so skipping either changes no bit.
//      In a launch of many blocks each block loops over the segments, the
//      partials and their sum in registers. A launch of few blocks (a lone
//      IR: 40 tiles) splits over the segments: a block a (rows, tile,
//      segment) writes its partials, and `combine_segments` adds them in
//      segment order. Both give the same bits, so a row alone is the same
//      bits as in any batch, and the same from run to run.
//
// The plain version (rfx_torch/cir.py:rx_power_backward_plain) sums in
// float64; the two differ by rounding only.

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
__global__ void __launch_bounds__(kThreads) compact_segments(IrValues values, int nbins, int n_seg,
                                                             int2* __restrict__ list,
                                                             int* __restrict__ seg_count) {
  __shared__ int warp_counts[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = blockIdx.x / n_seg;
  const int seg = static_cast<int>(blockIdx.x - row * n_seg);
  const int k0 = seg * kSeg;
  const int k_end = min(k0 + kSeg, nbins);
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

// The backward's kernels (see the note at the top): `stage_cotangent` forms
// g_eff, `convolve_back<Q, kSplit>` the transposed convolution, and, where
// the launch is split over segments, `combine_segments` adds the segments'
// partials.
constexpr int kChunk = 512;                        // bins of g_eff staged at once
constexpr int kBackOut = 4;                        // consecutive outputs a lane
constexpr int kBackTile = 32 * kWarps * kBackOut;  // outputs of a block
constexpr int kBackWindow = kBackTile + kChunk;    // carrier words staged (one spare)
static_assert(kSeg % kChunk == 0, "a segment is whole chunks");

// Q rows' chunk of g_eff and its carrier window: the words of one stage.
template <int Q>
__host__ __device__ constexpr int back_stage_words() {
  return kBackWindow + Q * kChunk;
}

// g_eff[r, k] for k < n_seg * kSeg (zeros past nbins), row stride n_seg *
// kSeg; flags[r * n_seg + s] = 1 where segment s of row r has a nonzero
// value (a NaN counts, -0.0 does not), else 0. One block a (row, segment).
__global__ void __launch_bounds__(kThreads) stage_cotangent(CotangentValues values, int nbins,
                                                            int n_seg, float* __restrict__ g_eff,
                                                            int* __restrict__ flags) {
  const long long row = blockIdx.x / n_seg;
  const int seg = static_cast<int>(blockIdx.x - row * n_seg);
  values.start_row(row);
  float* out = g_eff + row * n_seg * kSeg;
  bool any = false;
  for (int k = seg * kSeg + threadIdx.x; k < (seg + 1) * kSeg; k += kThreads) {
    const float v = k < nbins ? values(row, k) : 0.0f;
    out[k] = v;
    any = any || v != 0.0f;
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) flags[row * n_seg + seg] = any ? 1 : 0;
}

// out[r, x] = sum_y g_eff[r, y] * carrier[x + off - y] for the rows
// [Q * group, Q * group + Q) and one tile of kBackTile outputs x, each lane
// kBackOut neighbouring outputs. Per output, the taps of a 1,024-bin segment
// s of y form one chain of fused multiply-adds in ascending y from +0 (the
// segment's partial); the outputs are ((p_0 + p_1) + p_2) + ... over the
// segments in ascending order. A segment with no nonzero g_eff in any row of
// the group is skipped, and a chunk of it that the tile cannot reach: both
// would add exact zeros (see the note at the top).
//
// kSplit false: the block loops over the segments, partials and sums in
// registers, and writes out (row stride nbins); blockIdx.x = group *
// n_tiles + tile. kSplit true: the block takes one segment, blockIdx.x =
// (group * n_tiles + tile) * n_seg + s, and writes its partials (zeros where
// it skips the segment) to out as (rows, n_seg, n_tiles * kBackTile), for
// combine_segments.
template <int Q, bool kSplit>
__global__ void __launch_bounds__(kThreads) convolve_back(const float* __restrict__ carrier,
                                                          int nbins, int off, int n_seg,
                                                          int n_tiles, int m,
                                                          const float* __restrict__ g_eff,
                                                          const int* __restrict__ flags,
                                                          float* __restrict__ out) {
  constexpr int kStage = back_stage_words<Q>();
  extern __shared__ __align__(16) float smem[];
  const long long block = blockIdx.x;
  const int seg_only = kSplit ? static_cast<int>(block % n_seg) : -1;
  const long long gt = kSplit ? block / n_seg : block;
  const long long group = gt / n_tiles;
  const int tile = static_cast<int>(gt - group * n_tiles);
  const long long row0 = group * Q;
  const int x0 = tile * kBackTile;
  const int t0 = kBackOut * threadIdx.x;  // the lane's first output in the tile
  const long long stride = static_cast<long long>(n_seg) * kSeg;
  // Chunk c of y reaches an output of the tile iff x0 + off - (nbins - 1) <=
  // y <= x0 + kBackTile - 1 + off for some y of it: c_lo..c_hi.
  int c_lo = max(0, x0 + off - (nbins - 1)) / kChunk;
  int c_hi = min(nbins - 1, x0 + kBackTile - 1 + off) / kChunk;
  if (kSplit) {
    c_lo = max(c_lo, seg_only * (kSeg / kChunk));
    c_hi = min(c_hi, seg_only * (kSeg / kChunk) + kSeg / kChunk - 1);
  }
  auto seg_live = [&](int s) {
    bool live = false;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (row0 + q < m) live = live || flags[(row0 + q) * n_seg + s] != 0;
    }
    return live;
  };
  auto next_chunk = [&](int c) {
    do {
      ++c;
    } while (c <= c_hi && !seg_live(c / (kSeg / kChunk)));
    return c;
  };
  // Stage chunk c into buffer b: window word w is carrier[wb + w] (zero
  // outside the carrier), wb = x0 + off - (c * kChunk + kChunk - 1), so that
  // output x0 + t and bin c * kChunk + yl meet at word t + kChunk - 1 - yl;
  // then the Q rows' kChunk values of g_eff (zeros for rows past m).
  auto stage = [&](int c, int b) {
    float* win = smem + b * kStage;
    const int wb = x0 + off - (c * kChunk + kChunk - 1);
    for (int w = threadIdx.x; w < kBackWindow; w += kThreads) {
      const int idx = wb + w;
      const bool in = w < kBackWindow - 1 && idx >= 0 && idx < nbins;
      copy_async<4>(win + w, carrier + (in ? idx : 0), in);
    }
    float* gs = win + kBackWindow;
    for (int v = threadIdx.x; v < Q * kChunk / 4; v += kThreads) {
      const int q = v / (kChunk / 4), y = 4 * (v - q * (kChunk / 4));
      const bool in = row0 + q < m;
      copy_async<16>(gs + q * kChunk + y,
                     g_eff + (in ? (row0 + q) * stride + c * kChunk + y : 0), in);
    }
    copy_commit();
  };

  float part[Q][kBackOut], sum[Q][kBackOut];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
#pragma unroll
    for (int i = 0; i < kBackOut; ++i) part[q][i] = sum[q][i] = 0.0f;
  }
  int c = next_chunk(c_lo - 1);
  int b = 0;
  if (c <= c_hi) stage(c, 0);
  while (c <= c_hi) {
    const int c_next = next_chunk(c);
    if (c_next <= c_hi) {
      stage(c_next, b ^ 1);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();
    const float* win = smem + b * kStage + t0 + kChunk - kBackOut;
    const float* gs = smem + b * kStage + kBackWindow;
#pragma unroll 2
    for (int u = 0; u < kChunk / 4; ++u) {
      // Words (t0 + i) + kChunk - 1 - (4u + j) for i, j < 4: w[i - j + 3].
      const float4 w0 = *reinterpret_cast<const float4*>(win - 4 * u);
      const float4 w1 = *reinterpret_cast<const float4*>(win - 4 * u + 4);
      const float w[7] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z};
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float4 g4 = *reinterpret_cast<const float4*>(gs + q * kChunk + 4 * u);
        const float g[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int i = 0; i < kBackOut; ++i) {
            part[q][i] = __fmaf_rn(g[j], w[i - j + 3], part[q][i]);
          }
        }
      }
    }
    if (!kSplit && (c_next > c_hi || c_next / (kSeg / kChunk) != c / (kSeg / kChunk))) {
      // The segment's last chunk: its partial joins the sum, in segment order.
#pragma unroll
      for (int q = 0; q < Q; ++q) {
#pragma unroll
        for (int i = 0; i < kBackOut; ++i) {
          sum[q][i] = sum[q][i] + part[q][i];
          part[q][i] = 0.0f;
        }
      }
    }
    __syncthreads();  // buffer b is read before it is staged again
    c = c_next;
    b ^= 1;
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const long long row = row0 + q;
    if (row >= m) break;
    if (kSplit) {
      const long long pstride = static_cast<long long>(n_tiles) * kBackTile;
      *reinterpret_cast<float4*>(out + (row * n_seg + seg_only) * pstride + x0 + t0) =
          make_float4(part[q][0], part[q][1], part[q][2], part[q][3]);
    } else {
#pragma unroll
      for (int i = 0; i < kBackOut; ++i) {
        const int x = x0 + t0 + i;
        if (x < nbins) out[row * nbins + x] = sum[q][i];
      }
    }
  }
}

// g_ir[r, x] = ((p_0 + p_1) + p_2) + ... of the partials of a split launch,
// (m, n_seg, pstride), in segment order.
__global__ void __launch_bounds__(256) combine_segments(const float* __restrict__ partials,
                                                        int n_seg, long long pstride, int nbins,
                                                        long long total,
                                                        float* __restrict__ g_ir) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long row = e / nbins;
  const long long x = e - row * nbins;
  const float* p = partials + row * n_seg * pstride + x;
  float sum = 0.0f;
  for (int s = 0; s < n_seg; ++s) sum = sum + p[s * pstride];
  g_ir[e] = sum;
}

template <int Q, bool kSplit>
cudaError_t launch_convolve_back(const float* carrier, int m, int nbins, int off, int n_seg,
                                 const float* g_eff, const int* flags, float* out,
                                 cudaStream_t s) {
  constexpr size_t kBytes = 2 * sizeof(float) * back_stage_words<Q>();
  static_assert(kBytes <= 48 * 1024, "two stages fit the default dynamic shared memory");
  const int n_tiles = (nbins + kBackTile - 1) / kBackTile;
  const long long blocks = (static_cast<long long>(m) + Q - 1) / Q * n_tiles * (kSplit ? n_seg : 1);
  convolve_back<Q, kSplit><<<static_cast<unsigned>(blocks), kThreads, kBytes, s>>>(
      carrier, nbins, off, n_seg, n_tiles, m, g_eff, flags, out);
  return cudaGetLastError();
}

template <bool kSplit>
cudaError_t convolve_back_rows(const float* carrier, int m, int nbins, int off, int n_seg,
                               const float* g_eff, const int* flags, float* out,
                               cudaStream_t s) {
  // Eight rows a block share each staged carrier word; fewer rows than that
  // take one a block.
  return m >= 8 ? launch_convolve_back<8, kSplit>(carrier, m, nbins, off, n_seg, g_eff, flags,
                                                  out, s)
                : launch_convolve_back<1, kSplit>(carrier, m, nbins, off, n_seg, g_eff, flags,
                                                  out, s);
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

// The forward's launches: the compaction of the IRs and the convolution of
// the lists with the carrier at offset lo, into out.
cudaError_t compact_and_convolve(IrValues values, const float* carrier, int m, int nbins, int lo,
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
// to front. g_ir: (m, nbins) f32, every element written. Scratch: g_eff (m,
// n_seg * 1024) f32 and flags (m, n_seg) int32, n_seg = ceil(nbins / 1024);
// partials: null, or (m, n_seg, ceil(nbins / 512) * 512) f32 to split the
// launch over the segments (for launches of few blocks). Either way the same
// bits. The bounds of rfx_rx_power.
extern "C" int rfx_rx_power_backward(const void* g_dbm, const void* g_out, const void* out,
                                     const void* sums, const void* reversed_carrier, int m,
                                     int nbins, void* g_ir, void* g_eff, void* flags,
                                     void* partials, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const CotangentValues values{static_cast<const float*>(g_dbm), static_cast<const float*>(g_out),
                               static_cast<const float*>(out), static_cast<const float*>(sums),
                               nbins};
  const int n_seg = (nbins + kSeg - 1) / kSeg;
  stage_cotangent<<<static_cast<unsigned>(static_cast<long long>(m) * n_seg), kThreads, 0, s>>>(
      values, nbins, n_seg, static_cast<float*>(g_eff), static_cast<int*>(flags));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* carrier = static_cast<const float*>(reversed_carrier);
  const int hi = nbins - 1 - (nbins - 1) / 2;
  if (partials == nullptr) {
    return static_cast<int>(convolve_back_rows<false>(carrier, m, nbins, hi, n_seg,
                                                      static_cast<const float*>(g_eff),
                                                      static_cast<const int*>(flags),
                                                      static_cast<float*>(g_ir), s));
  }
  err = convolve_back_rows<true>(carrier, m, nbins, hi, n_seg, static_cast<const float*>(g_eff),
                                 static_cast<const int*>(flags), static_cast<float*>(partials), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(m) * nbins;
  const long long pstride = static_cast<long long>((nbins + kBackTile - 1) / kBackTile) * kBackTile;
  combine_segments<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(partials), n_seg, pstride, nbins, total, static_cast<float*>(g_ir));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rfx_rx_power_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* rfx_rx_power_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
