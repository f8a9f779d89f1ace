// Deterministic weighted histogram of captured path amplitudes into delay
// bins, for a batch of rows: the impulse responses (IRs).
//
// Replaces rfx/cir.py:_bincount_matmul, the XLA form that
// rfx.cir.bin_impulse_response takes on a TPU (two one-hot matmuls, because
// XLA's TPU scatter is slow), and the `vmap` of it over a receiver batch
// (rfx/coverage.py:190). The bin is computed here, from the distance, as the
// two IEEE f32 operations of rfx/cir.py:98 in their order, distance / c *
// rate, then truncated (hard mode, :120) or floored (the two halves of soft
// mode, :104-118). A path that is not captured, or whose bin falls outside
// [0, nbins), is dropped, per half.
//
// What bounds it on an H100: captures are sparse on every path that calls it
// (3,339 of 5,242,880 rays, 219 of 4,194,304 entries of one solver receiver),
// so the bytes the function needs are the mask (1 a ray), 8 for each capture
// and the bins out; at that size a call is bound by the latency of its
// launches, and at a solver batch (64 x 4,194,304 entries) by reading the
// mask at the memory rate. What the design does about it: the cost follows
// the captures, not the rays x bins.
//
//   1. `count_tiles`: a dense pass over the mask alone. A warp owns a tile of
//      2 KB of one row's mask, each lane loads four 16-byte words (all in
//      flight together, no shared memory, no block barrier) and counts their
//      nonzero bytes; one count a tile goes to device memory, and a tile of
//      at most four captures also leaves their positions there (8 bytes a
//      tile). A row that starts at an unaligned address is read from the
//      aligned word below it, and the bytes outside the row are masked off.
//   2. `scan_rows`: one block a row turns the tile counts into offsets (the
//      rank of a tile's first capture in its row); the block that finishes
//      last scans the rows' chunk counts. A chunk is 2,048 consecutive
//      captures of one row, counted from the row's first: the chunking of a
//      row depends on that row's mask alone.
//   3. `bin_chunks`: blocks take chunks (plane, row, k) from a counter. A
//      block lists its chunk's ray indices in ray order in shared memory (a
//      thread a sparse tile, from the positions pass 1 left; a warp a denser
//      tile, from the mask: re-reading the mask for every capture of a sparse
//      row cost 0.1 ms of dependent loads), loads distance and
//      amplitude of those alone, computes bin and weight, sorts (bin, rank)
//      with a bitonic network (ranks are unique, so the order inside a bin is
//      ray order), and the thread at the head of each run of equal bins adds
//      the run's weights in ray order. The block then waits for its row's
//      turn (chunk k - 1 of the same plane and row done) and adds its sums to
//      the row's bins with plain loads and stores: bins are distinct inside a
//      chunk, and chunks of a row take turns.
//
// There is no float atomic: a bin's value is the sum, in chunk order, of the
// chunks' ray-order sums, fixed by the row's own inputs. It is bit-identical
// from run to run, under any grid, and for a row alone or in a batch; for a
// row of at most 2,048 captures it is the sequential ray-order sum. Chunk ids
// are handed out by an atomic counter in increasing order, so a block waits
// only for a chunk that an earlier, already running block holds.
//
// Soft mode's two halves are two planes of one launch over one pass of the
// mask; the caller adds them (lo + hi), as the reference does.
//
// -fmad=false (rfx_torch/ops/_build.py) keeps soft mode's weights rounded
// as the plain PyTorch version rounds them.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileWords = 128;    // 16-byte words of mask a warp counts: 2 KB
constexpr int kLaneWords = kTileWords / 32;
constexpr int kSlots = 4;          // captures a tile lists in pass 1 (8 bytes a tile)
constexpr int kTileBatch = 4;      // tiles a thread of pass 3 reads at a time
constexpr int kCountThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kChunk = 2048;       // captures a block sorts at once
constexpr int kSortThreads = 512;
constexpr int kPerThread = kChunk / kSortThreads;
constexpr unsigned kNoBin = 0xFFFFFFFFu;

// ctrl: [0] rows scanned, [1] next chunk id, [2] chunks of one plane, [3]
// unused, then one turn counter per (plane, row).
constexpr int kCtrlHead = 4;

// Bit 7 of every nonzero byte of x (a bool tensor may hold any nonzero byte).
__device__ __forceinline__ unsigned nonzero_bytes(unsigned x) {
  return (x | ((x & 0x7f7f7f7fu) + 0x7f7f7f7fu)) & 0x80808080u;
}

// Bits 7, 15, 23, 31 gathered into bits 0-3.
__device__ __forceinline__ unsigned gather4(unsigned y) {
  return (((y >> 7) * 0x01020408u) >> 24) & 0xFu;
}

// Bit b set iff byte b of the word is nonzero and belongs to the row: `first`
// is the row's element index of byte 0 (negative in the row's first word when
// the row starts inside it), n the row's length.
__device__ __forceinline__ unsigned word_mask(const uint4 v, long long first, int n) {
  if ((v.x | v.y | v.z | v.w) == 0u) return 0u;
  unsigned m = gather4(nonzero_bytes(v.x)) | (gather4(nonzero_bytes(v.y)) << 4) |
               (gather4(nonzero_bytes(v.z)) << 8) | (gather4(nonzero_bytes(v.w)) << 12);
  if (first < 0) m &= 0xFFFFu << static_cast<int>(-first);
  const long long over = first + 16 - n;
  if (over > 0) m &= 0xFFFFu >> static_cast<int>(over);
  return m;
}

struct Row {
  const uint4* words;  // the aligned word that holds the row's first byte
  int shift;           // bytes of that word before the row
  int n_words;
};

__device__ __forceinline__ Row row_of(const unsigned char* mask, int r, int n) {
  const unsigned char* p = mask + static_cast<long long>(r) * n;
  Row row;
  row.shift = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15u);
  row.words = reinterpret_cast<const uint4*>(p - row.shift);
  row.n_words = static_cast<int>((static_cast<long long>(row.shift) + n + 15) / 16);
  return row;
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += up;
  }
  return v;
}

// Pass 1: cnt[r * tmax + t] = captures in tile t of row r. A tile of at
// most kSlots captures also leaves their byte offsets in the tile, in ray
// order, in slots[tile]: pass 3 then lists a sparse row's captures without
// reading the mask again.
__global__ void __launch_bounds__(kCountThreads) count_tiles(
    const unsigned char* __restrict__ mask, int n, long long n_tiles, int tmax,
    int* __restrict__ cnt, unsigned short* __restrict__ slots) {
  const int lane = threadIdx.x & 31;
  const long long tile =
      static_cast<long long>(blockIdx.x) * (kCountThreads / 32) + (threadIdx.x >> 5);
  if (tile >= n_tiles) return;
  const int r = static_cast<int>(tile / tmax);
  const int t = static_cast<int>(tile % tmax);
  const Row row = row_of(mask, r, n);
  uint4 v[kLaneWords];
#pragma unroll
  for (int j = 0; j < kLaneWords; ++j) {
    const int w = t * kTileWords + j * 32 + lane;
    v[j] = w < row.n_words ? row.words[w] : make_uint4(0u, 0u, 0u, 0u);
  }
  unsigned m[kLaneWords];
  int mine = 0;
#pragma unroll
  for (int j = 0; j < kLaneWords; ++j) {
    const long long first =
        static_cast<long long>(t * kTileWords + j * 32 + lane) * 16 - row.shift;
    m[j] = word_mask(v[j], first, n);
    mine += __popc(m[j]);
  }
  const int c = __reduce_add_sync(0xffffffffu, mine);
  if (lane == 0) cnt[tile] = c;
  if (c == 0 || c > kSlots) return;
  int before = 0;
#pragma unroll
  for (int j = 0; j < kLaneWords; ++j) {
    const int here = __popc(m[j]);
    const int incl = warp_inclusive_scan(here, lane);
    int pos = before + incl - here;
    for (unsigned mm = m[j]; mm != 0u; mm &= mm - 1u) {
      slots[tile * kSlots + pos++] =
          static_cast<unsigned short>((j * 32 + lane) * 16 + __ffs(mm) - 1);
    }
    before += __shfl_sync(0xffffffffu, incl, 31);
  }
}

// Exclusive scan of one value a thread over the block, plus `carry`; returns
// the thread's offset and leaves the new carry (offset past the last thread)
// in *carry after the closing barrier.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums, int* carry) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int incl = warp_inclusive_scan(v, lane);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int s = warp_sums[lane];
    warp_sums[lane] = warp_inclusive_scan(s, lane) - s;
  }
  __syncthreads();
  const int excl = *carry + warp_sums[warp] + incl - v;
  __syncthreads();
  if (threadIdx.x == kScanThreads - 1) *carry = excl + v;
  __syncthreads();
  return excl;
}

// Pass 2: off[r * (tmax + 1) + t] = captures of row r before tile t (entry
// tmax: the row's total); the last block to finish writes cpre[r] = chunks of
// the rows before r (entry R: all) and ctrl[2] = cpre[R].
__global__ void __launch_bounds__(kScanThreads) scan_rows(
    const int* __restrict__ cnt, int tmax, int n_rows, int* __restrict__ off,
    int* __restrict__ cpre, int* __restrict__ ctrl) {
  __shared__ int warp_sums[32];
  __shared__ int carry;
  __shared__ bool last;
  const int r = blockIdx.x;
  const int* row_cnt = cnt + static_cast<long long>(r) * tmax;
  int* row_off = off + static_cast<long long>(r) * (tmax + 1);
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < tmax; base += kScanThreads) {
    const int t = base + threadIdx.x;
    const int excl = block_exclusive_scan(t < tmax ? row_cnt[t] : 0, warp_sums, &carry);
    if (t < tmax) row_off[t] = excl;
  }
  if (threadIdx.x == 0) {
    row_off[tmax] = carry;
    __threadfence();
    last = atomicAdd(&ctrl[0], 1) == n_rows - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < n_rows; base += kScanThreads) {
    const int i = base + threadIdx.x;
    int chunks = 0;
    if (i < n_rows) {
      const int total = __ldcg(off + static_cast<long long>(i) * (tmax + 1) + tmax);
      chunks = (total + kChunk - 1) / kChunk;
    }
    const int excl = block_exclusive_scan(chunks, warp_sums, &carry);
    if (i < n_rows) cpre[i] = excl;
  }
  if (threadIdx.x == 0) {
    cpre[n_rows] = carry;
    ctrl[2] = carry;
  }
}

// The largest i in [0, len) with a[i] <= x (a is nondecreasing, a[0] <= x),
// found by the whole block: every round the threads sample the range at
// kSortThreads points and the one whose sample brackets x narrows it, so a
// row of 2,561 tiles takes two rounds where a binary search by one thread
// takes twelve dependent loads. Ends with a barrier.
__device__ __forceinline__ int block_last_at_most(const int* __restrict__ a, int len, int x,
                                                  int* s_pos) {
  int lo = 0, hi = len;
  while (hi - lo > 1) {
    const int step = (hi - lo + kSortThreads - 1) / kSortThreads;
    const long long i = lo + static_cast<long long>(threadIdx.x) * step;
    if (i < hi && a[i] <= x && (i + step >= hi || a[i + step] > x)) *s_pos = static_cast<int>(i);
    __syncthreads();
    lo = *s_pos;
    hi = min(lo + step, hi);
    __syncthreads();
  }
  return lo;
}

// mode 0: hard, bin = trunc(delay), weight = amp.
// mode 1: soft low half, bin = floor(delay), weight = amp * (1 - frac).
// mode 2: soft high half, bin = floor(delay) + 1, weight = amp * frac.
__device__ __forceinline__ unsigned bin_and_weight(float amp, float dist, float c, float rate,
                                                   int nbins, int mode, float* w) {
  const float delay = dist / c * rate;
  int bin;
  if (mode == 0) {
    bin = static_cast<int>(delay);
    *w = amp;
  } else {
    const float lo = floorf(delay);
    const float frac = delay - lo;
    bin = static_cast<int>(lo) + (mode == 2 ? 1 : 0);
    *w = mode == 2 ? amp * frac : amp * (1.0f - frac);
  }
  return bin >= 0 && bin < nbins ? static_cast<unsigned>(bin) : kNoBin;
}

// Pass 3: see the note at the top. out: (planes, n_rows, nbins), zeroed.
__global__ void __launch_bounds__(kSortThreads) bin_chunks(
    const float* __restrict__ amp, const float* __restrict__ dist,
    const unsigned char* __restrict__ mask, int n, int n_rows, int planes, float c, float rate,
    int nbins, int tmax, const int* __restrict__ off, const int* __restrict__ cpre,
    const unsigned short* __restrict__ slots, int* __restrict__ ctrl, float* __restrict__ out) {
  __shared__ int s_idx[kChunk];
  __shared__ unsigned long long s_key[kChunk];
  __shared__ float s_w[kChunk];
  __shared__ int s_tiles[kChunk / (kSlots + 1) + 2];  // the chunk's dense tiles
  __shared__ int s_dense;
  __shared__ int s_pos;
  __shared__ int s_work;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = ctrl[2];
  for (;;) {
    if (threadIdx.x == 0) s_work = atomicAdd(&ctrl[1], 1);
    __syncthreads();
    const int work = s_work;
    if (work >= planes * chunks) return;
    const int plane = work / chunks;
    const int chunk = work - plane * chunks;
    const int r = block_last_at_most(cpre, n_rows + 1, chunk, &s_pos);
    const int k = chunk - cpre[r];
    const int* row_off = off + static_cast<long long>(r) * (tmax + 1);
    const int lo = k * kChunk;
    const int count = min(kChunk, row_off[tmax] - lo);
    const Row row = row_of(mask, r, n);

    // The chunk's captures, in ray order: a sparse tile's from the offsets
    // that pass 1 left, a dense tile's from the mask, a warp a tile.
    const int t_first = block_last_at_most(row_off, tmax + 1, lo, &s_pos);
    const int t_end = block_last_at_most(row_off, tmax + 1, lo + count - 1, &s_pos) + 1;
    if (threadIdx.x == 0) s_dense = 0;
    __syncthreads();
    // kTileBatch tiles a thread at a time, their loads issued together.
    for (int t0 = t_first + threadIdx.x; t0 < t_end; t0 += kTileBatch * kSortThreads) {
      int rank[kTileBatch], c[kTileBatch];
      uint2 slot[kTileBatch];
#pragma unroll
      for (int u = 0; u < kTileBatch; ++u) {
        const int t = t0 + u * kSortThreads;
        rank[u] = t < t_end ? row_off[t] : 0;
        c[u] = t < t_end ? row_off[t + 1] - rank[u] : 0;
        // All of a tile's slots, whether pass 1 wrote them or not: 8 aligned bytes.
        slot[u] = t < t_end ? reinterpret_cast<const uint2*>(slots)[static_cast<long long>(r) * tmax + t]
                            : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kTileBatch; ++u) {
        const int t = t0 + u * kSortThreads;
        if (c[u] > kSlots) {
          s_tiles[atomicAdd(&s_dense, 1)] = t;
        } else {
          for (int q = 0; q < c[u]; ++q) {
            const unsigned pair = q < 2 ? slot[u].x : slot[u].y;
            const int pos = rank[u] + q - lo;
            if (pos >= 0 && pos < count) {
              s_idx[pos] = t * (kTileWords * 16) + static_cast<int>((pair >> (16 * (q & 1))) & 0xFFFFu) -
                           row.shift;
            }
          }
        }
      }
    }
    __syncthreads();
    for (int d = warp; d < s_dense; d += kSortThreads / 32) {
      const int t = s_tiles[d];
      unsigned m[kLaneWords];
#pragma unroll
      for (int j = 0; j < kLaneWords; ++j) {
        const int w = t * kTileWords + j * 32 + lane;
        const long long first = static_cast<long long>(w) * 16 - row.shift;
        m[j] = w < row.n_words ? word_mask(row.words[w], first, n) : 0u;
      }
      int rank = row_off[t] - lo;
#pragma unroll
      for (int j = 0; j < kLaneWords; ++j) {
        const int here = __popc(m[j]);
        const int incl = warp_inclusive_scan(here, lane);
        int pos = rank + incl - here;
        const int first = (t * kTileWords + j * 32 + lane) * 16 - row.shift;
        for (unsigned mm = m[j]; mm != 0u; mm &= mm - 1u, ++pos) {
          if (pos >= 0 && pos < count) s_idx[pos] = first + __ffs(mm) - 1;
        }
        rank += __shfl_sync(0xffffffffu, incl, 31);
      }
    }
    __syncthreads();

    // Keys (bin, rank in the chunk); a dropped capture and the padding sort last.
    int size = 32;
    while (size < count) size <<= 1;
    const int mode = planes == 1 ? 0 : 1 + plane;
    const long long base = static_cast<long long>(r) * n;
    float a_in[kPerThread], d_in[kPerThread];
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {  // the gathers of a thread, issued together
      const int i = threadIdx.x + q * kSortThreads;
      const long long g = base + (i < count ? s_idx[i] : 0);
      a_in[q] = i < count ? amp[g] : 0.0f;
      d_in[q] = i < count ? dist[g] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int i = threadIdx.x + q * kSortThreads;
      if (i >= size) break;
      unsigned bin = kNoBin;
      if (i < count) {
        float w;
        bin = bin_and_weight(a_in[q], d_in[q], c, rate, nbins, mode, &w);
        s_w[i] = w;
      }
      s_key[i] = (static_cast<unsigned long long>(bin) << 32) | static_cast<unsigned>(i);
    }
    __syncthreads();
    // Bitonic network, a thread a pair. Strides up to 32 stay inside the 64
    // keys a warp's 32 pairs cover, so those stages need no block barrier.
    const int half = size >> 1;
    for (int span = 2; span <= size; span <<= 1) {
      for (int j = span >> 1; j > 0; j >>= 1) {
        for (int p = threadIdx.x; p < half; p += kSortThreads) {
          const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
          const unsigned long long a = s_key[i], b = s_key[i | j];
          if ((a > b) == ((i & span) == 0)) {
            s_key[i] = b;
            s_key[i | j] = a;
          }
        }
        const int next = j > 1 ? j >> 1 : (span < size ? span : 64);
        if (j > 32 || next > 32) __syncthreads(); else __syncwarp();
      }
    }

    // The head of each run of equal bins adds the run in ray order.
    unsigned bins[kPerThread];
    float sums[kPerThread];
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int i = threadIdx.x + q * kSortThreads;
      bins[q] = kNoBin;
      sums[q] = 0.0f;
      if (i < count) {
        const unsigned bin = static_cast<unsigned>(s_key[i] >> 32);
        if (bin != kNoBin && (i == 0 || static_cast<unsigned>(s_key[i - 1] >> 32) != bin)) {
          float s = 0.0f;
          for (int j = i; j < count && static_cast<unsigned>(s_key[j] >> 32) == bin; ++j) {
            s += s_w[static_cast<unsigned>(s_key[j])];
          }
          bins[q] = bin;
          sums[q] = s;
        }
      }
    }

    // The row's chunks add in turn.
    int* turn = ctrl + kCtrlHead + plane * n_rows + r;
    if (threadIdx.x == 0) {
      while (atomicAdd(turn, 0) != k) __nanosleep(32);
      __threadfence();
    }
    __syncthreads();
    float* row_out = out + (static_cast<long long>(plane) * n_rows + r) * nbins;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      if (bins[q] != kNoBin) {  // the row's first chunk finds zeros
        __stcg(row_out + bins[q], (k == 0 ? 0.0f : __ldcg(row_out + bins[q])) + sums[q]);
      }
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) atomicExch(turn, k + 1);
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return count;
}

}  // namespace

// amp, dist: (n_rows, n) f32; captured: (n_rows, n) bool, rows back to back.
// out: (soft ? 2 : 1, n_rows, nbins) f32, and behind it ctrl: 4 + planes *
// n_rows int32; `zero_bytes` from `out` on (both of them) are set to 0 here.
// scratch, 8-byte aligned: n_rows * tmax * 4 uint16, then n_rows * tmax +
// n_rows * (tmax + 1) + n_rows + 1 int32; tmax: the
// 2 KB tiles a row of n bytes can span when it starts up to 15 bytes into its
// first 16-byte word (rfx_torch.cir.mask_tiles). n_rows > 0, n > 0.
extern "C" int rfx_ir_histogram(const void* amp, const void* dist, const void* captured, int n,
                                int n_rows, float c, float rate, int nbins, int soft, int tmax,
                                void* scratch, void* out, void* ctrl, long long zero_bytes,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int planes = soft ? 2 : 1;
  unsigned short* slots = static_cast<unsigned short*>(scratch);
  int* cnt = static_cast<int*>(scratch) + 2LL * n_rows * tmax;
  int* off = cnt + static_cast<long long>(n_rows) * tmax;
  int* cpre = off + static_cast<long long>(n_rows) * (tmax + 1);
  cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(zero_bytes), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_tiles = static_cast<long long>(n_rows) * tmax;
  const int warps = kCountThreads / 32;
  count_tiles<<<static_cast<unsigned>((n_tiles + warps - 1) / warps), kCountThreads, 0, s>>>(
      static_cast<const unsigned char*>(captured), n, n_tiles, tmax, cnt, slots);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_rows<<<n_rows, kScanThreads, 0, s>>>(cnt, tmax, n_rows, off, cpre,
                                            static_cast<int*>(ctrl));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long most = static_cast<long long>(planes) * n_rows * ((n + kChunk - 1) / kChunk);
  const long long resident = 4LL * sm_count();
  bin_chunks<<<static_cast<unsigned>(most < resident ? most : resident), kSortThreads, 0, s>>>(
      static_cast<const float*>(amp), static_cast<const float*>(dist),
      static_cast<const unsigned char*>(captured), n, n_rows, planes, c, rate, nbins, tmax, off,
      cpre, slots, static_cast<int*>(ctrl), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rfx_ir_histogram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
