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
// The record entry, rfx_ir_histogram_record, bins the map engine's
// first-capture record (map_capture.cu): one byte per receiver and ray, the
// bounce b of the receiver's first capture or 0xFF. Row r's list is the
// list that the dense entry takes from the map engine's dense rows (the
// (b, n) order of the B x N segments): a capture's weight is amp[b, n] *
// scale and its length dist[b, n] + t_rx, t_rx recomputed with sphere.cuh's
// sphere_t, the capture pass's bits. Pass 1 reads each record tile once and
// counts it per bounce, so a row's tiles run (bounce, tile) and the scan
// gives (b, n) ranks; passes 2 and 3 are the dense entry's, with the loader
// and the tile reader templated on the source. So the record's IRs are the
// dense rows' bits, and the 9 bytes an entry of the rows are never written
// (2.4 GB at the inverse solve's 64 receivers x 4 bounces x 1,048,576 rays,
// against a 64 MB record). rfx_ir_histogram_record_ico bins the icosphere
// receiver's record (map_capture.cu's rfx_map_capture_ico): t_rx is read
// from the t_first that the capture pass wrote beside the record at each
// capture (the closest hit over the receiver's 80 faces, found once there),
// so the IRs are the plain icosphere rows' bits, hard and soft, and no face
// is tested here.
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

#include "sphere.cuh"

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

// What passes 1 and 3 read: the dense rows (the capture mask, amplitude
// and distance of each entry) or the record with the segments it indexes.
struct Source {
  const unsigned char* mask;  // (rows, n) bytes: the capture mask, or the record
  int n;                      // bytes a row
  int nb;                     // record: bounces (a row's tiles run bounce-major); dense: 1
  int tmax;                   // tiles a row of n bytes can span
  const float* amp;           // dense: (rows, n); record: (nb, n), scaled here
  const float* dist;          // dense: (rows, n); record: (nb, n), t_rx added here
  const float* origin;        // record: (nb, n, 3)
  const float* dir;           // record: (nb, n, 3)
  const float* centers;       // record: (rows, 3)
  float r2, scale;            // record: radius^2, amplitude scale
  const float* t_first;       // icosphere record: (rows, n), each capture's t_rx
};

// Bit 7 of every nonzero byte of x (a bool tensor may hold any nonzero byte).
__device__ __forceinline__ unsigned nonzero_bytes(unsigned x) {
  return (x | ((x & 0x7f7f7f7fu) + 0x7f7f7f7fu)) & 0x80808080u;
}

// Bit 7 of every zero byte of x.
__device__ __forceinline__ unsigned zero_byte_bits(unsigned x) {
  return ~nonzero_bytes(x) & 0x80808080u;
}

// Bits 7, 15, 23, 31 gathered into bits 0-3.
__device__ __forceinline__ unsigned gather4(unsigned y) {
  return (((y >> 7) * 0x01020408u) >> 24) & 0xFu;
}

// Bit k set iff byte k of the word is a capture and belongs to the row: a
// nonzero byte of the mask, or a record byte equal to the bounce b whose
// copies fill `pattern`. `first` is the row's element index of byte 0
// (negative in the row's first word when the row starts inside it), n the
// row's length.
template <bool kRecord>
__device__ __forceinline__ unsigned word_mask(const uint4 v, unsigned pattern, long long first,
                                              int n) {
  unsigned m;
  if (kRecord) {
    if ((v.x & v.y & v.z & v.w) == 0xFFFFFFFFu) return 0u;  // no capture at all
    m = gather4(zero_byte_bits(v.x ^ pattern)) | (gather4(zero_byte_bits(v.y ^ pattern)) << 4) |
        (gather4(zero_byte_bits(v.z ^ pattern)) << 8) | (gather4(zero_byte_bits(v.w ^ pattern)) << 12);
  } else {
    if ((v.x | v.y | v.z | v.w) == 0u) return 0u;
    m = gather4(nonzero_bytes(v.x)) | (gather4(nonzero_bytes(v.y)) << 4) |
        (gather4(nonzero_bytes(v.z)) << 8) | (gather4(nonzero_bytes(v.w)) << 12);
  }
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

// Pass 1: a warp reads tile t of row r (2 KB) once. Dense: cnt[r * tmax +
// t] = its captures; record: cnt[(r * nb + b) * tmax + t] = its captures at
// bounce b, for every b (a row's tiles run bounce-major, so the scan of a
// row's counts gives (b, n) ranks). A (tile, bounce) of at most kSlots
// captures also leaves their byte offsets in the tile, in ray order, in its
// slots: pass 3 then lists a sparse row's captures without reading the mask
// again.
template <bool kRecord>
__global__ void __launch_bounds__(kCountThreads) count_tiles(const Source src, long long n_tiles,
                                                             int* __restrict__ cnt,
                                                             unsigned short* __restrict__ slots) {
  const int lane = threadIdx.x & 31;
  const long long tile =
      static_cast<long long>(blockIdx.x) * (kCountThreads / 32) + (threadIdx.x >> 5);
  if (tile >= n_tiles) return;
  const int r = static_cast<int>(tile / src.tmax);
  const int t = static_cast<int>(tile % src.tmax);
  const int nb = kRecord ? src.nb : 1;
  const Row row = row_of(src.mask, r, src.n);
  uint4 v[kLaneWords];
  bool some = false;
#pragma unroll
  for (int j = 0; j < kLaneWords; ++j) {
    const int w = t * kTileWords + j * 32 + lane;
    const unsigned pad = kRecord ? 0xFFFFFFFFu : 0u;  // reads as no capture
    v[j] = w < row.n_words ? row.words[w] : make_uint4(pad, pad, pad, pad);
    some |= kRecord ? (v[j].x & v[j].y & v[j].z & v[j].w) != 0xFFFFFFFFu
                    : (v[j].x | v[j].y | v[j].z | v[j].w) != 0u;
  }
  const long long vt0 = static_cast<long long>(r) * nb * src.tmax + t;  // bounce 0's tile
  if (!__any_sync(0xffffffffu, some)) {  // no capture in the tile
    for (int b = lane; b < nb; b += 32) cnt[vt0 + static_cast<long long>(b) * src.tmax] = 0;
    return;
  }
  for (int b = 0; b < nb; ++b) {
    const long long vt = vt0 + static_cast<long long>(b) * src.tmax;
    const unsigned pattern = static_cast<unsigned>(b) * 0x01010101u;
    unsigned m[kLaneWords];
    int mine = 0;
#pragma unroll
    for (int j = 0; j < kLaneWords; ++j) {
      const long long first =
          static_cast<long long>(t * kTileWords + j * 32 + lane) * 16 - row.shift;
      m[j] = word_mask<kRecord>(v[j], pattern, first, src.n);
      mine += __popc(m[j]);
    }
    const int c = __reduce_add_sync(0xffffffffu, mine);
    if (lane == 0) cnt[vt] = c;
    if (c == 0 || c > kSlots) continue;
    int before = 0;
#pragma unroll
    for (int j = 0; j < kLaneWords; ++j) {
      const int here = __popc(m[j]);
      const int incl = warp_inclusive_scan(here, lane);
      int pos = before + incl - here;
      for (unsigned mm = m[j]; mm != 0u; mm &= mm - 1u) {
        slots[vt * kSlots + pos++] =
            static_cast<unsigned short>((j * 32 + lane) * 16 + __ffs(mm) - 1);
      }
      before += __shfl_sync(0xffffffffu, incl, 31);
    }
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

// A capture's weight and length, *a and *d, from its index in the row's
// list: dense, entry idx of row r; record, segment idx = b * n + ray of the
// segments, scaled and lengthened as the capture pass's rows would hold it
// (kIco: t_rx the capture pass's, t_first[r, ray]).
template <bool kRecord, bool kIco>
__device__ __forceinline__ void load_capture(const Source& src, int r, float4 ctr, int idx,
                                             float* a, float* d) {
  if (kRecord) {
    const long long at = idx;
    const float amp = src.amp[at], dist = src.dist[at];
    float t_rx;
    if constexpr (kIco) {
      t_rx = src.t_first[static_cast<long long>(r) * src.n + idx % src.n];
    } else {
      t_rx = rfx_capture::sphere_t(src.origin[3 * at], src.origin[3 * at + 1],
                                   src.origin[3 * at + 2], src.dir[3 * at], src.dir[3 * at + 1],
                                   src.dir[3 * at + 2], ctr.x, ctr.y, ctr.z, src.r2);
    }
    *a = amp * src.scale;
    *d = dist + t_rx;
  } else {
    const long long g = static_cast<long long>(r) * src.n + idx;
    *a = src.amp[g];
    *d = src.dist[g];
  }
}

// Pass 3: see the note at the top. A row has tiles = nb * tmax tiles (dense:
// nb = 1), tile vt holding bounce vt / tmax of the row's bytes of tile vt %
// tmax. out: (planes, n_rows, nbins), zeroed.
template <bool kRecord, bool kIco>
__global__ void __launch_bounds__(kSortThreads) bin_chunks(
    const Source src, int n_rows, int planes, float c, float rate, int nbins,
    const int* __restrict__ off, const int* __restrict__ cpre,
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
  const int n = src.n, tmax = src.tmax;
  const int tiles = (kRecord ? src.nb : 1) * tmax;
  for (;;) {
    if (threadIdx.x == 0) s_work = atomicAdd(&ctrl[1], 1);
    __syncthreads();
    const int work = s_work;
    if (work >= planes * chunks) return;
    const int plane = work / chunks;
    const int chunk = work - plane * chunks;
    const int r = block_last_at_most(cpre, n_rows + 1, chunk, &s_pos);
    const int k = chunk - cpre[r];
    const int* row_off = off + static_cast<long long>(r) * (tiles + 1);
    const int lo = k * kChunk;
    const int count = min(kChunk, row_off[tiles] - lo);
    const Row row = row_of(src.mask, r, n);

    // The chunk's captures, in (b, n) order: a sparse tile's from the
    // offsets that pass 1 left, a dense tile's from the mask, a warp a tile.
    const int t_first = block_last_at_most(row_off, tiles + 1, lo, &s_pos);
    const int t_end = block_last_at_most(row_off, tiles + 1, lo + count - 1, &s_pos) + 1;
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
        slot[u] = t < t_end ? reinterpret_cast<const uint2*>(slots)[static_cast<long long>(r) * tiles + t]
                            : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kTileBatch; ++u) {
        const int t = t0 + u * kSortThreads;
        if (c[u] > kSlots) {
          s_tiles[atomicAdd(&s_dense, 1)] = t;
        } else if (c[u] > 0) {
          const int b = t / tmax;  // dense: 0
          const int base = b * n + (t - b * tmax) * (kTileWords * 16) - row.shift;
          for (int q = 0; q < c[u]; ++q) {
            const unsigned pair = q < 2 ? slot[u].x : slot[u].y;
            const int pos = rank[u] + q - lo;
            if (pos >= 0 && pos < count) {
              s_idx[pos] = base + static_cast<int>((pair >> (16 * (q & 1))) & 0xFFFFu);
            }
          }
        }
      }
    }
    __syncthreads();
    for (int d = warp; d < s_dense; d += kSortThreads / 32) {
      const int vt = s_tiles[d];
      const int b = vt / tmax;  // dense: 0
      const int t = vt - b * tmax;
      const unsigned pattern = static_cast<unsigned>(b) * 0x01010101u;
      unsigned m[kLaneWords];
#pragma unroll
      for (int j = 0; j < kLaneWords; ++j) {
        const int w = t * kTileWords + j * 32 + lane;
        const long long first = static_cast<long long>(w) * 16 - row.shift;
        m[j] = w < row.n_words ? word_mask<kRecord>(row.words[w], pattern, first, n) : 0u;
      }
      int rank = row_off[vt] - lo;
#pragma unroll
      for (int j = 0; j < kLaneWords; ++j) {
        const int here = __popc(m[j]);
        const int incl = warp_inclusive_scan(here, lane);
        int pos = rank + incl - here;
        const int first = b * n + (t * kTileWords + j * 32 + lane) * 16 - row.shift;
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
    const float4 ctr = kRecord ? make_float4(src.centers[3 * r], src.centers[3 * r + 1],
                                             src.centers[3 * r + 2], 0.0f)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float a_in[kPerThread], d_in[kPerThread];
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {  // the gathers of a thread, issued together
      const int i = threadIdx.x + q * kSortThreads;
      a_in[q] = d_in[q] = 0.0f;
      if (i < count) load_capture<kRecord, kIco>(src, r, ctr, s_idx[i], &a_in[q], &d_in[q]);
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

    // The head of each run of equal bins adds the run in list order.
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

// The three passes over `src`'s n_rows rows; the layouts of the C entries.
template <bool kRecord, bool kIco = false>
int histogram(const Source& src, int n_rows, float c, float rate, int nbins, int soft,
              void* scratch, void* out, void* ctrl, long long zero_bytes, cudaStream_t s) {
  const int planes = soft ? 2 : 1;
  const long long tiles = static_cast<long long>(kRecord ? src.nb : 1) * src.tmax;
  unsigned short* slots = static_cast<unsigned short*>(scratch);
  int* cnt = static_cast<int*>(scratch) + 2LL * n_rows * tiles;
  int* off = cnt + n_rows * tiles;
  int* cpre = off + n_rows * (tiles + 1);
  cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(zero_bytes), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_tiles = static_cast<long long>(n_rows) * src.tmax;  // a warp each
  const int warps = kCountThreads / 32;
  count_tiles<kRecord><<<static_cast<unsigned>((n_tiles + warps - 1) / warps), kCountThreads, 0,
                         s>>>(src, n_tiles, cnt, slots);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_rows<<<n_rows, kScanThreads, 0, s>>>(cnt, static_cast<int>(tiles), n_rows, off, cpre,
                                            static_cast<int*>(ctrl));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long row_len = static_cast<long long>(kRecord ? src.nb : 1) * src.n;
  const long long most = static_cast<long long>(planes) * n_rows * ((row_len + kChunk - 1) / kChunk);
  const long long resident = 4LL * sm_count();
  bin_chunks<kRecord, kIco><<<static_cast<unsigned>(most < resident ? most : resident), kSortThreads,
                        0, s>>>(src, n_rows, planes, c, rate, nbins, off, cpre, slots,
                                static_cast<int*>(ctrl), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
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
  Source src{};
  src.mask = static_cast<const unsigned char*>(captured);
  src.n = n;
  src.nb = 1;
  src.tmax = tmax;
  src.amp = static_cast<const float*>(amp);
  src.dist = static_cast<const float*>(dist);
  return histogram<false>(src, n_rows, c, rate, nbins, soft, scratch, out, ctrl, zero_bytes,
                          static_cast<cudaStream_t>(stream));
}

// record: (n_rows, n) uint8, rfx_map_capture's first-capture record of the
// n_rows receivers `centers` ((n_rows, 3) f32) on the segments origin, dir
// ((nb, n, 3) f32), amp and dist ((nb, n) f32); radius and scale as the
// capture pass takes them. out, ctrl, zero_bytes: as rfx_ir_histogram's;
// scratch as its, with nb * tmax tiles a row in place of tmax (tmax =
// rfx_torch.cir.mask_tiles(n)). n_rows > 0, n > 0, 1 <= nb <= 254, nb * n
// < 2^31.
extern "C" int rfx_ir_histogram_record(const void* record, int n, int n_rows, int nb,
                                       const void* origin, const void* dir, const void* amp,
                                       const void* dist, const void* centers, float radius,
                                       float scale, float c, float rate, int nbins, int soft,
                                       int tmax, void* scratch, void* out, void* ctrl,
                                       long long zero_bytes, void* stream) {
  Source src{};
  src.mask = static_cast<const unsigned char*>(record);
  src.n = n;
  src.nb = nb;
  src.tmax = tmax;
  src.amp = static_cast<const float*>(amp);
  src.dist = static_cast<const float*>(dist);
  src.origin = static_cast<const float*>(origin);
  src.dir = static_cast<const float*>(dir);
  src.centers = static_cast<const float*>(centers);
  src.r2 = radius * radius;
  src.scale = scale;
  return histogram<true>(src, n_rows, c, rate, nbins, soft, scratch, out, ctrl, zero_bytes,
                         static_cast<cudaStream_t>(stream));
}

// rfx_ir_histogram_record for rfx_map_capture_ico's record: t_first (n_rows,
// n) f32, the t that rfx_map_capture_ico wrote beside the record (read only
// where the record names a capture). The other arguments as
// rfx_ir_histogram_record's, without the segments' origin and direction,
// the centers and the radius.
extern "C" int rfx_ir_histogram_record_ico(const void* record, int n, int n_rows, int nb,
                                           const void* amp, const void* dist, const void* t_first,
                                           float scale, float c, float rate, int nbins, int soft,
                                           int tmax, void* scratch, void* out, void* ctrl,
                                           long long zero_bytes, void* stream) {
  Source src{};
  src.mask = static_cast<const unsigned char*>(record);
  src.n = n;
  src.nb = nb;
  src.tmax = tmax;
  src.amp = static_cast<const float*>(amp);
  src.dist = static_cast<const float*>(dist);
  src.t_first = static_cast<const float*>(t_first);
  src.scale = scale;
  return histogram<true, true>(src, n_rows, c, rate, nbins, soft, scratch, out, ctrl, zero_bytes,
                               static_cast<cudaStream_t>(stream));
}

extern "C" const char* rfx_ir_histogram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* rfx_ir_histogram_record_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* rfx_ir_histogram_record_ico_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
