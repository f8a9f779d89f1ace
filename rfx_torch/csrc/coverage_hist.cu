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
// What bounds it on an H100: arithmetic. B x N x M discriminants (4.3e9 for
// 2,048 receivers and 2 x 1,048,576 segments) of 17 f32 operations each, and
// without multiply-add contraction each is an instruction. Captures are
// sparse (about one test in a thousand finds disc > 0), and the segments are
// 29 bytes each that many warps want at once. What the design does about it:
//
// - A warp is the unit of work, and it owns its rows. A warp takes kRx
//   receivers (their centers in shared memory, read as one broadcast float4
//   per test) and one slab of rays, and it alone adds to those receivers'
//   rows of that slab's plane of the output, in global memory. So there is no
//   histogram in shared memory (the bins are bounded by `int`, not by the
//   SM), no block-wide barrier, no final copy and no add that races with
//   another warp's; the kWarps warps of a block take neighbouring receivers
//   and walk the same rays, so that one of them brings a segment into the L1
//   and the others find it there.
// - Each lane holds kRays segments in registers across all kRx tests, so a
//   center is loaded once for kRays tests and the kRays dependency chains
//   overlap; the next step's segments are loaded before this step's tests.
//   The hot loop computes the discriminant only, the expressions of sphere_t
//   in its order, and notes `disc > 0` in a bit mask; dead segments never set
//   a bit, and a chunk whose segments are all dead (Morton-ordered rays leave
//   the scene together) is skipped by the whole warp.
// - The rare lanes with a bit set finish those tests (`capture`: the roots,
//   the rule t_rx < 1e29 && t_env > t_rx, the first win per ray, the bin) and
//   leave bin and amplitude in the warp's scratch in shared memory. Then, per
//   ray slot and receiver that was won, the winning lanes group by bin
//   (__match_any_sync), each group's lowest lane sums the group's amplitudes
//   in lane order and adds the sum to the row with a plain load, add and
//   store. No atomics: no other warp adds to that row, two adds of one step
//   never name the same bin, and the __syncwarp between steps orders one
//   step's stores before the next step's loads. (A reduction instruction,
//   atomicAdd with its result unused, spares the lane the wait for the bin;
//   it gave the same bits and 1-2% of the kernel's time, PERF.md, and was not
//   kept: the result would rest on the order in which the card applies a
//   warp's barrier-ordered atomics to one address.)
// - The rays are split into slabs so that there are enough warps for the
//   card: the grid is (receivers / (kWarps * kRx)) x (slabs). Chunk j of
//   32 * kRays rays belongs to slab j % slabs (neighbours in Morton order
//   reach the same receivers, so a receiver's captures spread over all
//   slabs), slab h writes plane h of (slabs, M, nbins), and
//   rfx_coverage_hist_reduce adds the planes per bin in slab order. The
//   number of slabs is the caller's and depends on the ray count alone
//   (rfx_torch.ops.coverage_hist.coverage_slabs).
//
// A receiver's bin is therefore summed in an order that only the ray count
// fixes (slab, chunk, bounce, ray slot, lane): the same bits on every run and
// for a receiver alone or in any group. It is not the plain version's order
// ((bounce, ray)), from which the values differ by rounding only.
//
// Not carried over from the TPU kernel: the one-hot MXU histogram, its
// transposed accumulator, the 128-segment subtile gating and the padding of
// receivers (R_TILE) and rays (C_CHUNK), which exist for the TPU's matrix
// unit and tiling.
//
// The phasor metric (rfx_coverage_phasor, rfx_coverage_phasor_spread and the
// table of rfx_phasor_table) replaces the XLA program of rfx/coverage.py:229
// _rx_dbm_phasor_from_segments under the vmap of :350 with rfx/cir.py:204
// rx_power_dbm_phasor: per receiver, from its first captures, the sums behind
// the fast metric's dBm, cancellation ratio and delay spread. It is the same
// walk (`walk_slab`, `capture`) with another sink (`PhasorSums`): each lane
// owns a receiver of its warp's tile and takes that receiver's wins of a step
// in ray slot and lane order, so K3 and it cannot disagree on a capture.
//
// What bounds it: the sphere tests of one walk, as K3. What the design does
// about the rest:
//
// - One walk. The spread needs the power-weighted mean delay first (a
//   one-pass sum of w t^2 - (sum w t)^2 / sum w cancels in f32 at 10-100 ns,
//   and a running mean would take the spread about another mean than the
//   metric's w2t / w2). So the walk records each capture's (w^2, t_k) in its
//   (slab, receiver) list, in the order it takes them, and the spread is a
//   pass over the lists about each receiver's mean from the first pass's
//   sums: the sums of a walk about that mean, term for term. The lists are
//   chunks of a pool, taken as a lane needs them (a receiver near the
//   transmitter captures thousands of paths a slab, most a few dozen); where
//   the pool runs out, the region is flagged and only the warps whose tile
//   holds a flag walk their slab again.
// - No serial work per capture on one lane. A table of (sqrt s_k, cos, sin,
//   t_k) per bin, made once a call, holds what a capture evaluated for
//   itself (cosf / sinf of phases up to ~1,500 rad); the lanes that won a
//   receiver in a step each load their entry and form their terms at once,
//   and the receiver's owner lane only adds the terms, handed over by
//   shuffles, in the order it took them before: the same terms in the same
//   order, so the same bits.
//
// Each pass writes per-slab partials that are combined in slab order: an
// order fixed by the ray count alone, as the histogram's.
//
// The phasor metric's backward (rfx_coverage_phasor_backward, its note below)
// replaces what jax.grad takes through the same XLA program: d / d amp of
// every segment. It finds the forward's captures with the same device code
// (`disc_positive`, `sphere_win`, and `phasor_entry` through the table) and
// adds each segment's terms over the receivers in ascending order.

#include <cuda_runtime.h>

#include "sphere.cuh"

namespace {

using namespace rfx_capture;  // sphere_t, delay_bin, Segment, disc_positive, sphere_win

constexpr int kRx = 16;    // receivers of one warp, at most 32
constexpr int kRays = 4;   // segments a lane holds at once
constexpr int kWarps = 4;  // warps of one block
constexpr unsigned kFullWarp = 0xffffffffu;

static_assert(kRx >= 1 && kRx <= 32, "a ray slot's wins are one bit a receiver");

// The kRays segments of bounce b that lane `lane` holds of the chunk at
// `base`: ray base + 32 * k + lane. Every load is started whether the segment
// is alive or not (no load waits for another); a dead or missing one is
// marked so.
__device__ __forceinline__ void load_segments(
    Segment (&seg)[kRays], long long base, int b, int n, int lane,
    const float* __restrict__ origin, const float* __restrict__ dir,
    const float* __restrict__ t_env, const float* __restrict__ amp,
    const float* __restrict__ dist, const bool* __restrict__ alive) {
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const long long i = base + 32 * k + lane;
    const bool in = i < n;
    const long long at = in ? static_cast<long long>(b) * n + i : 0;
    seg[k].ox = origin[3 * at];
    seg[k].oy = origin[3 * at + 1];
    seg[k].oz = origin[3 * at + 2];
    seg[k].dx = dir[3 * at];
    seg[k].dy = dir[3 * at + 1];
    seg[k].dz = dir[3 * at + 2];
    seg[k].te = t_env[at];
    seg[k].dist = dist[at];
    seg[k].amp = amp[at];
    seg[k].live = in && alive[at];
  }
}

// A warp's scratch in shared memory, where the lanes that won leave what the
// adds need.
struct Scratch {
  int bin[kRays][kRx][32];  // of (ray slot k, lane l)'s win for receiver r: the bin, -1 to drop
  float amp[kRays][32];     // the amplitude of (ray slot k, lane l)'s segment
};

// What a warp shares while it walks its slab.
struct Tile {
  const float4* centers;  // shared memory, kRx entries
  Scratch* scratch;
  unsigned all_rx;        // bit r set: receiver r of the tile exists
  float r2, c, rate;
  int nbins, lane;
};

// Finishes the tests whose discriminant was positive (`cand`, per ray slot):
// `win` gets the receivers each lane won per ray slot, the winners leave bin
// (-1 to drop) and amplitude in the warp's scratch, and `done` gains the wins.
// Every lane of the warp calls it; it ends with the scratch visible to all.
// This is the capture rule of both kernels of this file: they cannot disagree
// on a capture.
__device__ __forceinline__ void capture(const Segment (&seg)[kRays], const unsigned (&cand)[kRays],
                                        unsigned (&done)[kRays], unsigned (&win)[kRays],
                                        const Tile& t) {
  Scratch& scratch = *t.scratch;
  unsigned todo[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    todo[k] = cand[k] & ~done[k];
    win[k] = 0u;
  }
  // One candidate of this lane per iteration, whichever ray slot it is in
  // (the slot's segment picked by selects: the arrays stay in registers).
  while (true) {
    int k = -1;
#pragma unroll
    for (int j = kRays - 1; j >= 0; --j) k = todo[j] != 0u ? j : k;
    if (k < 0) break;
    Segment s = seg[0];
    unsigned bits = todo[0];
#pragma unroll
    for (int j = 1; j < kRays; ++j) {
      if (k == j) {
        s = seg[j];
        bits = todo[j];
      }
    }
    const int r = __ffs(bits) - 1;
#pragma unroll
    for (int j = 0; j < kRays; ++j) todo[j] = k == j ? bits & (bits - 1u) : todo[j];
    int bin;
    if (sphere_win(s, t.centers[r], t.r2, t.c, t.rate, t.nbins, bin)) {
#pragma unroll
      for (int j = 0; j < kRays; ++j) win[j] |= k == j ? 1u << r : 0u;
      scratch.bin[k][r][t.lane] = bin;
      scratch.amp[k][t.lane] = s.amp;
    }
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < kRays; ++k) done[k] |= win[k];
}

// The coverage histogram's adds. Per ray slot and receiver that was won, the
// lanes that won it group by bin; a group's lowest lane sums the group's
// amplitudes in lane order and adds the sum to the receiver's row. Within one
// such step every add goes to another bin, and the __syncwarp between steps
// orders the steps' adds, so a bin is added to in one order: slab, chunk,
// bounce, ray slot.
struct HistRows {
  float* rows;  // row of the tile's first receiver in the slab's plane

  __device__ __forceinline__ void add(const unsigned (&win)[kRays], const Tile& t) {
    const Scratch& scratch = *t.scratch;
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      unsigned receivers = __reduce_or_sync(kFullWarp, win[k]);
      while (receivers != 0u) {  // warp-uniform
        const int r = __ffs(receivers) - 1;
        receivers &= receivers - 1u;
        const unsigned lanes = __ballot_sync(kFullWarp, (win[k] >> r) & 1u);
        if ((lanes >> t.lane) & 1u) {
          const int bin = scratch.bin[k][r][t.lane];
          unsigned group = __match_any_sync(lanes, bin);
          const bool lowest = __ffs(group) - 1 == t.lane;
          float sum = 0.0f;
          while (group != 0u) {
            sum += scratch.amp[k][__ffs(group) - 1];
            group &= group - 1u;
          }
          if (lowest && bin >= 0) {
            float* at = rows + static_cast<size_t>(r) * t.nbins + bin;
            *at = *at + sum;
          }
        }
        __syncwarp();
      }
    }
  }
};

// The phasor metric's per-bin table (rfx_torch/cir.py:rx_power_dbm_phasor):
// for bin k, t_k = k * step, s_k = min(k + hi + 1, nbins), phase omega * t_k;
// entry k is (sqrt(s_k), cos(phase), sin(phase), t_k), the f32 expressions
// each capture evaluated for itself before the table.
__device__ __forceinline__ float4 phasor_entry(int k, int nbins, float step, float omega) {
  const int hi = nbins - 1 - (nbins - 1) / 2;
  const float t_k = static_cast<float>(k) * step;
  const float s = static_cast<float>(min(static_cast<long long>(k) + hi + 1,
                                         static_cast<long long>(nbins)));
  const float phase = omega * t_k;
  return make_float4(sqrtf(s), cosf(phase), sinf(phase), t_k);
}

__global__ void __launch_bounds__(256) phasor_table_kernel(int nbins, float step, float omega,
                                                           float4* __restrict__ table) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= nbins) return;
  table[k] = phasor_entry(k, nbins, step, omega);
}

// The capture lists of the first pass: each (slab, receiver) region's
// (w^2, t_k) pairs in the order the walk takes them, in chunks of
// `chunk` pairs that the owner lane takes from a pool as it needs them
// (`next` links a region's chunks; which chunk a region gets depends on the
// order in which lanes ask, what a chunk holds does not). A region that finds
// the pool spent stops recording and is flagged: the spread walks its tile
// again.
struct CaptureList {
  float2* pool;
  int* top;    // chunks taken so far
  int* next;   // per chunk: the region's next chunk
  int* first;  // per region: its first chunk, -1 for none
  int n_chunks, chunk;
  int cur = -1;             // the chunk being filled
  float2* dst = nullptr;    // its next pair
  int left = 0;             // pairs it has room for
  bool lost = false;        // the pool ran out for this region

  __device__ __forceinline__ void push(float wgt, float t_k, int region) {
    if (left == 0) {
      if (lost) return;
      const int c = atomicAdd(top, 1);
      if (c >= n_chunks) {
        lost = true;
        return;
      }
      if (cur < 0) {
        first[region] = c;
      } else {
        next[cur] = c;
      }
      cur = c;
      dst = pool + static_cast<size_t>(c) * chunk;
      left = chunk;
    }
    *dst++ = make_float2(wgt, t_k);
    --left;
  }
};

// The phasor metric's sums (rfx_torch/cir.py:rx_power_dbm_phasor) of the
// receiver that lane `t.lane` owns, over its captures in the order of the
// walk. A capture of amplitude amp in bin k reads the table's entry k: weight
// w = amp sqrt(s_k). The first pass (kSpread false) adds w cos, w sin, w^2
// and w^2 t_k, keeps the largest bin and the count of captures, and records
// (w^2, t_k) in the region's list; the spread (kSpread true, a tile walked
// again) adds w^2 (t_k - t_mean)^2 with the receiver's t_mean.
template <bool kSpread>
struct PhasorSums {
  const float4* table;
  float t_mean;
  int hi, nbins, region;
  CaptureList list;
  int count = 0, max_bin = -1;
  float re = 0.0f, im = 0.0f, w2 = 0.0f, w2t = 0.0f, dev = 0.0f;

  // max s_k over the captures (s_k grows with k: the largest bin's), 0 for
  // none; and whether anything was captured, as 1.0 or 0.0.
  __device__ __forceinline__ float s_max() const {
    return count > 0 ? static_cast<float>(min(static_cast<long long>(max_bin) + hi + 1,
                                              static_cast<long long>(nbins)))
                     : 0.0f;
  }
  __device__ __forceinline__ float any() const { return count > 0 ? 1.0f : 0.0f; }

  // Per ray slot and receiver won (in turn, warp-uniform), the lanes that
  // won it each work out what their win adds (a table load and a few
  // products, all lanes at once), and the owner lane adds those terms in
  // lane order: the order and the terms of one lane taking each win in turn,
  // without a chain of loads on one lane (a receiver near the transmitter
  // wins most of a step's rays). A lane's first won receiver has its entry
  // loaded before the receivers are taken.
  __device__ __forceinline__ void add(const unsigned (&win)[kRays], const Tile& t) {
    const Scratch& scratch = *t.scratch;
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const unsigned mine = win[k];  // the receivers this lane won in slot k
      const int r0 = __ffs(mine) - 1;
      const int bin0 = r0 >= 0 ? scratch.bin[k][r0][t.lane] : -1;
      const float4 e0 = bin0 >= 0 ? __ldg(table + bin0) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float amp = mine != 0u ? scratch.amp[k][t.lane] : 0.0f;
      for (unsigned rs = __reduce_or_sync(kFullWarp, mine); rs != 0u; rs &= rs - 1u) {
        const int r = __ffs(rs) - 1;  // warp-uniform
        int bin = r == r0 ? bin0 : -1;
        float4 e = e0;
        if (r != r0 && ((mine >> r) & 1u)) {
          bin = scratch.bin[k][r][t.lane];
          if (bin >= 0) e = __ldg(table + bin);
        }
        const unsigned takers = __ballot_sync(kFullWarp, bin >= 0);  // dropped bins add nothing
        const float aw = amp * e.x;
        const float wgt = aw * aw;
        if (kSpread) {
          const float dt = e.w - __shfl_sync(kFullWarp, t_mean, r);
          const float term = wgt * (dt * dt);
          for (unsigned ls = takers; ls != 0u; ls &= ls - 1u) {
            const float v = __shfl_sync(kFullWarp, term, __ffs(ls) - 1);
            if (t.lane == r) dev = dev + v;
          }
        } else {
          const float c = aw * e.y, sn = aw * e.z, wt = wgt * e.w;
          const int top_bin = __reduce_max_sync(kFullWarp, bin);
          for (unsigned ls = takers; ls != 0u; ls &= ls - 1u) {
            const int l = __ffs(ls) - 1;
            const float vc = __shfl_sync(kFullWarp, c, l), vs = __shfl_sync(kFullWarp, sn, l);
            const float vw = __shfl_sync(kFullWarp, wgt, l), vwt = __shfl_sync(kFullWarp, wt, l);
            const float vt = __shfl_sync(kFullWarp, e.w, l);
            if (t.lane == r) {
              re = re + vc;
              im = im + vs;
              w2 = w2 + vw;
              w2t = w2t + vwt;
              list.push(vw, vt, region);
              ++count;
            }
          }
          if (t.lane == r) max_bin = max(max_bin, top_bin);
        }
      }
    }
    __syncwarp();  // the scratch is read before the next step writes it
  }
};

// One warp's walk over its slab for its tile of receivers, the sink taking
// the wins: the steps are (chunk, bounce) pairs, and the next step's segments
// are loaded before this step's tests, so that their latency passes behind
// the arithmetic.
template <class Sink>
__device__ __forceinline__ void walk_slab(const float* __restrict__ origin,
                                          const float* __restrict__ dir,
                                          const float* __restrict__ t_env,
                                          const float* __restrict__ amp,
                                          const float* __restrict__ dist,
                                          const bool* __restrict__ alive, int nb, int n,
                                          long long base, long long stride, const Tile& tile,
                                          Sink& sink) {
  Segment next[kRays];
  unsigned done[kRays];
  int b = 0;
  load_segments(next, base, b, n, tile.lane, origin, dir, t_env, amp, dist, alive);
  while (true) {
    Segment seg[kRays];
    bool any = false;
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      seg[k] = next[k];
      any = any || seg[k].live;
      if (b == 0) done[k] = 0u;
    }
    const bool last_bounce = b + 1 == nb;
    const long long next_base = last_bounce ? base + stride : base;
    const bool more = next_base < n;
    if (more) {
      load_segments(next, next_base, last_bounce ? 0 : b + 1, n, tile.lane, origin, dir, t_env,
                    amp, dist, alive);
    }
    if (__any_sync(kFullWarp, any)) {
      unsigned cand[kRays];
#pragma unroll
      for (int k = 0; k < kRays; ++k) cand[k] = 0u;
#pragma unroll
      for (int r = 0; r < kRx; ++r) {
        const float4 ctr = tile.centers[r];
#pragma unroll
        for (int k = 0; k < kRays; ++k) {
          if (disc_positive(seg[k], ctr, tile.r2)) cand[k] |= 1u << r;
        }
      }
      bool some = false;
#pragma unroll
      for (int k = 0; k < kRays; ++k) {
        cand[k] = seg[k].live ? cand[k] & tile.all_rx : 0u;
        some = some || (cand[k] & ~done[k]) != 0u;
      }
      if (__any_sync(kFullWarp, some)) {
        unsigned win[kRays];
        capture(seg, cand, done, win, tile);
        sink.add(win, tile);
      }
    }
    if (!more) break;
    base = next_base;
    b = last_bounce ? 0 : b + 1;
  }
}

// A block's set-up: the warp's tile of receivers (centers in shared memory)
// and its first chunk. Returns false (for the whole warp; no barrier
// follows) where the warp has no receiver or its slab no ray.
__device__ __forceinline__ bool setup_tile(Tile& tile, float4 (&shared_centers)[kWarps][kRx],
                                           Scratch (&shared_scratch)[kWarps],
                                           const float* __restrict__ centers, int m, int n,
                                           float r2, float c, float rate, int nbins, int& rx0,
                                           long long& base, long long& stride) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  rx0 = (blockIdx.x * kWarps + warp) * kRx;
  // Chunk j of 32 * kRays rays belongs to slab j % gridDim.y: rays that are
  // neighbours in Morton order reach the same receivers, and so the captures
  // of a receiver near the transmitter spread over all slabs.
  const long long chunk = 32 * kRays;
  stride = gridDim.y * chunk;
  base = blockIdx.y * chunk;
  if (rx0 >= m || base >= n) return false;
  const int nrx = min(kRx, m - rx0);
  tile.centers = shared_centers[warp];
  tile.scratch = &shared_scratch[warp];
  tile.all_rx = nrx == 32 ? kFullWarp : (1u << nrx) - 1u;
  tile.r2 = r2;
  tile.c = c;
  tile.rate = rate;
  tile.nbins = nbins;
  tile.lane = lane;
  if (lane < kRx) {
    shared_centers[warp][lane] =
        lane < nrx ? make_float4(centers[3 * (rx0 + lane)], centers[3 * (rx0 + lane) + 1],
                                 centers[3 * (rx0 + lane) + 2], 0.0f)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncwarp();
  return true;
}

// Segment (b, i) of the (B, N) planes is element b * n + i; origin and
// direction are (B, N, 3). Block x takes receivers [x * kWarps * kRx, ...),
// block y the chunks y, y + gridDim.y, ... of 32 * kRays rays and plane y of
// `planes`, (gridDim.y, m, nbins), zeroed by the caller.
__global__ void __launch_bounds__(kWarps * 32) coverage_hist_kernel(
    const float* __restrict__ origin, const float* __restrict__ dir,
    const float* __restrict__ t_env, const float* __restrict__ amp,
    const float* __restrict__ dist, const bool* __restrict__ alive, int nb, int n,
    const float* __restrict__ centers, int m, float r2, float c, float rate, int nbins,
    float* planes) {
  __shared__ float4 shared_centers[kWarps][kRx];
  __shared__ Scratch shared_scratch[kWarps];
  Tile tile;
  int rx0;
  long long base, stride;
  if (!setup_tile(tile, shared_centers, shared_scratch, centers, m, n, r2, c, rate, nbins, rx0,
                  base, stride)) {
    return;
  }
  HistRows sink{planes + (static_cast<size_t>(blockIdx.y) * m + rx0) * nbins};
  walk_slab(origin, dir, t_env, amp, dist, alive, nb, n, base, stride, tile, sink);
}

constexpr int kSumFields = 6;

// The first pass's scratch: the capture lists' pool of chunks and, in one
// int buffer, the pool's count of chunks taken, each chunk's link, and per
// region (slab h, receiver i: h * m + i) its first chunk, its captures and
// whether its list was lost.
struct PhasorLists {
  float2* pool;
  int* top;
  int* next;
  int* first;
  int* count;
  int* lost;
  int n_chunks, chunk;

  __host__ __device__ PhasorLists(void* pool_, void* ints, int n_chunks_, int chunk_,
                                  long long regions)
      : pool(static_cast<float2*>(pool_)), top(static_cast<int*>(ints)), next(top + 1),
        first(next + n_chunks_), count(first + regions), lost(count + regions),
        n_chunks(n_chunks_), chunk(chunk_) {}
};

// The phasor metric's first pass per receiver and slab: the walk and the
// capture rule of coverage_hist_kernel, each capture taken by PhasorSums.
// partials: (gridDim.y, m, kSumFields) (re, im, max s_k, any, w^2, w^2 t_k);
// every entry of the warp's receivers is written, and every region's first
// chunk, count and lost flag, zeros where the slab has no ray.
__global__ void __launch_bounds__(kWarps * 32) coverage_phasor_kernel(
    const float* __restrict__ origin, const float* __restrict__ dir,
    const float* __restrict__ t_env, const float* __restrict__ amp,
    const float* __restrict__ dist, const bool* __restrict__ alive, int nb, int n,
    const float* __restrict__ centers, int m, float r2, float c, float rate, int nbins,
    const float4* __restrict__ table, PhasorLists lists, float* __restrict__ partials) {
  __shared__ float4 shared_centers[kWarps][kRx];
  __shared__ Scratch shared_scratch[kWarps];
  Tile tile;
  int rx0;
  long long base, stride;
  const bool walks = setup_tile(tile, shared_centers, shared_scratch, centers, m, n, r2, c, rate,
                                nbins, rx0, base, stride);
  const int lane = threadIdx.x & 31;
  const bool mine = rx0 < m && lane < min(kRx, m - rx0);
  const long long region = static_cast<long long>(blockIdx.y) * m + rx0 + lane;
  if (mine) lists.first[region] = -1;
  PhasorSums<false> sink;
  sink.table = table;
  sink.hi = nbins - 1 - (nbins - 1) / 2;
  sink.nbins = nbins;
  sink.region = static_cast<int>(region);
  sink.list = CaptureList{lists.pool, lists.top, lists.next, lists.first, lists.n_chunks,
                          lists.chunk};
  if (walks) walk_slab(origin, dir, t_env, amp, dist, alive, nb, n, base, stride, tile, sink);
  if (!mine) return;
  float* p = partials + region * kSumFields;
  p[0] = sink.re;
  p[1] = sink.im;
  p[2] = sink.s_max();
  p[3] = sink.any();
  p[4] = sink.w2;
  p[5] = sink.w2t;
  lists.count[region] = sink.count;
  lists.lost[region] = sink.list.lost ? 1 : 0;
}

// The spread of the regions whose list was lost: a warp whose tile holds one
// walks its slab again with the receivers' t_mean (the first pass's walk,
// so the same captures in the same order) and writes those regions' w^2 (t_k
// - t_mean)^2 to dev_partials. Every other warp returns at once.
__global__ void __launch_bounds__(kWarps * 32) coverage_phasor_rewalk_kernel(
    const float* __restrict__ origin, const float* __restrict__ dir,
    const float* __restrict__ t_env, const float* __restrict__ amp,
    const float* __restrict__ dist, const bool* __restrict__ alive, int nb, int n,
    const float* __restrict__ centers, int m, float r2, float c, float rate, int nbins,
    const float4* __restrict__ table, const int* __restrict__ lost,
    const float* __restrict__ t_mean, float* __restrict__ dev_partials) {
  __shared__ float4 shared_centers[kWarps][kRx];
  __shared__ Scratch shared_scratch[kWarps];
  Tile tile;
  int rx0;
  long long base, stride;
  if (!setup_tile(tile, shared_centers, shared_scratch, centers, m, n, r2, c, rate, nbins, rx0,
                  base, stride)) {
    return;
  }
  const int lane = tile.lane;
  const bool mine = lane < min(kRx, m - rx0);
  const long long region = static_cast<long long>(blockIdx.y) * m + rx0 + lane;
  const bool flagged = mine && lost[region] != 0;
  if (!__any_sync(kFullWarp, flagged)) return;
  PhasorSums<true> sink;
  sink.table = table;
  sink.t_mean = mine ? t_mean[rx0 + lane] : 0.0f;
  walk_slab(origin, dir, t_env, amp, dist, alive, nb, n, base, stride, tile, sink);
  if (flagged) dev_partials[region] = sink.dev;
}

// out[i] = the spread sum of receiver i, sum w^2 (t_k - t_mean)^2, one warp
// a receiver: lane h adds slab h's list in its recorded order (or takes the
// walk's sum where the list was lost), and the slabs' sums are combined in
// slab order. n_slabs <= 32.
__global__ void __launch_bounds__(256) phasor_spread_kernel(
    int m, int n_slabs, const float* __restrict__ t_mean, PhasorLists lists,
    const float* __restrict__ dev_partials, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (i >= m) return;  // warp-uniform
  float part = 0.0f;
  if (lane < n_slabs) {
    const long long g = static_cast<long long>(lane) * m + i;
    if (lists.lost[g] != 0) {
      part = dev_partials[g];
    } else {
      // Sixteen loads in flight (the list is in the L2, written by the first
      // pass), then their terms added one by one in the recorded order.
      constexpr int kAhead = 16;
      const float tm = t_mean[i];
      const int n = lists.count[g];
      int chunk = lists.first[g];
      for (int q0 = 0; q0 < n; q0 += lists.chunk) {
        const float2* e = lists.pool + static_cast<size_t>(chunk) * lists.chunk;
        const int len = min(lists.chunk, n - q0);
        int q = 0;
        for (; q + 2 * kAhead <= len; q += 2 * kAhead) {
          float4 v[kAhead];  // two pairs each: a chunk starts on 16 bytes, q is even
#pragma unroll
          for (int u = 0; u < kAhead; ++u) v[u] = reinterpret_cast<const float4*>(e + q)[u];
#pragma unroll
          for (int u = 0; u < kAhead; ++u) {
            const float d0 = v[u].y - tm;
            part = part + v[u].x * (d0 * d0);
            const float d1 = v[u].w - tm;
            part = part + v[u].z * (d1 * d1);
          }
        }
        for (; q < len; ++q) {
          const float dt = e[q].y - tm;
          part = part + e[q].x * (dt * dt);
        }
        if (q0 + lists.chunk < n) chunk = lists.next[chunk];
      }
    }
  }
  float acc = __shfl_sync(kFullWarp, part, 0);
  for (int h = 1; h < n_slabs; ++h) acc = acc + __shfl_sync(kFullWarp, part, h);
  if (lane == 0) out[i] = acc;
}

// out[i] = the slabs' partials of entry i, (n_planes, total), combined in
// slab order: summed, but the maximum for fields 2 and 3 of kSumFields (max
// s_k and any), which no order changes.
__global__ void __launch_bounds__(256) phasor_reduce_kernel(const float* __restrict__ planes,
                                                            int n_planes, long long total,
                                                            float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int f = static_cast<int>(i % kSumFields);
  const bool is_max = f == 2 || f == 3;
  float acc = planes[i];
  for (int h = 1; h < n_planes; ++h) {
    const float v = planes[static_cast<long long>(h) * total + i];
    acc = is_max ? fmaxf(acc, v) : acc + v;
  }
  out[i] = acc;
}

// The backward of the phasor metric (rfx_coverage_phasor_backward): d / d
// amp of every segment, given per receiver r the forward's sums and the
// cotangents folded into coefficients (rfx_torch/ops/coverage_hist.py:
// phasor_coefficients): coef[r] = (re, im, A, B, S, t_mean, var, 0). A first
// capture of r in bin k, of amplitude a, with (w, cos, sin, t) the table's
// entry k, adds
//
//   w (re cos + im sin) A  +  a w^2 (B + S ((t - t_mean)^2 - var)),
//
// each part only where its coefficients are nonzero (a coefficient whose
// cotangent is zero is 0, and its part is skipped, not multiplied: jax.grad
// prunes it, and 0 * inf would be NaN). A segment's terms are added over its
// receivers in ascending order from +0, so each output is the same bits from
// run to run, whatever thread computes it.
//
// What bounds it on an H100: the walk's sphere tests, one per live segment
// and receiver (4.3e9 on the room's 2,048 receivers x 2 x 1,048,576
// segments), 17 f32 operations each. Built without contraction (-fmad=false)
// each operation is an instruction, and the card issues at most 132 SMs x 128
// lanes x ~1.98 GHz = ~33.5e12 of them a second: that, not the 67 TFLOP/s of
// fused multiply-adds, is the floor for any design that keeps the forward's
// bits (`disc_positive` decides a capture, and a rounding there moves one).
// What the design does about it:
//
// - A thread takes one ray and holds its bounces (origin, direction, life) in
//   registers (kB > 0, up to 8 bounces). For a tile of 32 receivers the hot
//   loop computes only `disc_positive` for every held segment, eight centers
//   at a time from shared memory, each center load serving the ray's kB
//   tests, and notes the results in one bit mask a bounce: no loads of t_env,
//   dist or amp, no branch a test, and the tests of a tile independent of
//   each other. A bounce that no lane of the warp holds alive is skipped by
//   the whole warp.
// - Only where a mask is nonzero does the thread walk its bits, bounce by
//   bounce and receiver by receiver in ascending order, with the first-win
//   rule across bounces (`done`: a win at bounce b ends that receiver for the
//   later bounces; a dropped bin still counts as a win). There it loads what
//   the capture needs (`sphere_win`: t_env, dist) and forms its term from the
//   per-bin table (`rfx_phasor_table`'s `phasor_entry`, built by the entry
//   point into scratch): no sqrt, cos or sin a capture.
// - Threads take live rays only: a fixed-order scan lists the rays with any
//   live segment in ascending order (`phasor_live_count`, `phasor_live_scan`,
//   `phasor_live_list`), and the count pass writes 0 for every segment of a
//   dead ray. A ray's sums do not depend on the thread that takes it.
// - More than 8 bounces (kB == 0): the bounces are read again for each tile
//   and taken one after the other, each with its mask and the same `done`
//   rule, the sums going to g_amp directly.
//
// The captures are the forward's: `disc_positive`, `sphere_win` and
// `phasor_entry` are the device code of coverage_hist_kernel and
// coverage_phasor_kernel, unchanged.
constexpr int kBackThreads = 256;   // rays of a walk block
constexpr int kBackRx = 1024;       // receivers staged in shared memory at once
constexpr int kBackGroup = 8;       // centers a thread holds in registers at once
constexpr int kScanRays = 1024;     // rays of a scan block: 4 a thread of 256
constexpr int kScanThreads = 256;

__device__ __forceinline__ bool ray_live(const bool* __restrict__ alive, int nb, int n,
                                         long long i) {
  bool live = false;
  for (int b = 0; b < nb; ++b) live = live || alive[static_cast<long long>(b) * n + i];
  return live;
}

// counts[x] = the live rays of scan block x; every segment of a dead ray
// gets g_amp 0.
__global__ void __launch_bounds__(kScanThreads) phasor_live_count(const bool* __restrict__ alive,
                                                                  int nb, int n,
                                                                  int* __restrict__ counts,
                                                                  float* __restrict__ g_amp) {
  const long long base = static_cast<long long>(blockIdx.x) * kScanRays;
  int live = 0;
  for (int k = threadIdx.x; k < kScanRays; k += kScanThreads) {
    const long long i = base + k;
    if (i >= n) break;
    if (ray_live(alive, nb, n, i)) {
      ++live;
    } else {
      for (int b = 0; b < nb; ++b) g_amp[static_cast<long long>(b) * n + i] = 0.0f;
    }
  }
  __shared__ int s_sum[kScanThreads / 32];
  int v = live;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFullWarp, v, o);
  if ((threadIdx.x & 31) == 0) s_sum[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < kScanThreads / 32; ++w) sum += s_sum[w];
    counts[blockIdx.x] = sum;
  }
}

// One block: counts[0..blocks) become their exclusive prefix sums, in block
// order, and counts[blocks] the number of live rays.
__global__ void __launch_bounds__(kScanThreads) phasor_live_scan(int* __restrict__ counts,
                                                                 int blocks) {
  __shared__ int s_warp[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base < blocks; base += kScanThreads) {
    const int x = base + threadIdx.x;
    const int v = x < blocks ? counts[x] : 0;
    int incl = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFullWarp, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kScanThreads / 32; ++w) {
      before += w < warp ? s_warp[w] : 0;
      total += s_warp[w];
    }
    if (x < blocks) counts[x] = carry + before + incl - v;
    carry += total;
    __syncthreads();  // s_warp is rewritten by the next step
  }
  if (threadIdx.x == 0) counts[blocks] = carry;
}

// list[offsets[x] + j] = the j-th live ray of scan block x, ascending: thread
// t takes rays 4t .. 4t + 3 of the block, and the block's threads write in
// thread order.
__global__ void __launch_bounds__(kScanThreads) phasor_live_list(const bool* __restrict__ alive,
                                                                 int nb, int n,
                                                                 const int* __restrict__ offsets,
                                                                 int* __restrict__ list) {
  constexpr int kPer = kScanRays / kScanThreads;
  __shared__ int s_warp[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long first = static_cast<long long>(blockIdx.x) * kScanRays + kPer * threadIdx.x;
  bool live[kPer];
  int mine = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    live[k] = first + k < n && ray_live(alive, nb, n, first + k);
    mine += live[k] ? 1 : 0;
  }
  int incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFullWarp, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0;
#pragma unroll
  for (int w = 0; w < kScanThreads / 32; ++w) before += w < warp ? s_warp[w] : 0;
  int at = offsets[blockIdx.x] + before + incl - mine;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (live[k]) list[at++] = static_cast<int>(first + k);
  }
}

// What a capture needs beside the segment: the walk's constants, the table,
// the coefficients and the centers in shared memory.
struct BackCapture {
  const float* t_env;
  const float* dist;
  const float* amp;
  const float4* table;
  const float4* coef;
  const float4* s_ctr;
  float r2, c, rate;
  int nbins;

  // Receiver q of the staged chunk (global index r) against segment `geom`
  // at element `at`, whose discriminant was positive: true on a win; `adds`
  // is set where the win's bin is kept, and `g` is then its term (the
  // expressions of _phasor_terms in rfx_torch/ops/coverage_hist.py, in its
  // order).
  __device__ __forceinline__ bool operator()(const Segment& geom, long long at, int q, long long r,
                                             bool& adds, float& g) const {
    Segment s = geom;
    s.te = __ldg(t_env + at);
    s.dist = __ldg(dist + at);
    const float4 ctr = s_ctr[q];
    int bin;
    adds = false;
    g = 0.0f;
    if (!sphere_win(s, ctr, r2, c, rate, nbins, bin)) return false;
    if (bin < 0) return true;  // dropped: the win counts, its path adds nothing
    adds = true;
    const float4 e = __ldg(table + bin);
    const float4 k0 = __ldg(coef + 2 * r), k1 = __ldg(coef + 2 * r + 1);
    if (k0.z != 0.0f) g = e.x * (k0.x * e.y + k0.y * e.z) * k0.z;
    if (k0.w != 0.0f || k1.x != 0.0f) {
      float u = k0.w;
      if (k1.x != 0.0f) {
        const float dt = e.w - k1.y;
        u = u + k1.x * (dt * dt - k1.z);
      }
      const float aw = __ldg(amp + at) * e.x;
      g = g + aw * e.x * u;
    }
    return true;
  }
};

// The hot loop: bit q of the result is disc_positive(seg, center q0 + q)
// for q < 32, centers kBackGroup at a time; no branch a test.
template <int kHeld>
__device__ __forceinline__ void disc_masks(const Segment (&held)[kHeld], const bool (&warp_live)[kHeld],
                                           const float4* s_ctr, int q0, float r2,
                                           unsigned (&mask)[kHeld]) {
#pragma unroll
  for (int b = 0; b < kHeld; ++b) mask[b] = 0u;
#pragma unroll
  for (int g0 = 0; g0 < 32; g0 += kBackGroup) {
    float4 ctr[kBackGroup];
#pragma unroll
    for (int u = 0; u < kBackGroup; ++u) ctr[u] = s_ctr[q0 + g0 + u];
#pragma unroll
    for (int b = 0; b < kHeld; ++b) {
      if (warp_live[b]) {  // warp-uniform
#pragma unroll
        for (int u = 0; u < kBackGroup; ++u) {
          mask[b] |= disc_positive(held[b], ctr[u], r2) ? 1u << (g0 + u) : 0u;
        }
      }
    }
  }
}

// A thread a live ray (list[t] of the `live` rays). kB > 0: up to kB
// bounces in registers; kB == 0: any count, read again for each tile.
// The staged chunk of centers is padded with zeros to kBackRx entries, so a
// tile of 32 never reads past it; its receivers past m are masked off.
template <int kB>
__global__ void __launch_bounds__(kBackThreads) coverage_phasor_backward_kernel(
    const float* __restrict__ origin, const float* __restrict__ dir,
    const float* __restrict__ t_env, const float* __restrict__ amp,
    const float* __restrict__ dist, const bool* __restrict__ alive, int nb, int n,
    const float* __restrict__ centers, int m, float r2, float c, float rate, int nbins,
    const float4* __restrict__ table, const float4* __restrict__ coef,
    const int* __restrict__ list, const int* __restrict__ n_live, float* __restrict__ g_amp) {
  __shared__ float4 s_ctr[kBackRx];
  const int live_rays = *n_live;
  const long long t = static_cast<long long>(blockIdx.x) * kBackThreads + threadIdx.x;
  if (static_cast<long long>(blockIdx.x) * kBackThreads >= live_rays) return;  // block-uniform
  const bool in = t < live_rays;
  const long long i = in ? list[t] : 0;
  constexpr int kHeld = kB > 0 ? kB : 1;
  const BackCapture capture{t_env, dist, amp, table, coef, s_ctr, r2, c, rate, nbins};
  // Origin, direction and life of bounce b (b < nb) of ray i.
  auto geometry = [&](int b) {
    Segment s;
    const long long at = static_cast<long long>(b) * n + i;
    s.ox = origin[3 * at];
    s.oy = origin[3 * at + 1];
    s.oz = origin[3 * at + 2];
    s.dx = dir[3 * at];
    s.dy = dir[3 * at + 1];
    s.dz = dir[3 * at + 2];
    s.live = in && alive[at];
    return s;
  };
  Segment held[kHeld];
  bool warp_live[kHeld];
  float acc[kHeld];
#pragma unroll
  for (int b = 0; b < kHeld; ++b) {
    acc[b] = 0.0f;
    if (kB > 0) {
      held[b] = geometry(b < nb ? b : 0);
      held[b].live = held[b].live && b < nb;
      warp_live[b] = __any_sync(kFullWarp, held[b].live);
    }
  }
  if (kB == 0 && in) {
    for (int b = 0; b < nb; ++b) g_amp[static_cast<long long>(b) * n + i] = 0.0f;
  }
  for (int r0 = 0; r0 < m; r0 += kBackRx) {
    const int nr = min(kBackRx, m - r0);
    __syncthreads();  // the previous chunk is read
    for (int q = threadIdx.x; q < kBackRx; q += kBackThreads) {
      const long long r = r0 + q;
      s_ctr[q] = q < nr ? make_float4(centers[3 * r], centers[3 * r + 1], centers[3 * r + 2], 0.0f)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();
    for (int q0 = 0; q0 < nr; q0 += 32) {
      const unsigned valid = nr - q0 >= 32 ? kFullWarp : (1u << (nr - q0)) - 1u;
      unsigned done = 0u;
      if (kB > 0) {
        unsigned mask[kHeld];
        disc_masks(held, warp_live, s_ctr, q0, r2, mask);
        unsigned any = 0u;
#pragma unroll
        for (int b = 0; b < kHeld; ++b) {
          mask[b] = held[b].live ? mask[b] & valid : 0u;
          any |= mask[b];
        }
        if (any == 0u) continue;  // the common case: no capture in this tile
#pragma unroll
        for (int b = 0; b < kHeld; ++b) {
          const long long at = static_cast<long long>(b) * n + i;
          for (unsigned todo = mask[b] & ~done; todo != 0u; todo &= todo - 1u) {
            const int q = __ffs(todo) - 1;
            bool adds;
            float g;
            if (capture(held[b], at, q0 + q, r0 + q0 + q, adds, g)) {
              done |= 1u << q;
              if (adds) acc[b] = acc[b] + g;
            }
          }
        }
      } else {
        for (int b = 0; b < nb; ++b) {
          const Segment geom[1] = {geometry(b)};
          const bool live[1] = {__any_sync(kFullWarp, geom[0].live)};
          if (!live[0]) continue;  // warp-uniform
          unsigned mask[1];
          disc_masks(geom, live, s_ctr, q0, r2, mask);
          const long long at = static_cast<long long>(b) * n + i;
          unsigned todo = geom[0].live ? mask[0] & valid & ~done : 0u;
          for (; todo != 0u; todo &= todo - 1u) {
            const int q = __ffs(todo) - 1;
            bool adds;
            float g;
            if (capture(geom[0], at, q0 + q, r0 + q0 + q, adds, g)) {
              done |= 1u << q;
              if (adds) g_amp[at] = g_amp[at] + g;
            }
          }
        }
      }
    }
  }
  if (in && kB > 0) {
#pragma unroll
    for (int b = 0; b < kHeld; ++b) {
      if (b < nb) g_amp[static_cast<long long>(b) * n + i] = acc[b];
    }
  }
}

// out[i] = planes[0][i] + planes[1][i] + ... in that order, i < total.
__global__ void __launch_bounds__(256) coverage_reduce_kernel(const float* __restrict__ planes,
                                                              int n_planes, long long total,
                                                              float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    float sum = planes[i];
    for (int h = 1; h < n_planes; ++h) sum += planes[static_cast<long long>(h) * total + i];
    out[i] = sum;
  }
}

}  // namespace

// origin, dir: (nb, n, 3) f32; t_env, amp, dist: (nb, n) f32; alive: (nb, n)
// bool; centers: (m, 3) f32; planes: (n_slabs, m, nbins) f32, zeroed by the
// caller: slab h, the chunks h, h + n_slabs, ... of 32 * kRays rays, adds into
// plane h. m, n, nb, n_slabs >= 1.
extern "C" int rfx_coverage_hist(const void* origin, const void* dir, const void* t_env,
                                 const void* amp, const void* dist, const void* alive, int nb,
                                 int n, const void* centers, int m, float radius, float c,
                                 float rate, int nbins, int n_slabs, void* planes, void* stream) {
  const dim3 grid((m + kWarps * kRx - 1) / (kWarps * kRx), n_slabs);
  coverage_hist_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(origin), static_cast<const float*>(dir),
      static_cast<const float*>(t_env), static_cast<const float*>(amp),
      static_cast<const float*>(dist), static_cast<const bool*>(alive), nb, n,
      static_cast<const float*>(centers), m, radius * radius, c, rate, nbins,
      static_cast<float*>(planes));
  return static_cast<int>(cudaGetLastError());
}

// planes: (n_planes, total) f32; out: (total,) f32, every element written
// with the planes' sum in plane order.
extern "C" int rfx_coverage_hist_reduce(const void* planes, int n_planes, long long total,
                                        void* out, void* stream) {
  if (total > 0) {
    const long long wanted = (total + 255) / 256;
    const int blocks = static_cast<int>(wanted < 65535 * 16 ? wanted : 65535 * 16);
    coverage_reduce_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(planes), n_planes, total, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// The phasor metric's per-bin table: table (nbins, 4) f32, entry k (sqrt
// s_k, cos(omega t_k), sin(omega t_k), t_k) with t_k = k * step, step =
// f32(window / (nbins - 1)), omega = f32(2 pi carrier). nbins >= 1.
extern "C" int rfx_phasor_table(int nbins, float step, float omega, void* table, void* stream) {
  phasor_table_kernel<<<(nbins + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      nbins, step, omega, static_cast<float4*>(table));
  return static_cast<int>(cudaGetLastError());
}

// The phasor metric's first pass: the segments and centers as
// rfx_coverage_hist takes them, the table of rfx_phasor_table. sums: (m,
// kSumFields) f32 (re, im, max s_k, any, w^2, w^2 t_k), the slabs' partials
// (partials: (n_slabs, m, kSumFields) f32 scratch) combined in slab order.
// The capture lists: pool (n_chunks * chunk) float2, ints (1 + n_chunks + 3 *
// n_slabs * m) int32, both scratch, kept for rfx_coverage_phasor_spread.
// m, n, nb >= 1, 1 <= n_slabs <= 32.
extern "C" int rfx_coverage_phasor(const void* origin, const void* dir, const void* t_env,
                                   const void* amp, const void* dist, const void* alive, int nb,
                                   int n, const void* centers, int m, float radius, float c,
                                   float rate, int nbins, const void* table, int n_slabs,
                                   int chunk, int n_chunks, void* pool, void* ints,
                                   void* partials, void* sums, void* stream) {
  if (n_slabs < 1 || n_slabs > 32) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PhasorLists lists(pool, ints, n_chunks, chunk, static_cast<long long>(n_slabs) * m);
  cudaError_t err = cudaMemsetAsync(lists.top, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + kWarps * kRx - 1) / (kWarps * kRx), n_slabs);
  coverage_phasor_kernel<<<grid, kWarps * 32, 0, s>>>(
      static_cast<const float*>(origin), static_cast<const float*>(dir),
      static_cast<const float*>(t_env), static_cast<const float*>(amp),
      static_cast<const float*>(dist), static_cast<const bool*>(alive), nb, n,
      static_cast<const float*>(centers), m, radius * radius, c, rate, nbins,
      static_cast<const float4*>(table), lists, static_cast<float*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(m) * kSumFields;
  phasor_reduce_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(partials), n_slabs, total, static_cast<float*>(sums));
  return static_cast<int>(cudaGetLastError());
}

// The phasor metric's spread: out (m,) f32, sum w^2 (t_k - t_mean)^2 per
// receiver with t_mean (m,) f32, from the lists that rfx_coverage_phasor left
// in pool and ints (the same arguments as that call); the tiles of the
// regions whose list was lost walk again (dev_partials: (n_slabs, m) f32
// scratch).
extern "C" int rfx_coverage_phasor_spread(const void* origin, const void* dir, const void* t_env,
                                          const void* amp, const void* dist, const void* alive,
                                          int nb, int n, const void* centers, int m,
                                          float radius, float c, float rate, int nbins,
                                          const void* table, int n_slabs, int chunk,
                                          int n_chunks, void* pool, void* ints,
                                          const void* t_mean, void* dev_partials, void* out,
                                          void* stream) {
  if (n_slabs < 1 || n_slabs > 32) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PhasorLists lists(pool, ints, n_chunks, chunk, static_cast<long long>(n_slabs) * m);
  const dim3 grid((m + kWarps * kRx - 1) / (kWarps * kRx), n_slabs);
  coverage_phasor_rewalk_kernel<<<grid, kWarps * 32, 0, s>>>(
      static_cast<const float*>(origin), static_cast<const float*>(dir),
      static_cast<const float*>(t_env), static_cast<const float*>(amp),
      static_cast<const float*>(dist), static_cast<const bool*>(alive), nb, n,
      static_cast<const float*>(centers), m, radius * radius, c, rate, nbins,
      static_cast<const float4*>(table), lists.lost, static_cast<const float*>(t_mean),
      static_cast<float*>(dev_partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long threads = 32LL * m;
  phasor_spread_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, s>>>(
      m, n_slabs, static_cast<const float*>(t_mean), lists,
      static_cast<const float*>(dev_partials), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The phasor metric's backward: the segments and centers as
// rfx_coverage_hist takes them (amp already scaled), step and omega as
// rfx_phasor_table takes them, coef: (m, 8) f32 per receiver (re, im, A, B,
// S, t_mean, var, unused); g_amp: (nb, n) f32, every element written.
// Scratch: table (nbins, 4) f32, the per-bin table built here; ints (n +
// ceil(n / 1024) + 1) int32: the live rays in ascending order, the scan
// blocks' offsets, and their count last. m, n, nb, nbins >= 1.
extern "C" int rfx_coverage_phasor_backward(const void* origin, const void* dir,
                                            const void* t_env, const void* amp, const void* dist,
                                            const void* alive, int nb, int n, const void* centers,
                                            int m, float radius, float c, float rate, int nbins,
                                            float step, float omega, const void* coef,
                                            void* table, void* ints, void* g_amp, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool* live = static_cast<const bool*>(alive);
  float* out = static_cast<float*>(g_amp);
  int* list = static_cast<int*>(ints);
  const int scan_blocks = static_cast<int>((static_cast<long long>(n) + kScanRays - 1) / kScanRays);
  int* offsets = list + n;
  phasor_table_kernel<<<(nbins + 255) / 256, 256, 0, s>>>(nbins, step, omega,
                                                          static_cast<float4*>(table));
  phasor_live_count<<<scan_blocks, kScanThreads, 0, s>>>(live, nb, n, offsets, out);
  phasor_live_scan<<<1, kScanThreads, 0, s>>>(offsets, scan_blocks);
  phasor_live_list<<<scan_blocks, kScanThreads, 0, s>>>(live, nb, n, offsets, list);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // As many threads as rays; the blocks past the live rays' count return at
  // once. The bounces of a ray in registers where there are at most eight.
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(n) + kBackThreads - 1) /
                                                kBackThreads);
#define RFX_PHASOR_BACKWARD(KB)                                                                \
  coverage_phasor_backward_kernel<KB><<<blocks, kBackThreads, 0, s>>>(                         \
      static_cast<const float*>(origin), static_cast<const float*>(dir),                       \
      static_cast<const float*>(t_env), static_cast<const float*>(amp),                        \
      static_cast<const float*>(dist), live, nb, n, static_cast<const float*>(centers), m,     \
      radius * radius, c, rate, nbins, static_cast<const float4*>(table),                      \
      static_cast<const float4*>(coef), list, offsets + scan_blocks, out)
  if (nb <= 1) {
    RFX_PHASOR_BACKWARD(1);
  } else if (nb <= 2) {
    RFX_PHASOR_BACKWARD(2);
  } else if (nb <= 4) {
    RFX_PHASOR_BACKWARD(4);
  } else if (nb <= 8) {
    RFX_PHASOR_BACKWARD(8);
  } else {
    RFX_PHASOR_BACKWARD(0);
  }
#undef RFX_PHASOR_BACKWARD
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rfx_coverage_phasor_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* rfx_coverage_phasor_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* rfx_coverage_phasor_spread_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* rfx_phasor_table_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* rfx_coverage_hist_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* rfx_coverage_hist_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
