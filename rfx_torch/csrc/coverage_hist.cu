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
// (`disc_positive`, `sphere_win`, `phasor_entry`) and adds each segment's
// terms over the receivers in ascending order.

#include <cuda_runtime.h>

namespace {

constexpr int kRx = 16;    // receivers of one warp, at most 32
constexpr int kRays = 4;   // segments a lane holds at once
constexpr int kWarps = 4;  // warps of one block
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr float kTMin = 1e-4f;
constexpr float kMiss = 1e30f;
constexpr float kMissThreshold = 1e29f;

static_assert(kRx >= 1 && kRx <= 32, "a ray slot's wins are one bit a receiver");

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

struct Segment {
  float ox, oy, oz, dx, dy, dz, te, dist, amp;
  bool live;
};

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

// The hot loop's test of a segment against a receiver: the discriminant of
// sphere_t, in its expressions and order, above zero. Only a segment that
// passes it can be won.
__device__ __forceinline__ bool disc_positive(const Segment& s, float4 ctr, float r2) {
  const float ocx = s.ox - ctr.x, ocy = s.oy - ctr.y, ocz = s.oz - ctr.z;
  const float bq = ocx * s.dx + ocy * s.dy + ocz * s.dz;
  const float cq = ocx * ocx + ocy * ocy + ocz * ocz - r2;
  const float disc = bq * bq - cq;
  return disc > 0.0f;
}

// The capture rule for a segment whose discriminant was positive: a win iff
// the sphere's root is a hit (t_rx < 1e29) before the environment's (t_env >
// t_rx); `bin` gets the win's delay bin, -1 to drop it (outside [0, nbins)).
__device__ __forceinline__ bool sphere_win(const Segment& s, float4 ctr, float r2, float c,
                                           float rate, int nbins, int& bin) {
  const float t_rx = sphere_t(s.ox, s.oy, s.oz, s.dx, s.dy, s.dz, ctr.x, ctr.y, ctr.z, r2);
  if (!(t_rx < kMissThreshold && s.te > t_rx)) return false;
  const int b = delay_bin((s.dist + t_rx) / c * rate);
  bin = b < nbins ? b : -1;
  return true;
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
// prunes it, and 0 * inf would be NaN). One thread a ray holds the ray's
// bounces (origin, direction, life; in registers for kB > 0, read again for
// each receiver where kB is 0) and takes the receivers in ascending order, in
// tiles staged in shared memory; for each receiver its bounces in order until
// the first win, by the hot loop's test (`disc_positive`), the capture rule
// (`sphere_win`) and the table's entry (`phasor_entry`): the forward's
// device code, so the captures are the forward's. Each thread writes its
// segments' sums once, added in ascending receiver order: no atomic, the same
// bits from run to run. What bounds it: the forward walk's sphere tests, one
// per live segment and receiver.
constexpr int kBackThreads = 256;  // rays of a block
constexpr int kBackRx = 256;       // receivers of a staged tile

template <int kB>
__global__ void __launch_bounds__(kBackThreads) coverage_phasor_backward_kernel(
    const float* __restrict__ origin, const float* __restrict__ dir,
    const float* __restrict__ t_env, const float* __restrict__ amp,
    const float* __restrict__ dist, const bool* __restrict__ alive, int nb, int n,
    const float* __restrict__ centers, int m, float r2, float c, float rate, int nbins, float step,
    float omega, const float4* __restrict__ coef, float* __restrict__ g_amp) {
  __shared__ float4 s_ctr[kBackRx];
  __shared__ float4 s_k0[kBackRx];  // (re, im, A, B)
  __shared__ float4 s_k1[kBackRx];  // (S, t_mean, var, 0)
  const long long i = static_cast<long long>(blockIdx.x) * kBackThreads + threadIdx.x;
  const bool in = i < n;
  constexpr int kHeld = kB > 0 ? kB : 1;
  // Origin, direction and life of bounce b (b < nb).
  auto geometry = [&](int b) {
    Segment s;
    const long long at = static_cast<long long>(b) * n + (in ? i : 0);
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
  float acc[kHeld];
  bool any_live = false;
#pragma unroll
  for (int b = 0; b < kHeld; ++b) {
    acc[b] = 0.0f;
    if (kB > 0) {
      held[b] = geometry(b < nb ? b : 0);
      held[b].live = held[b].live && b < nb;
      any_live = any_live || held[b].live;
    }
  }
  if (kB == 0) {
    for (int b = 0; b < nb; ++b) {
      const long long at = static_cast<long long>(b) * n + i;
      if (in) {
        any_live = any_live || alive[at];
        g_amp[at] = 0.0f;  // the sums go to g_amp directly
      }
    }
  }
  if (!__syncthreads_or(any_live)) {  // block-uniform: no live segment, no capture
    if (in && kB > 0) {
      for (int b = 0; b < nb; ++b) g_amp[static_cast<long long>(b) * n + i] = 0.0f;
    }
    return;
  }
  // Receiver q of the tile against segment s of bounce b: true on a win (the
  // ray's view for that receiver ends), whose term goes to bounce b's sum.
  auto take = [&](const Segment& geom, int b, int q) {
    const float4 ctr = s_ctr[q];
    if (!geom.live || !disc_positive(geom, ctr, r2)) return false;
    const long long at = static_cast<long long>(b) * n + i;
    Segment s = geom;
    s.te = t_env[at];
    s.dist = dist[at];
    int bin;
    if (!sphere_win(s, ctr, r2, c, rate, nbins, bin)) return false;
    if (bin < 0) return true;  // dropped: the win counts, its path adds nothing
    const float4 e = phasor_entry(bin, nbins, step, omega);
    const float4 k0 = s_k0[q], k1 = s_k1[q];
    float g = 0.0f;
    if (k0.z != 0.0f) g = e.x * (k0.x * e.y + k0.y * e.z) * k0.z;
    if (k0.w != 0.0f || k1.x != 0.0f) {
      float u = k0.w;
      if (k1.x != 0.0f) {
        const float dt = e.w - k1.y;
        u = u + k1.x * (dt * dt - k1.z);
      }
      const float aw = amp[at] * e.x;
      g = g + aw * e.x * u;
    }
    if (kB > 0) {
      acc[b] = acc[b] + g;
    } else {
      g_amp[at] = g_amp[at] + g;
    }
    return true;
  };
  for (int r0 = 0; r0 < m; r0 += kBackRx) {
    const int nr = min(kBackRx, m - r0);
    __syncthreads();  // the previous tile is read
    for (int q = threadIdx.x; q < nr; q += kBackThreads) {
      const long long r = r0 + q;
      s_ctr[q] = make_float4(centers[3 * r], centers[3 * r + 1], centers[3 * r + 2], 0.0f);
      s_k0[q] = coef[2 * r];
      s_k1[q] = coef[2 * r + 1];
    }
    __syncthreads();
    if (!any_live) continue;
    for (int q = 0; q < nr; ++q) {
      if (kB > 0) {
#pragma unroll
        for (int b = 0; b < kHeld; ++b) {
          if (take(held[b], b, q)) break;
        }
      } else {
        for (int b = 0; b < nb; ++b) {
          if (take(geometry(b), b, q)) break;
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
// S, t_mean, var, unused); g_amp: (nb, n) f32, every element written. m, n,
// nb >= 1.
extern "C" int rfx_coverage_phasor_backward(const void* origin, const void* dir,
                                            const void* t_env, const void* amp, const void* dist,
                                            const void* alive, int nb, int n, const void* centers,
                                            int m, float radius, float c, float rate, int nbins,
                                            float step, float omega, const void* coef,
                                            void* g_amp, void* stream) {
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(n) + kBackThreads - 1) /
                                                kBackThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The bounces of a ray in registers where there are at most eight of them.
#define RFX_PHASOR_BACKWARD(KB)                                                                \
  coverage_phasor_backward_kernel<KB><<<blocks, kBackThreads, 0, s>>>(                         \
      static_cast<const float*>(origin), static_cast<const float*>(dir),                       \
      static_cast<const float*>(t_env), static_cast<const float*>(amp),                        \
      static_cast<const float*>(dist), static_cast<const bool*>(alive), nb, n,                 \
      static_cast<const float*>(centers), m, radius * radius, c, rate, nbins, step, omega,      \
      static_cast<const float4*>(coef), static_cast<float*>(g_amp))
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
