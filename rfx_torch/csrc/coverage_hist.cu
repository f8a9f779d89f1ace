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
// - The rare lanes with a bit set finish those tests (`finish`: the roots,
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
  float* rows;  // row of the tile's first receiver in the slab's plane
};

// Finishes the tests whose discriminant was positive (`cand`, per ray slot)
// and adds the wins: `done` gains the receivers that won. Every lane of the
// warp calls it.
__device__ __forceinline__ void finish(const Segment (&seg)[kRays], const unsigned (&cand)[kRays],
                                       unsigned (&done)[kRays], const Tile& t) {
  Scratch& scratch = *t.scratch;
  unsigned todo[kRays], win[kRays];
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
    const float4 ctr = t.centers[r];
    const float t_rx = sphere_t(s.ox, s.oy, s.oz, s.dx, s.dy, s.dz, ctr.x, ctr.y, ctr.z, t.r2);
    if (t_rx < kMissThreshold && s.te > t_rx) {
#pragma unroll
      for (int j = 0; j < kRays; ++j) win[j] |= k == j ? 1u << r : 0u;
      const int bin = delay_bin((s.dist + t_rx) / t.c * t.rate);
      scratch.bin[k][r][t.lane] = bin < t.nbins ? bin : -1;
      scratch.amp[k][t.lane] = s.amp;
    }
  }
  __syncwarp();
  // The adds: per ray slot and receiver, the lanes that won it group by bin;
  // a group's lowest lane sums the group's amplitudes in lane order and adds
  // the sum to the receiver's row. Within one such step every add goes to
  // another bin, and the __syncwarp between steps orders the steps' adds, so
  // a bin is added to in one order: slab, chunk, bounce, ray slot.
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    done[k] |= win[k];
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
          float* at = t.rows + static_cast<size_t>(r) * t.nbins + bin;
          *at = *at + sum;
        }
      }
      __syncwarp();
    }
  }
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
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rx0 = (blockIdx.x * kWarps + warp) * kRx;
  // Chunk j of 32 * kRays rays belongs to slab j % gridDim.y: rays that are
  // neighbours in Morton order reach the same receivers, and so the captures
  // of a receiver near the transmitter spread over all slabs.
  const long long chunk = 32 * kRays;
  const long long stride = gridDim.y * chunk;
  long long base = blockIdx.y * chunk;
  if (rx0 >= m || base >= n) return;  // the whole warp; no barrier follows
  const int nrx = min(kRx, m - rx0);

  Tile tile;
  tile.centers = shared_centers[warp];
  tile.scratch = &shared_scratch[warp];
  tile.all_rx = nrx == 32 ? kFullWarp : (1u << nrx) - 1u;
  tile.r2 = r2;
  tile.c = c;
  tile.rate = rate;
  tile.nbins = nbins;
  tile.lane = lane;
  const bool mine = lane < nrx;
  if (lane < kRx) {
    shared_centers[warp][lane] =
        mine ? make_float4(centers[3 * (rx0 + lane)], centers[3 * (rx0 + lane) + 1],
                           centers[3 * (rx0 + lane) + 2], 0.0f)
             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncwarp();
  tile.rows = planes + (static_cast<size_t>(blockIdx.y) * m + rx0) * nbins;

  // The steps are (chunk, bounce) pairs; the next step's segments are loaded
  // before this step's tests, so that their latency passes behind the
  // arithmetic.
  Segment next[kRays];
  unsigned done[kRays];
  int b = 0;
  load_segments(next, base, b, n, lane, origin, dir, t_env, amp, dist, alive);
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
      load_segments(next, next_base, last_bounce ? 0 : b + 1, n, lane, origin, dir, t_env, amp,
                    dist, alive);
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
          const float ocx = seg[k].ox - ctr.x, ocy = seg[k].oy - ctr.y, ocz = seg[k].oz - ctr.z;
          const float bq = ocx * seg[k].dx + ocy * seg[k].dy + ocz * seg[k].dz;
          const float cq = ocx * ocx + ocy * ocy + ocz * ocz - r2;
          const float disc = bq * bq - cq;
          if (disc > 0.0f) cand[k] |= 1u << r;
        }
      }
      bool some = false;
#pragma unroll
      for (int k = 0; k < kRays; ++k) {
        cand[k] = seg[k].live ? cand[k] & tile.all_rx : 0u;
        some = some || (cand[k] & ~done[k]) != 0u;
      }
      if (__any_sync(kFullWarp, some)) finish(seg, cand, done, tile);
    }
    if (!more) break;
    base = next_base;
    b = last_bounce ? 0 : b + 1;
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

extern "C" const char* rfx_coverage_hist_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* rfx_coverage_hist_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
