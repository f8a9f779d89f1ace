// The map engine's capture pass: for a chunk of receiver spheres, the first
// capture of each receiver along each ray's bounces, and its backward.
//
// Replaces the XLA program of rfx/coverage.py:56-81 (_rx_ir_from_segments,
// under the vmap / lax.map of :185-203) up to the histogram, with the custom
// VJP of the receiver sphere (rfx/ops/intersect.py:206-251) and what jax.grad
// takes through the capture's `where`s and the histogram's scatter. Per
// receiver r and segment (b, n): the analytic sphere hit t_rx, a capture
// where the segment is alive, t_rx < 1e29 and t_env > t_rx, and the first
// capture along the bounce axis ends the receiver's view of the ray
// (sphere.cuh: the device code of the coverage kernels).
//
// rfx_map_capture (forward) writes the first-capture record: one byte per
// receiver and ray, (R, N) uint8, the bounce b of the receiver's first
// capture along the ray or 0xFF for none. The IR histogram's record entry
// (histogram.cu, rfx_ir_histogram_record) bins it, recomputing each
// capture's amp * scale and dist + t_rx, so the IRs are the plain map
// engine's bits (rfx_torch/ops/map_capture.py:map_capture_plain's rows
// through K-H). The record is what the backward keeps: B times less than
// the (R, B, N) mask, and it says where the captures are.
//
// rfx_map_capture_backward, given the IRs' cotangent g (R, nbins) and the
// record, adds for each capture (r, b, n), with delay = (dist + t_rx) / c *
// rate as K-H bins it:
//   hard: g_a = g[r, int(delay)] (0 outside the window), g_dist = 0;
//   soft: lo = floor(delay), w = delay - lo,
//         g_a = (1 - w) g[r, lo] + w g[r, lo + 1],
//         g_dist = amp scale (g[r, lo + 1] - g[r, lo]) rate / c;
// g_amplitude += g_a scale, g_distance += g_dist, and through the sphere's
// implicit-function derivative, with q = o + t_rx d - C and q.d clamped away
// from 0 at qd_floor = 1e-6 max(radius, 1e-6) (the clamp of
// rfx_torch/ops/intersect.py:_SphereHit), gg = g_dist / q.d:
// g_origin += -gg q, g_direction += -(gg t_rx) q, and the receiver's center
// gains gg q. A segment's sums run over the receivers in ascending order from
// +0, with no atomics: the same bits from run to run, and the plain
// version's (map_capture_backward_plain) expressions in its order. The
// centers' gradient, where asked for, is a fixed shuffle tree per warp for
// each receiver that a lane of the warp captured, the warps added in order,
// then the blocks in order, 64 at a time, and those sums in order. The sums
// that the gradients in scale and radius take, over every capture, g_a amp
// (d IR / d scale) and gg (d IR / d radius is their sum times the radius,
// the sphere's dt/dr = r / q.d), add each f32 term in double, per thread in
// capture order, then a fixed tree per warp, the warps in order and the
// blocks as the centers' are.
//
// What bounds them on an H100: the forward reads the segments (37 bytes
// each, 155 MB at the inverse solve's 64 receivers x 4 bounces x 1,048,576
// rays) and writes the record (64 MB there); its sphere tests (17 f32
// operations a live segment and receiver, an instruction each without
// contraction) come next. The backward reads the record and writes 32 bytes
// a segment (134 MB), and touches a segment's geometry only at a capture.
// The design: the forward takes a ray a thread and 32 receivers a block, the
// centers in shared memory and a `done` bit a receiver in a register; each
// record byte is stored once, the bounce at the capture, 0xFF at the end
// where none (coalesced across the warp), so a thread holds nothing else and
// the card keeps enough warps in flight to hide the segments' loads; the
// receiver tiles of one ray block are neighbouring blocks, so the second
// finds the segments in L2. The
// backward takes a ray a thread; it loads 16 record bytes at a time
// (coalesced across the warp), skips receivers that no lane of the warp
// captured, and holds four bounces' sums in registers, so each output is
// written once and nothing is zeroed or read back.
//
// The icosphere receiver (rfx_map_capture_ico, rfx_map_capture_backward_ico;
// rfx/coverage.py:38-54, the reference's 80-face receiver): the same
// kernels, templated on the receiver. A receiver's t is the closest hit over
// its 80 faces (v0, e1, e2), read from (R, 80, 9) rows that torch computes
// as unit * r + c (rfx_torch.tracer.icosphere_tris, icosphere_soa's bits), behind
// brute_hit.cuh's bounding-sphere cull, which skips the 80 tests for a
// segment whose line passes outside the sphere's reach (all but about 1e-4
// of the (segment, receiver) pairs of a coverage sweep); the record is the
// same byte. The backward finds the selected face again at each capture
// and applies the VJP of its closed-form t (closed_form_t_vjp,
// rfx/ops/intersect.py:159-185) to the length's cotangent: the segment
// gains g_o and g_d, the center g_v0 (in place of gg q) and the radius
// g_v0.unit_v0 + g_e1.unit_e1 + g_e2.unit_e2 (in place of gg, and not
// multiplied by the radius), in the same orders and with the same folds.
// What bounds the icosphere's forward is the cull on every live segment and
// receiver (33 operations, against the sphere's 17); the 80 tests run only
// where it passes.
//
// Not carried over from the TPU: nothing; rfx runs this as XLA's fusion of
// the broadcast.

#include <cuda_runtime.h>

#include "brute_hit.cuh"
#include "sphere.cuh"

namespace {

using namespace rfx_capture;  // sphere_capture, sphere_t, delay_bin, Segment
using rfx_brute::kIcoFaces;
using rfx_brute::kTriFloats;

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr unsigned kNone = 0xFFu;  // the record's "no capture"
constexpr int kThreads = 256;      // rays of a forward block, one a thread
constexpr int kTile = 32;          // receivers a forward block: one bit each in `done`
constexpr int kBackThreads = 128;  // rays of a backward block, one a thread
constexpr int kBackWarps = kBackThreads / 32;
constexpr int kStage = 256;        // centers the backward stages in shared memory at once
constexpr int kBatch = 16;         // record bytes a backward thread loads at once
constexpr int kGroup = 4;          // bounces whose sums a backward thread holds in registers
constexpr int kIcoFloats = kIcoFaces * kTriFloats;  // a receiver's faces in `tris`

__device__ __forceinline__ rfx_brute::Ray ray_of(const Segment& s) {
  return rfx_brute::Ray{s.ox, s.oy, s.oz, s.dx, s.dy, s.dz};
}

// The capture rule of receiver `ctr`: the analytic sphere's (sphere.cuh), or
// kIco the icosphere's, its faces `tris` ((80, 9) f32) behind the cull of
// brute_hit.cuh; `t_rx` gets the receiver's t.
template <bool kIco>
__device__ __forceinline__ bool captures(const Segment& s, float4 ctr, float r2, float radius,
                                         const float* tris, float& t_rx) {
  if constexpr (kIco) {
    int face;
    t_rx = rfx_brute::ico_t(ray_of(s), tris, ctr.x, ctr.y, ctr.z, radius, face);
    return t_rx < kMissThreshold && s.te > t_rx;
  } else {
    return sphere_capture(s, ctr, r2, t_rx);
  }
}

// A block: kThreads rays x the kTile receivers of tile blockIdx.x % tiles;
// the tiles of one ray block are neighbouring blocks. A receiver's byte is
// stored once: its bounce where it first captures the ray, 0xFF after the
// last bounce where it never did. kIco: receiver r's faces are
// tris[r * kIcoFloats, (r + 1) * kIcoFloats).
template <bool kIco>
__global__ void __launch_bounds__(kThreads) map_record_kernel(
    const float* __restrict__ origin, const float* __restrict__ dir,
    const float* __restrict__ t_env, const bool* __restrict__ alive, int nb, int n,
    const float* __restrict__ centers, int m, int tiles, float r2, float radius,
    const float* __restrict__ tris, unsigned char* __restrict__ record) {
  __shared__ float4 s_ctr[kTile];
  const int r0 = static_cast<int>(blockIdx.x % tiles) * kTile;
  const long long i = static_cast<long long>(blockIdx.x / tiles) * kThreads + threadIdx.x;
  const int tile = min(kTile, m - r0);
  if (threadIdx.x < tile) {
    const long long r = r0 + threadIdx.x;
    s_ctr[threadIdx.x] = make_float4(centers[3 * r], centers[3 * r + 1], centers[3 * r + 2], 0.0f);
  }
  __syncthreads();
  if (i >= n) return;
  unsigned char* out = record + static_cast<long long>(r0) * n + i;  // receiver r0's byte
  const unsigned all = tile == kTile ? ~0u : (1u << tile) - 1u;
  unsigned done = 0u;  // bit q: receiver r0 + q captured the ray already
  for (int b = 0; b < nb && done != all; ++b) {
    const long long at = static_cast<long long>(b) * n + i;
    if (!alive[at]) continue;
    Segment s;
    s.ox = origin[3 * at];
    s.oy = origin[3 * at + 1];
    s.oz = origin[3 * at + 2];
    s.dx = dir[3 * at];
    s.dy = dir[3 * at + 1];
    s.dz = dir[3 * at + 2];
    s.te = t_env[at];
#pragma unroll 4
    for (int q = 0; q < tile; ++q) {
      float t_rx;
      if (!((done >> q) & 1u) &&
          captures<kIco>(s, s_ctr[q], r2, radius,
                         kIco ? tris + static_cast<long long>(r0 + q) * kIcoFloats : nullptr,
                         t_rx)) {
        done |= 1u << q;
        out[static_cast<long long>(q) * n] = static_cast<unsigned char>(b);
      }
    }
  }
  for (int q = 0; q < tile; ++q) {
    if (!((done >> q) & 1u)) out[static_cast<long long>(q) * n] = static_cast<unsigned char>(kNone);
  }
}

struct BackArgs {
  const float* amp;
  const float* dist;
  const float* g;  // (m, nbins)
  float r2, scale, c, rate, qd_floor;
  int nbins;
  bool soft;
  double* sums_partials;  // null, or (blocks, 2): a block's sums of g_a amp and gg (kIco: of
                          // g_a amp and d IR / d radius)
  const float* tris;      // kIco: (m, 80, 9) f32, the receivers' faces
  const float* unit;      // kIco: (80, 9) f32, the unit icosphere's (v0, e1, e2)
};

// Byte u (0 <= u < 16) of four packed words, without a local-memory index.
__device__ __forceinline__ unsigned byte_of(const unsigned (&w)[kBatch / 4], int u) {
  const unsigned word = u < 8 ? (u < 4 ? w[0] : w[1]) : (u < 12 ? w[2] : w[3]);
  return (word >> (8 * (u & 3))) & kNone;
}

// A thread a ray. For each group of kGroup bounces: the receivers in
// ascending order, kBatch record bytes at a time; a receiver that some lane
// of the warp captured at a bounce of the group is walked by the warp, the
// capturing lanes adding its terms to their segment's sums in registers;
// then the group's outputs are written. kCenters: each such receiver's gg q
// summed over the warp by a fixed shuffle tree into the warp's row of the
// scratch (lane 0 writes every entry of its row, 0 where no lane captured),
// the warps added in order into the block's partial (the first group stores,
// later groups add their share). kIco: the receiver is the icosphere; its t
// at a capture is the closest hit over its faces (the cull passed there),
// and the length's cotangent flows through the selected face's closed-form
// t (brute_hit.cuh's closed_form_t_vjp) to the segment, to the center (g_v0)
// and to the radius (g_v0.unit_v0 + g_e1.unit_e1 + g_e2.unit_e2).
template <bool kCenters, bool kIco>
__global__ void __launch_bounds__(kBackThreads) map_capture_backward_kernel(
    const float* __restrict__ origin, const float* __restrict__ dir,
    const unsigned char* __restrict__ record, int nb, int n, const float* __restrict__ centers,
    int m, BackArgs a, float* __restrict__ g_origin, float* __restrict__ g_dir,
    float* __restrict__ g_amp, float* __restrict__ g_dist, float* __restrict__ gc_partials) {
  __shared__ float4 s_ctr[kStage];
  __shared__ double s_sums[2][kBackWarps];
  extern __shared__ float s_gc[];  // kCenters: (kBackWarps, kStage, 3)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long i = static_cast<long long>(blockIdx.x) * kBackThreads + tid;
  const bool in = i < n;
  double sum_amp = 0.0, sum_gg = 0.0;
  for (int b0 = 0; b0 < nb; b0 += kGroup) {
    // o (3), d (3), amplitude, distance of bounce b0 + j
    float acc[kGroup][8];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[j][k] = 0.0f;
    }
    for (int s0 = 0; s0 < m; s0 += kStage) {
      const int staged = min(kStage, m - s0);
      __syncthreads();  // the last stage's centers and scratch are read no more
      for (int k = tid; k < staged; k += kBackThreads) {
        const long long r = s0 + k;
        s_ctr[k] = make_float4(centers[3 * r], centers[3 * r + 1], centers[3 * r + 2], 0.0f);
      }
      __syncthreads();
      for (int q0 = 0; q0 < staged; q0 += kBatch) {
        unsigned w[kBatch / 4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {  // the batch's loads, issued together
          const unsigned rec = (in && q0 + u < staged)
                                   ? record[static_cast<long long>(s0 + q0 + u) * n + i]
                                   : kNone;
          w[u / 4] |= rec << (8 * (u % 4));
        }
        unsigned mine = 0u;  // bit u: receiver q0 + u captured this ray at a bounce of the group
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const unsigned rec = (w[u / 4] >> (8 * (u % 4))) & kNone;
          if (rec != kNone && rec - static_cast<unsigned>(b0) < static_cast<unsigned>(kGroup)) {
            mine |= 1u << u;
          }
        }
        unsigned live = __reduce_or_sync(kFullWarp, mine);
        if (kCenters && lane == 0) {
          for (int u = 0; u < kBatch && q0 + u < staged; ++u) {
            if (!((live >> u) & 1u)) {
              float* row = s_gc + (warp * kStage + q0 + u) * 3;
              row[0] = row[1] = row[2] = 0.0f;
            }
          }
        }
        for (; live != 0u; live &= live - 1u) {
          const int u = __ffs(live) - 1;
          const int q = q0 + u;
          float gq[3] = {0.0f, 0.0f, 0.0f};
          if ((mine >> u) & 1u) {
            const int bb = static_cast<int>(byte_of(w, u)) - b0;
            const long long at = static_cast<long long>(b0 + bb) * n + i;
            const float ox = origin[3 * at], oy = origin[3 * at + 1], oz = origin[3 * at + 2];
            const float dx = dir[3 * at], dy = dir[3 * at + 1], dz = dir[3 * at + 2];
            const float amp = a.amp[at], dist = a.dist[at];
            const float4 ctr = s_ctr[q];
            const rfx_brute::Ray ray{ox, oy, oz, dx, dy, dz};
            const float* rtris = kIco ? a.tris + static_cast<long long>(s0 + q) * kIcoFloats
                                      : nullptr;
            int face = -1;
            const float t = kIco ? rfx_brute::closest_hit(ray, rtris, kIcoFaces, rfx_brute::kTMin,
                                                          rfx_brute::kTMax, face)
                                 : sphere_t(ox, oy, oz, dx, dy, dz, ctr.x, ctr.y, ctr.z, a.r2);
            const float* gr = a.g + static_cast<long long>(s0 + q) * a.nbins;
            const float delay = (dist + t) / a.c * a.rate;
            if (!a.soft) {
              const int k = delay_bin(delay);
              const float ga = (k >= 0 && k < a.nbins) ? gr[k] : 0.0f;
              sum_amp += static_cast<double>(ga * amp);
#pragma unroll
              for (int j = 0; j < kGroup; ++j) {
                if (j == bb) acc[j][6] = acc[j][6] + ga * a.scale;
              }
            } else {
              const float lo = floorf(delay);
              const float wt = delay - lo;
              float g_lo = 0.0f, g_hi = 0.0f;
              if (lo >= -1.0f && lo < 2147483647.0f) {
                const int k = static_cast<int>(lo);
                if (k >= 0 && k < a.nbins) g_lo = gr[k];
                if (k + 1 < a.nbins) g_hi = gr[k + 1];
              }
              const float ga = (1.0f - wt) * g_lo + wt * g_hi;
              const float amp_row = amp * a.scale;
              const float gd = amp_row * (g_hi - g_lo) * a.rate / a.c;
              float terms[8];  // the layout of acc
              sum_amp += static_cast<double>(ga * amp);
              if constexpr (kIco) {
                rfx_brute::TGrad tg;
                const float* tri = rtris + kTriFloats * face;
                rfx_brute::closed_form_t_vjp(ray, tri, gd, tg);
                const float* u = a.unit + kTriFloats * face;
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                  terms[k] = tg.go[k];
                  terms[3 + k] = tg.gd[k];
                  gq[k] = -tg.go[k];
                }
                const float g_r = ((gq[0] * u[0] + gq[1] * u[1] + gq[2] * u[2]) +
                                   (tg.ge1[0] * u[3] + tg.ge1[1] * u[4] + tg.ge1[2] * u[5])) +
                                  (tg.ge2[0] * u[6] + tg.ge2[1] * u[7] + tg.ge2[2] * u[8]);
                sum_gg += static_cast<double>(g_r);
              } else {
                const float qv[3] = {(ox + t * dx) - ctr.x, (oy + t * dy) - ctr.y,
                                     (oz + t * dz) - ctr.z};
                const float qd = qv[0] * dx + qv[1] * dy + qv[2] * dz;
                const float mag = fmaxf(fabsf(qd), a.qd_floor);
                const float qd_safe = qd < 0.0f ? -mag : mag;
                const float gg = gd / qd_safe;
                const float ggt = gg * t;
                sum_gg += static_cast<double>(gg);
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                  terms[k] = -gg * qv[k];
                  terms[3 + k] = -ggt * qv[k];
                  gq[k] = gg * qv[k];
                }
              }
              terms[6] = ga * a.scale;
              terms[7] = gd;
#pragma unroll
              for (int j = 0; j < kGroup; ++j) {
                if (j == bb) {
#pragma unroll
                  for (int k = 0; k < 8; ++k) acc[j][k] = acc[j][k] + terms[k];
                }
              }
            }
          }
          if (kCenters) {
            if (a.soft) {  // hard binning has no gradient in the lengths
#pragma unroll
              for (int off = 16; off > 0; off /= 2) {
#pragma unroll
                for (int k = 0; k < 3; ++k) gq[k] += __shfl_down_sync(kFullWarp, gq[k], off);
              }
            }
            if (lane == 0) {
              float* row = s_gc + (warp * kStage + q) * 3;
              row[0] = gq[0];
              row[1] = gq[1];
              row[2] = gq[2];
            }
          }
        }
      }
      if (kCenters) {
        __syncthreads();
        for (int j = tid; j < 3 * staged; j += kBackThreads) {
          float sum = 0.0f;
#pragma unroll
          for (int v = 0; v < kBackWarps; ++v) sum = sum + s_gc[v * 3 * kStage + j];
          float* p = gc_partials + (static_cast<long long>(blockIdx.x) * m + s0) * 3 + j;
          *p = b0 == 0 ? sum : *p + sum;
        }
      }
    }
    if (in) {
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (b0 + j < nb) {
          const long long at = static_cast<long long>(b0 + j) * n + i;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            g_origin[3 * at + k] = acc[j][k];
            g_dir[3 * at + k] = acc[j][3 + k];
          }
          g_amp[at] = acc[j][6];
          g_dist[at] = acc[j][7];
        }
      }
    }
  }
  if (a.sums_partials != nullptr) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      sum_amp += __shfl_down_sync(kFullWarp, sum_amp, off);
      sum_gg += __shfl_down_sync(kFullWarp, sum_gg, off);
    }
    if (lane == 0) {
      s_sums[0][warp] = sum_amp;
      s_sums[1][warp] = sum_gg;
    }
    __syncthreads();
    if (tid < 2) {
      double acc = 0.0;
#pragma unroll
      for (int v = 0; v < kBackWarps; ++v) acc += s_sums[tid][v];
      a.sums_partials[2 * static_cast<long long>(blockIdx.x) + tid] = acc;
    }
  }
}

int backward_blocks(int n) {
  return static_cast<int>((static_cast<long long>(n) + kBackThreads - 1) / kBackThreads);
}

constexpr int kFold = 64;  // block partials that a first-level fold adds

int fold_chunks(int blocks) { return (blocks + kFold - 1) / kFold; }

// out[c * total + j] = in[k * total + j] summed over the rows k of chunk c,
// [c * per, min((c + 1) * per, rows)), in row order from +0, eight loads in
// flight. grid (ceil(total / 256), chunks).
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(256) fold_kernel(const Tin* __restrict__ in, int rows, int total,
                                                   int per, Tout* __restrict__ out) {
  const int j = blockIdx.x * 256 + threadIdx.x;
  if (j >= total) return;
  const int k0 = blockIdx.y * per, k1 = min(k0 + per, rows);
  constexpr int kAhead = 8;
  Tin acc = 0;
  int k = k0;
  for (; k + kAhead <= k1; k += kAhead) {
    Tin v[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) v[u] = in[static_cast<long long>(k + u) * total + j];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) acc = acc + v[u];
  }
  for (; k < k1; ++k) acc = acc + in[static_cast<long long>(k) * total + j];
  out[static_cast<long long>(blockIdx.y) * total + j] = static_cast<Tout>(acc);
}

// The blocks' partials, rows [0, blocks) of `scratch` ((blocks + chunks,
// total)), into out (total): chunks of kFold rows each summed in row order
// into rows [blocks, blocks + chunks), then those in order.
template <typename T, typename Tout>
cudaError_t fold_blocks(T* scratch, int blocks, int total, Tout* out, cudaStream_t s) {
  const int chunks = fold_chunks(blocks);
  T* mid = scratch + static_cast<long long>(blocks) * total;
  const unsigned cols = static_cast<unsigned>((total + 255) / 256);
  fold_kernel<T, T><<<dim3(cols, chunks), 256, 0, s>>>(scratch, blocks, total, kFold, mid);
  fold_kernel<T, Tout><<<dim3(cols, 1), 256, 0, s>>>(mid, chunks, total, chunks, out);
  return cudaGetLastError();
}

// The record kernel's launch: a block a ray block and receiver tile.
template <bool kIco>
int launch_record(const void* origin, const void* dir, const void* t_env, const void* alive,
                  int nb, int n, const void* centers, int m, float radius, const void* tris,
                  void* record, void* stream) {
  const int tiles = (m + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>((n + kThreads - 1) / kThreads) * tiles;
  map_record_kernel<kIco><<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(origin), static_cast<const float*>(dir),
      static_cast<const float*>(t_env), static_cast<const bool*>(alive), nb, n,
      static_cast<const float*>(centers), m, tiles, radius * radius, radius,
      static_cast<const float*>(tris), static_cast<unsigned char*>(record));
  return static_cast<int>(cudaGetLastError());
}

// The backward kernel's launch and the folds of its partials.
template <bool kIco>
int launch_backward(const void* origin, const void* dir, const void* record, int nb, int n,
                    const void* centers, int m, const BackArgs& a, void* g_origin, void* g_dir,
                    void* g_amp, void* g_dist, void* gc_partials, void* g_centers, void* sums,
                    cudaStream_t s) {
  const int blocks = backward_blocks(n);
#define RFX_MAP_BACKWARD(KC, SMEM)                                                             \
  map_capture_backward_kernel<KC, kIco><<<blocks, kBackThreads, SMEM, s>>>(                    \
      static_cast<const float*>(origin), static_cast<const float*>(dir),                       \
      static_cast<const unsigned char*>(record), nb, n, static_cast<const float*>(centers), m, \
      a, static_cast<float*>(g_origin), static_cast<float*>(g_dir),                            \
      static_cast<float*>(g_amp), static_cast<float*>(g_dist), static_cast<float*>(gc_partials))
  if (gc_partials == nullptr) {
    RFX_MAP_BACKWARD(false, 0);
  } else {
    RFX_MAP_BACKWARD(true, static_cast<int>(sizeof(float)) * kBackWarps * kStage * 3);
  }
#undef RFX_MAP_BACKWARD
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (gc_partials != nullptr) {
    err = fold_blocks(static_cast<float*>(gc_partials), blocks, 3 * m,
                      static_cast<float*>(g_centers), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (a.sums_partials != nullptr) {
    err = fold_blocks(a.sums_partials, blocks, 2, static_cast<float*>(sums), s);
  }
  return static_cast<int>(err);
}

}  // namespace

// origin, dir: (nb, n, 3) f32; t_env: (nb, n) f32; alive: (nb, n) bool;
// centers: (m, 3) f32. record: (m, n) uint8, every byte written: the bounce
// of the receiver's first capture along the ray, 0xFF for none. 1 <= nb <=
// 254, m, n >= 1, ceil(n / 256) * ceil(m / 32) < 2^31 (the grid).
extern "C" int rfx_map_capture(const void* origin, const void* dir, const void* t_env,
                               const void* alive, int nb, int n, const void* centers, int m,
                               float radius, void* record, void* stream) {
  return launch_record<false>(origin, dir, t_env, alive, nb, n, centers, m, radius, nullptr,
                              record, stream);
}

// rfx_map_capture for the icosphere receiver: tris (m, 80, 9) f32, receiver
// r's faces (v0, e1, e2) of unit * radius + centers[r]
// (rfx_torch.tracer.icosphere_tris); the cull's sphere is (centers[r],
// radius). The same record.
extern "C" int rfx_map_capture_ico(const void* origin, const void* dir, const void* t_env,
                                   const void* alive, int nb, int n, const void* centers, int m,
                                   float radius, const void* tris, void* record, void* stream) {
  return launch_record<true>(origin, dir, t_env, alive, nb, n, centers, m, radius, tris, record,
                             stream);
}

// origin, dir: (nb, n, 3) f32; amp, dist: (nb, n) f32; record: (m, n) uint8
// from rfx_map_capture on the same segments and centers; centers: (m, 3)
// f32; g: (m, nbins) f32, the IRs' cotangent; soft: 0 or 1; qd_floor =
// f32(1e-6 * max(radius, 1e-6)). g_origin, g_dir: (nb, n, 3) f32, g_amp,
// g_dist: (nb, n) f32, every element written. With rows =
// rfx_map_capture_backward_blocks(n): gc_partials is null, or (rows, m, 3)
// f32 scratch, and then g_centers (m, 3) f32 gets the centers' gradient;
// sums_partials is null, or (rows, 2) f64 scratch, and then sums (2,) f32
// gets the sums over every capture of g_a amp and of gg. m, n, nb, nbins >= 1.
extern "C" int rfx_map_capture_backward(const void* origin, const void* dir, const void* amp,
                                        const void* dist, const void* record, int nb, int n,
                                        const void* centers, int m, float radius, float scale,
                                        float c, float rate, int nbins, int soft, float qd_floor,
                                        const void* g, void* g_origin, void* g_dir, void* g_amp,
                                        void* g_dist, void* gc_partials, void* g_centers,
                                        void* sums_partials, void* sums, void* stream) {
  const BackArgs a{static_cast<const float*>(amp), static_cast<const float*>(dist),
                   static_cast<const float*>(g), radius * radius, scale, c, rate, qd_floor,
                   nbins, soft != 0, static_cast<double*>(sums_partials), nullptr, nullptr};
  return launch_backward<false>(origin, dir, record, nb, n, centers, m, a, g_origin, g_dir,
                                g_amp, g_dist, gc_partials, g_centers, sums,
                                static_cast<cudaStream_t>(stream));
}

// rfx_map_capture_backward for the icosphere receiver, given
// rfx_map_capture_ico's record: tris as there, unit (80, 9) f32 the unit
// icosphere's (v0, e1, e2); sums gets the sums of g_a amp and of d IR /
// d radius (no qd_floor: the closed-form t has no clamp).
extern "C" int rfx_map_capture_backward_ico(const void* origin, const void* dir, const void* amp,
                                            const void* dist, const void* record, int nb, int n,
                                            const void* centers, int m, float scale, float c,
                                            float rate, int nbins, int soft, const void* tris,
                                            const void* unit, const void* g, void* g_origin,
                                            void* g_dir, void* g_amp, void* g_dist,
                                            void* gc_partials, void* g_centers,
                                            void* sums_partials, void* sums, void* stream) {
  const BackArgs a{static_cast<const float*>(amp), static_cast<const float*>(dist),
                   static_cast<const float*>(g), 0.0f, scale, c, rate, 0.0f, nbins, soft != 0,
                   static_cast<double*>(sums_partials), static_cast<const float*>(tris),
                   static_cast<const float*>(unit)};
  return launch_backward<true>(origin, dir, record, nb, n, centers, m, a, g_origin, g_dir, g_amp,
                               g_dist, gc_partials, g_centers, sums,
                               static_cast<cudaStream_t>(stream));
}

// The rows of the backward's scratch for n rays: a row a block of the
// kernel, then a row a chunk of kFold blocks.
extern "C" int rfx_map_capture_backward_blocks(int n) {
  const int blocks = backward_blocks(n);
  return blocks + fold_chunks(blocks);
}

extern "C" const char* rfx_map_capture_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* rfx_map_capture_ico_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* rfx_map_capture_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* rfx_map_capture_backward_ico_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
