// Direction-cell order of a batch of rays: a counting sort of the ray
// indices by the cell of each direction on an octahedral lattice, which the
// fused trace (fused_trace.cu) walks in place of the caller's order.
//
// Replaces no TPU kernel. The TPU kernel's rays came Morton-ordered from the
// sampler; the caller's rays here are often i.i.d. (the facade's default
// sampler, the benchmark's direction sets), and with i.i.d. rays the 32
// lanes of a warp walk the BVH in 32 unrelated directions, so the fused
// trace's walk diverges at the root and each lane waits on its own chain of
// L2 round trips. Ordered by direction cell, a warp's rays leave the
// transmitter inside one small cone and walk together.
//
// The key. The octahedral map folds the sphere onto [-1, 1]^2 with no
// transcendental function: u = x / (|x| + |y| + |z|), v = y / (...), and for
// z < 0 the lower hemisphere folded out, (u, v) = ((1 - |v|) sign u,
// (1 - |u|) sign v), sign 0 = +1. Each of u, v falls into one of 2^bits
// columns, trunc((u + 1) 2^(bits-1)) clamped to the lattice (0 for NaN), and
// the key interleaves the two column numbers in Morton order, so that cells
// close in the key are close on the sphere. Built with -fmad=false and IEEE
// division (rfx_torch/ops/_build.py), every key is the one the plain version
// (rfx_torch/ops/ray_order.py:cell_keys_plain) computes, bit for bit.
//
// The sort, one memset and two kernels:
//   1. the histogram and the done counter are zeroed (cudaMemsetAsync);
//   2. ray_cell_count_kernel: a thread a ray (grid-stride, one wave of
//      blocks) writes the ray's key, adds one to its cell's count in global
//      memory and keeps the count it found, the ray's place in its cell; the
//      last block to finish (a done counter after a fence) scans the counts
//      into each cell's first slot, each warp a run of cells read 16 bytes a
//      lane;
//   3. ray_cell_scatter_kernel: a thread a ray puts its index at its cell's
//      first slot plus its place in the cell (`order`), and that position at
//      its own index (`rank`): no atomic.
// The order of the rays inside one cell depends on the atomics' order and may
// change from run to run; the fused trace puts each ray's outputs back at the
// ray's own index, so no output can see it.
//
// What bounds it: the directions read once (12 bytes a ray), the keys and
// places written and read (16), the order and the rank written (8): 36 bytes
// a ray, 0.056 ms for 5,242,880 rays at 3.35 TB/s. It takes 0.30 ms there on
// an H100 (count 0.14, scatter 0.15; PERF.md): one L2 atomic a ray in the
// count and one 4-byte store a ray to a place anywhere in the order, in the
// scatter, are what it waits on. The lattice (`bits`) is the wrapper's
// choice, from the ray count: the scan runs in one block, so a finer lattice
// costs the scan time. Measured and not kept: a two-level sort (a 16 x 16
// lattice first, with per-block counts in shared memory and a global atomic
// per block and bucket, then each bucket sorted by one block) took 0.60-0.77
// ms against this one's 0.27-0.33.

#include <cuda_runtime.h>

namespace {

constexpr int kCountThreads = 512;
constexpr int kScatterThreads = 256;
constexpr int kWarps = kCountThreads / 32;
constexpr unsigned kFullWarp = 0xffffffffu;

// The low 16 bits of v, spread to the even bit positions.
__device__ __forceinline__ unsigned spread_bits(unsigned v) {
  v = (v | (v << 8)) & 0x00FF00FFu;
  v = (v | (v << 4)) & 0x0F0F0F0Fu;
  v = (v | (v << 2)) & 0x33333333u;
  v = (v | (v << 1)) & 0x55555555u;
  return v;
}

// The column of u in [-1, 1] on a lattice of `res` columns; NaN goes to 0.
__device__ __forceinline__ unsigned column(float u, float half, int res) {
  const float t = (u + 1.0f) * half;
  if (!(t >= 0.0f)) return 0u;
  return t < static_cast<float>(res) ? static_cast<unsigned>(t) : static_cast<unsigned>(res - 1);
}

__device__ __forceinline__ unsigned cell_key(float x, float y, float z, int bits) {
  const float s = fabsf(x) + fabsf(y) + fabsf(z);
  float u = x / s;
  float v = y / s;
  if (z < 0.0f) {
    const float fu = 1.0f - fabsf(v);
    const float fv = 1.0f - fabsf(u);
    u = u >= 0.0f ? fu : -fu;
    v = v >= 0.0f ? fv : -fv;
  }
  const int res = 1 << bits;
  const float half = static_cast<float>(res >> 1);
  return spread_bits(column(u, half, res)) | (spread_bits(column(v, half, res)) << 1);
}

// Sum over the warp, in every lane.
__device__ __forceinline__ int warp_sum(int v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFullWarp, v, d);
  return v;
}

// Inclusive scan over the warp.
__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFullWarp, v, d);
    if (lane >= d) v += up;
  }
  return v;
}

// Each cell's first slot, start[c] = counts[0] + ... + counts[c - 1], by one
// block: warp w owns the w-th of kWarps equal runs of cells and reads it in
// int4 steps, 128 cells a warp step, coalesced. First each warp sums its run,
// then the runs' sums are scanned, then each warp walks its run again with a
// carry. `cells` is a multiple of 128 kWarps.
__device__ __forceinline__ void scan_cells(const int* __restrict__ counts, int cells,
                                           int* __restrict__ start) {
  __shared__ int run_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_warp = cells / (4 * kWarps);  // int4 steps of a warp's run
  const int4* c4 = reinterpret_cast<const int4*>(counts) + warp * per_warp;
  int4* s4 = reinterpret_cast<int4*>(start) + warp * per_warp;
  int sum = 0;
  for (int j = lane; j < per_warp; j += 32) {
    const int4 q = __ldcg(c4 + j);
    sum += q.x + q.y + q.z + q.w;
  }
  sum = warp_sum(sum);
  if (lane == 0) run_sums[warp] = sum;
  __syncthreads();
  int carry = 0;
  for (int w = 0; w < warp; ++w) carry += run_sums[w];
  for (int j = lane; j < per_warp; j += 32) {  // per_warp is a multiple of 32
    const int4 q = __ldcg(c4 + j);
    const int mine = q.x + q.y + q.z + q.w;
    const int incl = warp_inclusive_scan(mine);
    const int e = carry + incl - mine;
    s4[j] = make_int4(e, e + q.x, e + q.x + q.y, e + q.x + q.y + q.z);
    carry += __shfl_sync(kFullWarp, incl, 31);
  }
}

__global__ void __launch_bounds__(kCountThreads) ray_cell_count_kernel(
    const float* __restrict__ dirs, int n, int bits, unsigned* __restrict__ keys,
    int* __restrict__ within, int* __restrict__ counts, unsigned* __restrict__ done,
    int* __restrict__ start) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const float* d = dirs + 3 * static_cast<size_t>(i);
    const unsigned k = cell_key(d[0], d[1], d[2], bits);
    keys[i] = k;
    within[i] = atomicAdd(counts + k, 1);  // the ray's place in its cell
  }

  // The last block to finish sees every block's counts, and scans them.
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) scan_cells(counts, 1 << (2 * bits), start);
}

__global__ void __launch_bounds__(kScatterThreads) ray_cell_scatter_kernel(
    const unsigned* __restrict__ keys, const int* __restrict__ within, int n,
    const int* __restrict__ start, int* __restrict__ order, int* __restrict__ rank) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int pos = start[keys[i]] + within[i];
  order[pos] = i;
  rank[i] = pos;
}

}  // namespace

// dirs (n, 3) f32; bits in [6, 10]; work int32, 2 * 4^bits + 4 + 2n of them,
// 16-byte aligned: start (each cell's first slot), counts (the rays of each
// cell), the done counter and 3 unused, keys (each ray's cell), within (each
// ray's place in its cell); order (n,) int32, the rays cell by cell; rank
// (n,) int32, each ray's place in the order (order[rank[i]] == i).
extern "C" int rfx_ray_order(const void* dirs, int n, int bits, void* work, void* order,
                             void* rank, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cells = 1 << (2 * bits);
  int* const start = static_cast<int*>(work);
  int* const counts = start + cells;
  unsigned* const done = reinterpret_cast<unsigned*>(counts + cells);
  unsigned* const keys = done + 4;
  int* const within = reinterpret_cast<int*>(keys + n);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * (static_cast<size_t>(cells) + 1), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int wave = (sms > 0 ? sms : 132) * (2048 / kCountThreads);
  const int blocks = min((n + kCountThreads - 1) / kCountThreads, wave);
  ray_cell_count_kernel<<<blocks, kCountThreads, 0, s>>>(static_cast<const float*>(dirs), n, bits,
                                                         keys, within, counts, done, start);
  ray_cell_scatter_kernel<<<(n + kScatterThreads - 1) / kScatterThreads, kScatterThreads, 0, s>>>(
      keys, within, n, start, static_cast<int*>(order), static_cast<int*>(rank));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rfx_ray_order_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
