// Micro-benchmark of a warp's node test: what one step costs when 8 per-lane
// predicates must become 8 warp-uniform flags.
//
// Replaces scripts/micro_reduce.py (`kernel`, built by `mk`), the TPU
// micro-kernel that repeats a node-test body 50,000 times on an (8, 128) f32
// tile and reduces 8 masks `(x + carry + k) > 0.5` to 8 any-flags three ways.
// On the card the unit that votes is the warp, so the tile is laid over ONE
// warp: one block of 32 threads, lane l owning the 32 values x[32 l .. 32 l +
// 31]. `fl(fl(x + carry) + k)` is monotone in x, so a lane's "any of my 32
// values passes" is exactly "my largest value passes": each lane keeps the
// maximum of its values in a register, and a step is 8 predicates per lane
// and the vote, which is the body of the fused trace's slab test seen from a
// warp. (1,024 threads with one answer per warp would need a second,
// cross-warp stage through shared memory that the walk this models does not
// have; it would measure that stage.) One warp alone also makes the time per
// step the latency of the dependent chain carry -> predicates -> vote ->
// carry, which is what a divergent walk pays; nothing hides it.
//
// Styles, all with the same body and `carry += s * 1e-9` in f32:
//   0 votes      8 x __any_sync (the TPU's `reduces`: 8 scalar any-reduces);
//   1 ballotfold the 8 predicates packed into 8 bits per lane, one
//                __reduce_or_sync (the TPU's `rollfold`: packed OR fold);
//   2 sumpack    two predicates per __reduce_add_sync in 16-bit count fields
//                (the TPU's `sumpack`);
//   3 novec      the baseline without a vote: each lane's own predicates
//                times `zero` (the TPU's `m[0, 0] * 0.0`). `zero` is a launch
//                argument (0.0f) so that the compiler cannot fold the body
//                away; s is 0 and the carry stays 0, as in the reference.
// Styles 0-2 give the same s (the count of flags that are set), so the same
// carry.
//
// What bounds it: nothing the roofline knows; 4 KB in, 4 bytes out, a few
// dozen operations per lane and step. It is a latency measurement. Built
// with -fmad=false, so `carry + s * 1e-9f` rounds the product and the sum as
// PyTorch's elementwise operations do in the plain version
// (rfx_torch/ops/micro_vote.py:micro_vote_plain).

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kTile = 8 * 128;
constexpr int kPerLane = kTile / kWarp;
constexpr int kFlags = 8;
constexpr unsigned kFullWarp = 0xffffffffu;

enum Style { kVotes = 0, kBallotFold = 1, kSumPack = 2, kNoVec = 3 };

template <int kStyle>
__global__ void __launch_bounds__(kWarp) micro_vote_kernel(
    const float* __restrict__ x, int steps, float zero, float* __restrict__ out) {
  const int lane = threadIdx.x;
  float top = x[kPerLane * lane];
  for (int j = 1; j < kPerLane; ++j) top = fmaxf(top, x[kPerLane * lane + j]);

  float carry = 0.0f;
  for (int i = 0; i < steps; ++i) {
    bool pred[kFlags];
    const float xc = top + carry;
#pragma unroll
    for (int k = 0; k < kFlags; ++k) pred[k] = (xc + static_cast<float>(k)) > 0.5f;

    float s = 0.0f;
    if (kStyle == kVotes) {
#pragma unroll
      for (int k = 0; k < kFlags; ++k) s = s + (__any_sync(kFullWarp, pred[k]) ? 1.0f : 0.0f);
    } else if (kStyle == kBallotFold) {
      unsigned bits = 0u;
#pragma unroll
      for (int k = 0; k < kFlags; ++k) bits |= pred[k] ? (1u << k) : 0u;
      const unsigned any_bits = __reduce_or_sync(kFullWarp, bits);
#pragma unroll
      for (int k = 0; k < kFlags; ++k) s = s + static_cast<float>((any_bits >> k) & 1u);
    } else if (kStyle == kSumPack) {
#pragma unroll
      for (int k = 0; k < kFlags; k += 2) {
        const unsigned f = (pred[k] ? 1u : 0u) + (pred[k + 1] ? (1u << 16) : 0u);
        const unsigned tot = __reduce_add_sync(kFullWarp, f);
        s = s + ((tot & 0xFFFFu) > 0u ? 1.0f : 0.0f);
        s = s + ((tot >> 16) > 0u ? 1.0f : 0.0f);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kFlags; ++k) s = s + (pred[k] ? 1.0f : 0.0f) * zero;
    }
    carry = carry + s * 1e-9f;
  }
  if (lane == 0) out[0] = carry;
}

}  // namespace

// x is the (8, 128) f32 tile, out one f32; style 0..3 as above; zero is 0.0f.
// Returns cudaErrorInvalidValue for another style.
extern "C" int rfx_micro_vote(const void* x, int steps, int style, float zero, void* out,
                              void* stream) {
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (style) {
    case kVotes: micro_vote_kernel<kVotes><<<1, kWarp, 0, st>>>(xp, steps, zero, op); break;
    case kBallotFold: micro_vote_kernel<kBallotFold><<<1, kWarp, 0, st>>>(xp, steps, zero, op); break;
    case kSumPack: micro_vote_kernel<kSumPack><<<1, kWarp, 0, st>>>(xp, steps, zero, op); break;
    case kNoVec: micro_vote_kernel<kNoVec><<<1, kWarp, 0, st>>>(xp, steps, zero, op); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rfx_micro_vote_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
