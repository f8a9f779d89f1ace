// The receiver sphere's capture rule, shared by every kernel that finds a
// receiver's first captures in the segments of an environment trace: the
// coverage histogram (K3), the phasor metric (K-F) and its backward (B9) in
// coverage_hist.cu, and the map engine's capture pass and its backward (K-S)
// in map_capture.cu. One copy of the device code, so that they cannot
// disagree on a capture.
//
// The analytic sphere hit is the algebra of
// rfx_torch/ops/intersect.py:sphere_t: oc = o - c, b = oc.d and c = oc.oc -
// r^2 summed x + y + z, disc = b^2 - c, a hit iff disc > 0, the first root
// above 1e-4. A live segment is captured where the root is a hit (t_rx <
// 1e29) before the environment's (t_env > t_rx).
//
// Built with -fmad=false (rfx_torch/ops/_build.py): every product and sum
// rounds as PyTorch's elementwise operations do in the plain versions.

#pragma once

#include <cuda_runtime.h>

namespace rfx_capture {

constexpr float kTMin = 1e-4f;           // rfx_torch.ops.intersect.T_MIN_EPS
constexpr float kMiss = 1e30f;           // rfx_torch.ops.intersect.MISS
constexpr float kMissThreshold = 1e29f;  // rfx_torch.ops.intersect.MISS_THRESHOLD

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

// The discriminant of sphere_t, in its expressions and order, above zero.
// Only a segment that passes it can be captured.
__device__ __forceinline__ bool disc_positive(const Segment& s, float4 ctr, float r2) {
  const float ocx = s.ox - ctr.x, ocy = s.oy - ctr.y, ocz = s.oz - ctr.z;
  const float bq = ocx * s.dx + ocy * s.dy + ocz * s.dz;
  const float cq = ocx * ocx + ocy * ocy + ocz * ocz - r2;
  const float disc = bq * bq - cq;
  return disc > 0.0f;
}

// The capture rule for a segment (its liveness is the caller's to check): a
// capture iff the sphere's root is a hit (t_rx < 1e29) before the
// environment's (t_env > t_rx); `t_rx` gets the root.
__device__ __forceinline__ bool sphere_capture(const Segment& s, float4 ctr, float r2,
                                               float& t_rx) {
  t_rx = sphere_t(s.ox, s.oy, s.oz, s.dx, s.dy, s.dz, ctr.x, ctr.y, ctr.z, r2);
  return t_rx < kMissThreshold && s.te > t_rx;
}

// The capture rule with the capture's delay bin: `bin` gets
// int((dist + t_rx) / c * rate), -1 to drop it (outside [0, nbins)).
__device__ __forceinline__ bool sphere_win(const Segment& s, float4 ctr, float r2, float c,
                                           float rate, int nbins, int& bin) {
  float t_rx;
  if (!sphere_capture(s, ctr, r2, t_rx)) return false;
  const int b = delay_bin((s.dist + t_rx) / c * rate);
  bin = b < nbins ? b : -1;
  return true;
}

}  // namespace rfx_capture
