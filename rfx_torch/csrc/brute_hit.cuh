// The Moller-Trumbore closest hit of rays against a list of triangles, and
// the receiver icosphere's bounding-sphere cull: the device code that the
// brute closest hit (brute_hit.cu), the map engine's icosphere capture pass
// and its backward (map_capture.cu) and the histogram's icosphere record
// entry (histogram.cu) share, so that they cannot disagree on a hit.
//
// mt_t is one test in the expressions and order of
// rfx_torch/ops/intersect.py:_mt_chunk (rfx/ops/intersect.py:75-113):
// pvec = d x e2, det = e1.pvec, inv_det = 1 / det where |det| > 1e-12 (else
// 0), tvec = o - v0, u = tvec.pvec * inv_det, qvec = tvec x e1, v =
// d.qvec * inv_det, t = e2.qvec * inv_det, every dot product summed x + y +
// z; a hit where |det| > 1e-12, u >= 0, v >= 0, u + v <= 1 and t_min < t <
// t_max. closest_hit keeps the first smallest t in ascending face order
// (strict <), so ties go to the lowest face index, as torch.argmin does.
// Built with -fmad=false and IEEE division (rfx_torch/ops/_build.py): the
// same bits as PyTorch's elementwise operations in the plain version.
//
// The cull (cull_pass) decides only whether the tests run: a ray whose line
// passes farther than reach = r (1 + kCullDelta) + kCullGamma |c - o|_1
// from the center c of an icosphere of radius r skips all of them. Every
// vertex is unit * r + c with |unit| = 1 within rounding and every hit lies
// in a face, so in exact arithmetic no line that hits passes beyond r. The
// distance is |(c - o) x d|^2 against reach^2 |d|^2, not a discriminant,
// which cancels at |c - o| >> r. Rounding moves what the tests accept by
// some f32 ulps of |o - v0| (a grazing face scales that up): the plain
// test's hits measured over grazing rays through the icosphere's vertices
// and edge midpoints at 2 to 10^4 radii passed at most 4e-6 r beyond r at
// 2 r and at most 8e-8 |c - o|_1 beyond it far away, against the margins
// kCullDelta r and kCullGamma |c - o|_1 (tests/test_torch_icosphere.py
// holds the predicate, written in torch, to that). An overflow to inf
// passes (inf <= inf); a NaN is culled, and the tests find no hit for it
// either.
//
// closed_form_t_vjp is the VJP of rfx_torch/ops/intersect.py:closed_form_t
// (the selected face's t, (qvec.e2) / det) in o, d, v0, e1 and e2, written
// out in the order of intersect.py:closed_form_t_vjp, the plain version.

#pragma once

#include <cuda_runtime.h>

namespace rfx_brute {

constexpr float kTMin = 1e-4f;           // rfx_torch.ops.intersect.T_MIN_EPS
constexpr float kTMax = 1e6f;            // rfx_torch.ops.intersect.T_MAX
constexpr float kMiss = 1e30f;           // rfx_torch.ops.intersect.MISS
constexpr float kMissThreshold = 1e29f;  // rfx_torch.ops.intersect.MISS_THRESHOLD
constexpr float kDetEps = 1e-12f;
constexpr int kTriFloats = 9;            // a triangle: v0, e1, e2
constexpr int kIcoFaces = 80;            // the reference receiver's tessellation
constexpr float kCullDelta = 1e-3f;
constexpr float kCullGamma = 1e-3f;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// t of the ray against the triangle tri[0..8] = (v0, e1, e2), kMiss where
// the test finds no hit.
__device__ __forceinline__ float mt_t(const Ray& r, const float* tri, float t_min, float t_max) {
  const float v0x = tri[0], v0y = tri[1], v0z = tri[2];
  const float e1x = tri[3], e1y = tri[4], e1z = tri[5];
  const float e2x = tri[6], e2y = tri[7], e2z = tri[8];
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool valid = fabsf(det) > kDetEps;
  const float inv = valid ? 1.0f / det : 0.0f;
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  const float u = (tx * px + ty * py + tz * pz) * inv;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  const bool ok = valid && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > t_min && t < t_max;
  return ok ? t : kMiss;
}

// Closest hit over `count` triangles stored back to back from `tris`
// (any address space); `face` gets the index of the first smallest t, -1
// on a miss (t = kMiss).
__device__ __forceinline__ float closest_hit(const Ray& r, const float* tris, int count,
                                             float t_min, float t_max, int& face) {
  float best = kMiss;
  face = -1;
  for (int f = 0; f < count; ++f) {
    const float t = mt_t(r, tris + kTriFloats * f, t_min, t_max);
    if (t < best) {
      best = t;
      face = f;
    }
  }
  if (!(best < kMissThreshold)) face = -1;
  return best;
}

// False where the ray's line passes farther than the reach of the cull from
// the icosphere of radius `radius` about (cx, cy, cz): no face can be hit.
__device__ __forceinline__ bool cull_pass(const Ray& r, float cx, float cy, float cz,
                                          float radius) {
  const float wx = cx - r.ox, wy = cy - r.oy, wz = cz - r.oz;
  const float crx = wy * r.dz - wz * r.dy;
  const float cry = wz * r.dx - wx * r.dz;
  const float crz = wx * r.dy - wy * r.dx;
  const float line2 = crx * crx + cry * cry + crz * crz;
  const float reach =
      fabsf(radius) * (1.0f + kCullDelta) + kCullGamma * (fabsf(wx) + fabsf(wy) + fabsf(wz));
  const float dd = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  return line2 <= reach * reach * dd;
}

// The icosphere receiver's t: the cull, then the closest hit over its
// kIcoFaces faces `tris` (kMiss where culled or missed).
__device__ __forceinline__ float ico_t(const Ray& r, const float* tris, float cx, float cy,
                                       float cz, float radius, int& face) {
  face = -1;
  if (!cull_pass(r, cx, cy, cz, radius)) return kMiss;
  return closest_hit(r, tris, kIcoFaces, kTMin, kTMax, face);
}

// The VJP of the closed-form t of the selected face tri = (v0, e1, e2) for
// the cotangent g: with p = d x e2, det = e1.p (1 where |det| <= 1e-12), s =
// o - v0, q = s x e1 and num = e2.q, t = num / det, so g_num = g / det, g_det
// = -g_num (num / det) (0 where |det| <= 1e-12), g_q = g_num e2, g_p = g_det
// e1; g_o = e1 x g_q = -g_v0, g_d = e2 x g_p, g_e1 = g_q x s + g_det p, g_e2
// = g_num q + g_p x d.
struct TGrad {
  float go[3], gd[3], ge1[3], ge2[3];  // g_v0 = -go
};

__device__ __forceinline__ void closed_form_t_vjp(const Ray& r, const float* tri, float g,
                                                  TGrad& out) {
  const float v0x = tri[0], v0y = tri[1], v0z = tri[2];
  const float e1x = tri[3], e1y = tri[4], e1z = tri[5];
  const float e2x = tri[6], e2y = tri[7], e2z = tri[8];
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool valid = fabsf(det) > kDetEps;
  const float ds = valid ? det : 1.0f;
  const float sx = r.ox - v0x, sy = r.oy - v0y, sz = r.oz - v0z;
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float num = e2x * qx + e2y * qy + e2z * qz;
  const float gnum = g / ds;
  const float gdet = valid ? -(gnum * (num / ds)) : 0.0f;
  const float gqx = gnum * e2x, gqy = gnum * e2y, gqz = gnum * e2z;
  out.go[0] = e1y * gqz - e1z * gqy;
  out.go[1] = e1z * gqx - e1x * gqz;
  out.go[2] = e1x * gqy - e1y * gqx;
  const float gpx = gdet * e1x, gpy = gdet * e1y, gpz = gdet * e1z;
  out.ge1[0] = (gqy * sz - gqz * sy) + gdet * px;
  out.ge1[1] = (gqz * sx - gqx * sz) + gdet * py;
  out.ge1[2] = (gqx * sy - gqy * sx) + gdet * pz;
  out.gd[0] = e2y * gpz - e2z * gpy;
  out.gd[1] = e2z * gpx - e2x * gpz;
  out.gd[2] = e2x * gpy - e2y * gpx;
  out.ge2[0] = gnum * qx + (gpy * r.dz - gpz * r.dy);
  out.ge2[1] = gnum * qy + (gpz * r.dx - gpx * r.dz);
  out.ge2[2] = gnum * qz + (gpx * r.dy - gpy * r.dx);
}

}  // namespace rfx_brute
