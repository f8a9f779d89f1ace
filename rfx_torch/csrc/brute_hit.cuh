// The Moller-Trumbore closest hit of rays against a list of triangles, and
// the receiver icosphere's bounding-sphere cull: the device code that the
// brute closest hit (brute_hit.cu) and the map engine's icosphere capture
// pass and its backward (map_capture.cu) share, so that they cannot disagree
// on a hit. The icosphere's kernels run each receiver's 80 tests across a
// warp: the capture pass wants the smallest t alone (warp_ico_t), the
// backward also its face (warp_ico_hit, the first smallest t in ascending
// face order, for as many rays at once as lanes of the warp ask). The brute
// closest hit runs a thread's tests in a row, each in two halves (mt_head,
// mt_tail), so that a warp can skip the second where no lane can still hit
// the face.
//
// mt_t is one test in the expressions and order of
// rfx_torch/ops/intersect.py:_mt_chunk (rfx/ops/intersect.py:75-113):
// pvec = d x e2, det = e1.pvec, inv_det = 1 / det where |det| > 1e-12 (else
// 0), tvec = o - v0, u = tvec.pvec * inv_det, qvec = tvec x e1, v =
// d.qvec * inv_det, t = e2.qvec * inv_det, every dot product summed x + y +
// z; a hit where |det| > 1e-12, u >= 0, v >= 0, u + v <= 1 and t_min < t <
// t_max. A closest hit keeps the first smallest t in ascending face order,
// so ties go to the lowest face index, as torch.argmin does. Built with
// -fmad=false and IEEE division (rfx_torch/ops/_build.py): the same bits as
// PyTorch's elementwise operations in the plain version.
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

// The first half of a test: pvec, det, inv_det, tvec and u.
struct MtHead {
  float inv, tx, ty, tz, u;
  bool valid;
};

__device__ __forceinline__ MtHead mt_head(const Ray& r, float v0x, float v0y, float v0z, float e1x,
                                          float e1y, float e1z, float e2x, float e2y, float e2z) {
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  MtHead h;
  h.valid = fabsf(det) > kDetEps;
  h.inv = h.valid ? 1.0f / det : 0.0f;
  h.tx = r.ox - v0x;
  h.ty = r.oy - v0y;
  h.tz = r.oz - v0z;
  h.u = (h.tx * px + h.ty * py + h.tz * pz) * h.inv;
  return h;
}

// False where the test cannot accept, whatever v and t: |det| <= 1e-12, u
// < 0, u > 1 (u + v rounds to at least u where v >= 0) or u NaN.
__device__ __forceinline__ bool mt_may_hit(const MtHead& h) {
  return h.valid && h.u >= 0.0f && h.u <= 1.0f;
}

// The second half: qvec, v, t and the hit rule; t, or kMiss where the test
// finds no hit.
__device__ __forceinline__ float mt_tail(const Ray& r, const MtHead& h, float e1x, float e1y,
                                         float e1z, float e2x, float e2y, float e2z, float t_min,
                                         float t_max) {
  const float qx = h.ty * e1z - h.tz * e1y;
  const float qy = h.tz * e1x - h.tx * e1z;
  const float qz = h.tx * e1y - h.ty * e1x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * h.inv;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * h.inv;
  const bool ok = h.valid && h.u >= 0.0f && v >= 0.0f && h.u + v <= 1.0f && t > t_min && t < t_max;
  return ok ? t : kMiss;
}

// t of the ray against the triangle tri[0..8] = (v0, e1, e2), kMiss where
// the test finds no hit.
__device__ __forceinline__ float mt_t(const Ray& r, const float* tri, float t_min, float t_max) {
  const MtHead h =
      mt_head(r, tri[0], tri[1], tri[2], tri[3], tri[4], tri[5], tri[6], tri[7], tri[8]);
  return mt_tail(r, h, tri[3], tri[4], tri[5], tri[6], tri[7], tri[8], t_min, t_max);
}

// The reach's term in the radius, r (1 + kCullDelta).
__device__ __forceinline__ float cull_reach0(float radius) {
  return fabsf(radius) * (1.0f + kCullDelta);
}

// cull_pass given reach0 = cull_reach0(radius) and dd = |d|^2 (r.dx * r.dx +
// r.dy * r.dy + r.dz * r.dz), which a caller that culls many rays against
// many receivers computes once.
__device__ __forceinline__ bool cull_within(const Ray& r, float cx, float cy, float cz,
                                            float reach0, float dd) {
  const float wx = cx - r.ox, wy = cy - r.oy, wz = cz - r.oz;
  const float crx = wy * r.dz - wz * r.dy;
  const float cry = wz * r.dx - wx * r.dz;
  const float crz = wx * r.dy - wy * r.dx;
  const float line2 = crx * crx + cry * cry + crz * crz;
  const float reach = reach0 + kCullGamma * (fabsf(wx) + fabsf(wy) + fabsf(wz));
  return line2 <= reach * reach * dd;
}

// False where the ray's line passes farther than the reach of the cull from
// the icosphere of radius `radius` about (cx, cy, cz): no face can be hit.
__device__ __forceinline__ bool cull_pass(const Ray& r, float cx, float cy, float cz,
                                          float radius) {
  return cull_within(r, cx, cy, cz, cull_reach0(radius),
                     r.dx * r.dx + r.dy * r.dy + r.dz * r.dz);
}

// Face f of the icosphere about (cx, cy, cz) whose faces scaled by the
// radius are unit_r ((80, 9): unit * radius): (unit_r[f].v0 + c, e1, e2),
// v0 rounded as rfx_torch.ops.intersect.icosphere_tris rounds it (the product,
// then the sum).
__device__ __forceinline__ void ico_face(const float* unit_r, int f, float cx, float cy, float cz,
                                         float (&tri)[kTriFloats]) {
  const float* u = unit_r + kTriFloats * f;
  tri[0] = u[0] + cx;
  tri[1] = u[1] + cy;
  tri[2] = u[2] + cz;
#pragma unroll
  for (int k = 3; k < kTriFloats; ++k) tri[k] = u[k];
}

// Face f of the icosphere of radius `radius` about (cx, cy, cz) from the unit
// faces `unit` ((80, 9)), scaled here: (unit[f].v0 * radius + c,
// unit[f].e1 * radius, unit[f].e2 * radius), rounded as
// rfx_torch.ops.intersect.icosphere_tris rounds it (the product, then the
// sum); the table is read through the read-only path.
__device__ __forceinline__ void ico_face(const float* unit, int f, float cx, float cy, float cz,
                                         float radius, float (&tri)[kTriFloats]) {
  const float* u = unit + kTriFloats * f;
  tri[0] = __ldg(u) * radius + cx;
  tri[1] = __ldg(u + 1) * radius + cy;
  tri[2] = __ldg(u + 2) * radius + cz;
#pragma unroll
  for (int k = 3; k < kTriFloats; ++k) tri[k] = __ldg(u + k) * radius;
}

// The icosphere receiver's closest hit t, shared by the 32 lanes of a warp,
// which all call it with the same arguments: over the faces (ico_face) of
// the icosphere about (cx, cy, cz). Lane l tests faces l, l + 32 and l + 64,
// then a butterfly of shuffles keeps the smallest t; every lane returns it,
// the closest hit's t (kMiss where no face is hit; faces that tie give that
// t alike). No cull.
__device__ __forceinline__ float warp_ico_t(const Ray& r, const float* unit_r, float cx, float cy,
                                            float cz) {
  const int lane = threadIdx.x & 31;
  float best = kMiss;
#pragma unroll
  for (int s = 0; s < (kIcoFaces + 31) / 32; ++s) {
    const int f = lane + 32 * s;
    if (f < kIcoFaces) {
      float tri[kTriFloats];
      ico_face(unit_r, f, cx, cy, cz, tri);
      best = fminf(best, mt_t(r, tri, kTMin, kTMax));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) best = fminf(best, __shfl_xor_sync(0xffffffffu, best, off));
  return best;
}

// The icosphere receiver's closest hit t and face for each lane of a warp
// that asks (`cap`), on its own ray `own`; all 32 lanes call it with the
// same icosphere (ico_face's faces about (cx, cy, cz)). With k lanes
// asking, the warp splits into groups of g = 32 / 2^ceil(log2 k) lanes, a
// group an asking lane in lane order (k = 1: the whole warp, three faces a
// lane, as warp_ico_t; k > 16: each asking lane alone). Lane s of a group
// tests faces s, s + g, ... in ascending order and keeps the first
// smallest t (strict <), then a butterfly of shuffles within the group
// keeps the lexicographic minimum of (t, face): the lowest face that gives
// the smallest t, the closest hit's face. Faces that tie give the same t
// but another VJP, so the tie rule is part of the result, and it holds for
// every g. An asking lane gets its t (kMiss where no face is hit) and
// `face` (-1 there). No cull.
__device__ __forceinline__ float warp_ico_hit(const Ray& own, bool cap, const float* unit_r,
                                              float cx, float cy, float cz, int& face) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const unsigned asking = __ballot_sync(kAll, cap);
  const int k = __popc(asking);
  const int shift = k > 1 ? 32 - __clz(k - 1) : 0;  // ceil(log2 k)
  const int g = 32 >> shift;                        // lanes a group
  const int group = lane >> (5 - shift), s = lane & (g - 1);
  unsigned rest = asking;  // the group's asking lane: the group-th of them
  for (int j = 0; j < group && rest != 0u; ++j) rest &= rest - 1u;
  const int src = rest != 0u ? __ffs(rest) - 1 : lane;
  const Ray r{__shfl_sync(kAll, own.ox, src), __shfl_sync(kAll, own.oy, src),
              __shfl_sync(kAll, own.oz, src), __shfl_sync(kAll, own.dx, src),
              __shfl_sync(kAll, own.dy, src), __shfl_sync(kAll, own.dz, src)};
  float best = kMiss;
  int at = kIcoFaces;  // no face yet: above every face
  if (group < k) {
    for (int f = s; f < kIcoFaces; f += g) {
      float tri[kTriFloats];
      ico_face(unit_r, f, cx, cy, cz, tri);
      const float t = mt_t(r, tri, kTMin, kTMax);
      if (t < best) {
        best = t;
        at = f;
      }
    }
  }
  for (int off = g / 2; off > 0; off /= 2) {
    const float t = __shfl_xor_sync(kAll, best, off);
    const int f = __shfl_xor_sync(kAll, at, off);
    if (t < best || (t == best && f < at)) {
      best = t;
      at = f;
    }
  }
  const int from = cap ? g * __popc(asking & ((1u << lane) - 1u)) : 0;  // this lane's group
  const float t = __shfl_sync(kAll, best, from);
  const int f = __shfl_sync(kAll, at, from);
  face = t < kMissThreshold ? f : -1;
  return t;
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
