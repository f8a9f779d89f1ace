"""Ray-primitive intersection with the reference's custom gradients (port
of rfx/ops/intersect.py).

- `ray_mesh_closest_hit_brute`: Moller-Trumbore of every ray against every
  triangle. The closest-hit path of small meshes (the facade's `brute`
  backend) and of the icosphere receiver. On a CUDA tensor one launch of
  the brute closest-hit kernel (`rfx_brute_hit`, rfx_torch/csrc/brute_hit.cu,
  with the receiver's bounding-sphere cull where the caller gives one); on a
  CPU tensor its plain version, `_brute_forward`, chunked over rays so the
  (rays x triangles) intermediates stay bounded. The same t and face either
  way. Its backward is the reference's custom VJP: hit selection is
  straight-through, and the closed-form t of the selected face is
  differentiated at sanitized lanes. `closed_form_t_vjp` writes that VJP
  out, as the map engine's icosphere backward kernel computes it.
- `ray_sphere_hit`: closed-form sphere hit of the analytic receiver, with
  the implicit-function backward of the reference.
- `make_env_intersector`: the `env_hit(o, d, v0, e1, e2, normals) -> (t,
  face, nrm)` factory of the bounce-loop tracers, with the `brute` backend,
  the `kernel` backend (the per-query BVH kernel of rfx_torch.ops.bvh_trace,
  the counterpart of the reference's `pallas`) and the `bvh` backend (the
  plain stackless walk of rfx_torch.ops.bvh_traverse).

Constants and the finite miss sentinel are the reference's
(`rfx/ops/intersect.py:27-39`). Dot products are written out left to right,
so they round as the kernels' do.
"""

from __future__ import annotations

import torch

from rfx_torch.ops._build import CudaKernel, F, I, P

T_MIN_EPS = 1e-4
T_MAX = 1.0e6
MISS = 1e30
MISS_THRESHOLD = 1e29

# Upper bound on rays x triangles per brute-force chunk (each of the ~20
# intermediates is this many f32 values).
_BRUTE_PAIRS = 1 << 22

BRUTE_HIT_KERNEL = CudaKernel("brute_hit.cu", "rfx_brute_hit", [P, P, I, P, I, F, F, P, P, P, P])
# The receiver icosphere's bounding-sphere cull (csrc/brute_hit.cuh): its
# reach is r (1 + CULL_DELTA) + CULL_GAMMA |c - o|_1.
CULL_DELTA = 1e-3
CULL_GAMMA = 1e-3


def is_hit(t: torch.Tensor) -> torch.Tensor:
    """True where a query returned a real intersection (t below the miss
    sentinel)."""
    return t < MISS_THRESHOLD


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a.b over the last axis, summed x + y + z in that order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def _unit(n: torch.Tensor) -> torch.Tensor:
    return n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-30)


def hit_normal_from_edges(e1: torch.Tensor, e2: torch.Tensor, face: torch.Tensor) -> torch.Tensor:
    """Unit geometric normal of each ray's hit face, unit(cross(e1[f], e2[f]));
    a miss (face -1) reads face 0 and is masked by the caller."""
    f = face.clamp_min(0)
    return _unit(cross3(e1[f], e2[f]))


def mesh_soa(vertices: torch.Tensor, faces: torch.Tensor):
    """(v0, e1, e2, unit normals) of an indexed mesh, each (F, 3)."""
    faces = faces.long()
    v0 = vertices[faces[:, 0]]
    e1 = vertices[faces[:, 1]] - v0
    e2 = vertices[faces[:, 2]] - v0
    return v0, e1, e2, _unit(cross3(e1, e2))


def closed_form_t(o, d, v0, e1, e2):
    """Moller-Trumbore t for known (ray, triangle) pairs, all (N, 3)."""
    pvec = cross3(d, e2)
    det = dot3(e1, pvec)
    det_safe = torch.where(det.abs() > 1e-12, det, torch.ones_like(det))
    qvec = cross3(o - v0, e1)
    return dot3(e2, qvec) / det_safe


def _mt_chunk(o, d, v0, e1, e2, t_min, t_max):
    """(C, 3) rays against (T, 3) triangles -> (t_best (C,), face (C,) i32)."""
    pvec = cross3(d[:, None, :], e2[None, :, :])  # (C, T, 3)
    det = dot3(e1[None, :, :], pvec)
    valid_det = det.abs() > 1e-12
    inv_det = torch.where(valid_det, 1.0 / torch.where(valid_det, det, torch.ones_like(det)),
                          torch.zeros_like(det))
    tvec = o[:, None, :] - v0[None, :, :]
    u = dot3(tvec, pvec) * inv_det
    qvec = cross3(tvec, e1[None, :, :])
    v = dot3(d[:, None, :], qvec) * inv_det
    t = dot3(e2[None, :, :], qvec) * inv_det
    ok = valid_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) & (t < t_max)
    t = torch.where(ok, t, torch.full_like(t, MISS))
    face = torch.argmin(t, dim=1)
    t_best = torch.gather(t, 1, face[:, None])[:, 0]
    face = torch.where(is_hit(t_best), face, torch.full_like(face, -1)).to(torch.int32)
    return t_best, face


def _brute_forward(o, d, v0, e1, e2, t_min, t_max, ray_chunk):
    """Plain PyTorch version of `rfx_brute_hit`, on either device: `_mt_chunk`
    over chunks of `ray_chunk` rays (None: about 4M pairs a chunk)."""
    n, n_tris = o.shape[0], v0.shape[0]
    if ray_chunk is None:
        ray_chunk = max(1, _BRUTE_PAIRS // max(n_tris, 1))
    if n_tris == 0:
        return (torch.full((n,), MISS, dtype=o.dtype, device=o.device),
                torch.full((n,), -1, dtype=torch.int32, device=o.device))
    ts, fs = [], []
    for s in range(0, n, ray_chunk):
        t, f = _mt_chunk(o[s:s + ray_chunk], d[s:s + ray_chunk], v0, e1, e2, t_min, t_max)
        ts.append(t)
        fs.append(f)
    if not ts:
        return o.new_empty((0,)), torch.empty((0,), dtype=torch.int32, device=o.device)
    return torch.cat(ts), torch.cat(fs)


def cull_pass(o: torch.Tensor, d: torch.Tensor, cull: torch.Tensor) -> torch.Tensor:
    """(N,) bool: the brute closest-hit kernel's cull, in its f32 expressions
    and order (brute_hit.cuh:cull_pass), for rays (N, 3) and `cull` (4,) =
    (cx, cy, cz, r): False where the line passes farther than the reach from
    the center, so that no face of the icosphere can be hit."""
    w = cull[:3] - o
    wx, wy, wz = w[:, 0], w[:, 1], w[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    crx = wy * dz - wz * dy
    cry = wz * dx - wx * dz
    crz = wx * dy - wy * dx
    line2 = crx * crx + cry * cry + crz * crz
    reach = cull[3].abs() * (1.0 + CULL_DELTA) + CULL_GAMMA * (wx.abs() + wy.abs() + wz.abs())
    dd = dx * dx + dy * dy + dz * dz
    return line2 <= reach * reach * dd


def brute_hit(o, d, v0, e1, e2, t_min: float = T_MIN_EPS, t_max: float = T_MAX,
              ray_chunk: int | None = None, cull=None):
    """(t, face) of (N, 3) rays against the (T, 3) triangles v0, e1, e2,
    without autograd: on a CPU tensor `_brute_forward`, on a CUDA tensor one
    launch of `rfx_brute_hit` (the same bits; `cull`, the (4,) center and
    radius of an icosphere around the triangles, lets it skip rays whose line
    passes outside the sphere's reach; the plain version tests every ray)."""
    dev = o.device
    if dev.type == "cpu":
        return _brute_forward(o, d, v0, e1, e2, t_min, t_max, ray_chunk)
    if dev.type != "cuda":
        raise ValueError(f"no brute closest-hit kernel for device {dev}")
    n, n_tris = o.shape[0], v0.shape[0]
    if n >= 2**31:
        raise ValueError(f"at most 2^31 - 1 rays a launch, got {n}")
    for name, x in (("o", o), ("d", d), ("v0", v0), ("e1", e1), ("e2", e2)):
        if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != 3 or x.device != dev:
            raise ValueError(f"{name} must be (n, 3) float32 on {dev}, got {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}")
    if n_tris == 0 or n == 0:
        return (torch.full((n,), MISS, dtype=torch.float32, device=dev),
                torch.full((n,), -1, dtype=torch.int32, device=dev))
    tris = torch.cat([v0, e1, e2], dim=1).detach().contiguous()
    o, d = o.detach().contiguous(), d.detach().contiguous()
    if cull is not None:
        cull = cull.detach().to(device=dev, dtype=torch.float32).contiguous()
        if cull.shape != (4,):
            raise ValueError(f"cull must be (4,): center and radius, got {tuple(cull.shape)}")
    t = torch.empty(n, dtype=torch.float32, device=dev)  # the kernel writes every element
    face = torch.empty(n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        BRUTE_HIT_KERNEL.launch(o.data_ptr(), d.data_ptr(), n, tris.data_ptr(), n_tris,
                                float(t_min), float(t_max),
                                None if cull is None else cull.data_ptr(), t.data_ptr(),
                                face.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return t, face


def closed_form_t_vjp(o, d, v0, e1, e2, g):
    """(g_o, g_d, g_v0, g_e1, g_e2) of `closed_form_t` for the cotangent g,
    rows of (ray, triangle) pairs (..., 3), written out as the map engine's
    icosphere backward kernel computes it (brute_hit.cuh): with p = d x e2,
    det = e1.p (1 where |det| <= 1e-12), s = o - v0, q = s x e1, num = e2.q
    and t = num / det: g_num = g / det, g_det = -g_num (num / det) (0 where
    |det| <= 1e-12), g_q = g_num e2, g_p = g_det e1; g_o = e1 x g_q = -g_v0,
    g_d = e2 x g_p, g_e1 = g_q x s + g_det p, g_e2 = g_num q + g_p x d."""
    p = cross3(d, e2)
    det = dot3(e1, p)
    valid = det.abs() > 1e-12
    ds = torch.where(valid, det, torch.ones_like(det))
    s = o - v0
    q = cross3(s, e1)
    num = dot3(e2, q)
    g_num = g / ds
    g_det = torch.where(valid, -(g_num * (num / ds)), torch.zeros_like(det))
    g_q = g_num[..., None] * e2
    g_o = cross3(e1, g_q)
    g_p = g_det[..., None] * e1
    g_e1 = cross3(g_q, s) + g_det[..., None] * p
    g_e2 = g_num[..., None] * q + cross3(g_p, d)
    return g_o, cross3(e2, g_p), -g_o, g_e1, g_e2


def sanitized_t_vjp(o, d, v0, e1, e2, g, hit):
    """VJP of `closed_form_t` for (ray, selected triangle) rows, evaluated with
    o -> 0 and d -> 1 where `hit` is False: a parked ray (|o| ~ 1e9) overflows
    the derivative's intermediates to inf, and a zero cotangent times inf is
    NaN (rfx/ops/intersect.py:170-174). Returns (go, gd, gv0, ge1, ge2)."""
    zero = torch.zeros((), dtype=o.dtype, device=o.device)
    one = torch.ones((), dtype=o.dtype, device=o.device)
    g = torch.where(hit, g, zero)
    args = [torch.where(hit[:, None], o, zero).detach().requires_grad_(),
            torch.where(hit[:, None], d, one).detach().requires_grad_(),
            v0.detach().requires_grad_(), e1.detach().requires_grad_(),
            e2.detach().requires_grad_()]
    with torch.enable_grad():
        t = closed_form_t(*args)
        return torch.autograd.grad(t, args, g)


class _BruteHit(torch.autograd.Function):
    """Brute closest hit with the reference's custom VJP
    (rfx/ops/intersect.py:159-185); face is an integer output."""

    @staticmethod
    def forward(ctx, o, d, v0, e1, e2, t_min, t_max, ray_chunk, cull):
        t, face = brute_hit(o, d, v0, e1, e2, t_min, t_max, ray_chunk, cull)
        ctx.mark_non_differentiable(face)
        ctx.save_for_backward(o, d, v0, e1, e2, face, t)
        return t, face

    @staticmethod
    def backward(ctx, g_t, _g_face):
        o, d, v0, e1, e2, face, t = ctx.saved_tensors
        sel = face.clamp_min(0).long()
        hit = (face >= 0) & is_hit(t)
        go, gd, gv0, ge1, ge2 = sanitized_t_vjp(o, d, v0[sel], e1[sel], e2[sel], g_t, hit)
        keep = hit[:, None].to(o.dtype)
        full = [torch.zeros_like(a).index_add_(0, sel, ga * keep)
                for a, ga in ((v0, gv0), (e1, ge1), (e2, ge2))]
        return go, gd, *full, None, None, None, None


def ray_mesh_closest_hit_brute(o, d, v0, e1, e2, t_min: float = T_MIN_EPS,
                               t_max: float = T_MAX, ray_chunk: int | None = None, cull=None):
    """Closest hit of (N, 3) rays against all T triangles: (t (N,), face (N,)
    int32), with t = MISS and face = -1 on a miss and ties going to the lowest
    face index (`brute_hit`: the kernel on a CUDA tensor, where `cull` may
    name the triangles' bounding icosphere; on a CPU tensor the plain
    version, `ray_chunk` rays at a time, by default enough to keep chunk x T
    near 4M pairs). Differentiable in o, d, v0, e1 and e2 through the
    selected face's closed-form t (straight-through selection)."""
    return _BruteHit.apply(o, d, v0, e1, e2, float(t_min), float(t_max), ray_chunk, cull)


def sphere_t(o, d, center, r2):
    """Smallest t > T_MIN_EPS of rays (N, 3) with the sphere |p - center|^2 =
    r2, MISS on a miss; tangent hits (disc == 0) miss. `center` is (3,) and
    `r2` a 0-dim tensor or float, both already f32."""
    oc = o - center
    b = dot3(oc, d)
    c = dot3(oc, oc) - r2
    disc = b * b - c
    hit = disc > 0.0
    s = torch.sqrt(torch.where(hit, disc, torch.ones_like(disc)))
    t0 = -b - s
    t1 = -b + s
    miss = torch.full_like(t0, MISS)
    t = torch.where(t0 > T_MIN_EPS, t0, torch.where(t1 > T_MIN_EPS, t1, miss))
    return torch.where(hit, t, miss)


def _sum_to(x: torch.Tensor, shape) -> torch.Tensor:
    return x.sum_to_size(shape) if x.shape != shape else x


class _SphereHit(torch.autograd.Function):
    """Sphere hit with the implicit-function backward of the reference
    (rfx/ops/intersect.py:229-248): with p = o + t d and q = p - C,
    dt/do = -q / (q.d), dt/dd = -t q / (q.d), dt/dC = q / (q.d),
    dt/dr = r / (q.d), where |q.d| is clamped to 1e-6 max(r, 1e-6).

    o and d are (..., 3) and broadcast against the center (..., 3), so one
    call tests a batch of receivers (centers (R, 1, 3), rays (N, 3))."""

    @staticmethod
    def forward(ctx, o, d, center, radius):
        t = sphere_t(o, d, center, radius * radius)
        ctx.save_for_backward(o, d, center, radius, t)
        return t

    @staticmethod
    def backward(ctx, g):
        o, d, center, radius, t = ctx.saved_tensors
        hit = is_hit(t)
        zero = torch.zeros((), dtype=t.dtype, device=t.device)
        t_safe = torch.where(hit, t, zero)
        q = o + t_safe[..., None] * d - center
        qd = dot3(q, d)
        mag = torch.maximum(qd.abs(), 1e-6 * radius.clamp_min(1e-6))
        qd_safe = torch.where(qd < 0.0, -mag, mag)
        gg = torch.where(hit, g, zero) / qd_safe
        go = -gg[..., None] * q
        gd = -(gg * t_safe)[..., None] * q
        gc = -go
        gr = gg.sum() * radius
        return (_sum_to(go, o.shape), _sum_to(gd, d.shape), _sum_to(gc, center.shape),
                gr.reshape(radius.shape))


def ray_sphere_hit(o, d, center, radius):
    """Receiver-sphere hit of unit-direction rays (..., 3): smallest t >
    T_MIN_EPS, MISS on a miss (rfx.ops.intersect.ray_sphere_hit), with its
    custom gradient in o, d, center and radius."""
    center = torch.as_tensor(center, dtype=torch.float32, device=o.device)
    r = torch.as_tensor(radius, dtype=torch.float32, device=o.device)
    return _SphereHit.apply(o, d, center, r)


def make_env_intersector(backend: str = "brute", *, mesh=None, flat_bvh=None,
                         differentiable_tris: bool = False, device="cuda"):
    """env_hit(o, d, v0, e1, e2, normals) -> (t, face, nrm), the bounce-loop
    tracers' closest-hit query (rfx/ops/intersect.py:254-303).

    backend:
      'brute'  - Moller-Trumbore over all triangles; the normal is
                 unit(cross(e1[f], e2[f])), differentiable in the edges;
      'kernel' - the per-query BVH kernel (rfx_torch.ops.bvh_trace), from
                 `flat_bvh` or `mesh`: the kernel on a CUDA tensor, its plain
                 version on a CPU tensor. The counterpart of the reference's
                 'pallas' backend, with `differentiable_tris` as there;
      'bvh'    - the plain-PyTorch stackless walk (rfx_torch.ops.bvh_traverse),
                 from `flat_bvh` or `mesh`, on either device, with
                 `differentiable_tris` as there.
    """
    if backend == "brute":
        def env_hit(o, d, v0, e1, e2, normals):
            t, face = ray_mesh_closest_hit_brute(o, d, v0, e1, e2)
            return t, face, hit_normal_from_edges(e1, e2, face)

        return env_hit
    if backend in ("kernel", "bvh"):
        if mesh is None and flat_bvh is None:
            raise ValueError(f"backend '{backend}' needs mesh= or flat_bvh=")
        if backend == "kernel":
            from rfx_torch.ops.bvh_trace import make_kernel_env_hit as make
        else:
            from rfx_torch.ops.bvh_traverse import make_bvh_env_hit as make

        return make(flat_bvh if flat_bvh is not None else mesh,
                    differentiable_tris=differentiable_tris, device=device)
    raise ValueError(f"unknown intersector backend: {backend}")
