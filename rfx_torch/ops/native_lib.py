"""ctypes binding of the native C++ BVH builder (native/bvh_builder.cpp), the
port's counterpart of rfx/ops/native_lib.py.

The source is read in place at the root of the checkout and compiled at
first use with `g++ -O3 -fPIC -shared -std=c++17` into
`build/rfx_torch/bvh_builder-<hash>.so`, the hash covering the source and
the flags, so an edited source builds anew and a stale binary is never
loaded. No `-march=native`: the library must not depend on the host that
built it. Where `g++` or the source is missing, `native_available()` is
False, `unavailable_reason()` says why and `build_bvh_native` raises;
`rfx_torch.bvh.build_bvh(method="auto")` then takes the numpy builder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from rfx_torch.ops._build import BUILD_DIR

__all__ = ["native_available", "unavailable_reason", "build_bvh_native", "load"]

SOURCE = Path(__file__).resolve().parents[2] / "native" / "bvh_builder.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)


class _Native:
    """The loaded library, or the reason it could not be built; one attempt
    per process."""

    lib = None
    reason = None


def _compile() -> Path:
    if not SOURCE.exists():
        raise RuntimeError(f"{SOURCE} is missing")
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    out = BUILD_DIR / f"bvh_builder-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load():
    """Build (if needed) and bind the library; returns it, or raises
    RuntimeError with the reason."""
    if _Native.lib is None and _Native.reason is None:
        try:
            lib = ctypes.CDLL(str(_compile()))
        except (RuntimeError, OSError, subprocess.SubprocessError) as e:
            _Native.reason = str(e)
        else:
            lib.rfx_bvh_build.restype = ctypes.c_void_p
            lib.rfx_bvh_build.argtypes = [_F32P, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.rfx_bvh_n_nodes.restype = ctypes.c_int
            lib.rfx_bvh_n_nodes.argtypes = [ctypes.c_void_p]
            lib.rfx_bvh_n_padded.restype = ctypes.c_longlong
            lib.rfx_bvh_n_padded.argtypes = [ctypes.c_void_p]
            lib.rfx_bvh_fill.restype = None
            lib.rfx_bvh_fill.argtypes = [ctypes.c_void_p, _F32P, _F32P, _I32P, _I32P, _I32P,
                                         _F32P, _F32P, _F32P, _I32P]
            lib.rfx_bvh_free.restype = None
            lib.rfx_bvh_free.argtypes = [ctypes.c_void_p]
            _Native.lib = lib
    if _Native.lib is None:
        raise RuntimeError(f"native BVH builder unavailable: {_Native.reason}")
    return _Native.lib


def native_available() -> bool:
    try:
        load()
    except RuntimeError:
        return False
    return True


def unavailable_reason() -> str | None:
    """Why the builder could not be loaded (None if it could, or before the
    first attempt)."""
    return _Native.reason


def build_bvh_native(mesh, leaf_size: int, split: str = "sah"):
    """TriangleMesh -> FlatBVH through the C++ builder: the layout contract
    and split heuristics (binned SAH / centroid median) of
    rfx_torch.bvh.build_bvh's numpy path, not the same tree."""
    from rfx_torch.bvh import FlatBVH

    lib = load()
    tris = np.ascontiguousarray(mesh.triangles().reshape(-1, 9), dtype=np.float32)
    f = tris.shape[0]
    if f == 0 or f >= 2**31:
        raise ValueError(f"the native builder takes 1 to 2^31 - 1 triangles, got {f}")
    if leaf_size < 1:
        raise ValueError(f"leaf_size must be positive, got {leaf_size}")
    h = lib.rfx_bvh_build(tris.ctypes.data_as(_F32P), f, int(leaf_size),
                          1 if split == "sah" else 0)
    try:
        n_nodes = lib.rfx_bvh_n_nodes(h)
        p = lib.rfx_bvh_n_padded(h)
        f32 = {k: np.empty(shape, np.float32) for k, shape in (
            ("aabb_min", (n_nodes, 3)), ("aabb_max", (n_nodes, 3)), ("tri_v0", (p, 3)),
            ("tri_e1", (p, 3)), ("tri_e2", (p, 3)))}
        i32 = {k: np.empty(shape, np.int32) for k, shape in (
            ("tri_start", (n_nodes,)), ("tri_count", (n_nodes,)), ("skip", (n_nodes,)),
            ("tri_face", (p,)))}
        fp = {k: a.ctypes.data_as(_F32P) for k, a in f32.items()}
        ip = {k: a.ctypes.data_as(_I32P) for k, a in i32.items()}
        lib.rfx_bvh_fill(h, fp["aabb_min"], fp["aabb_max"], ip["tri_start"], ip["tri_count"],
                         ip["skip"], fp["tri_v0"], fp["tri_e1"], fp["tri_e2"], ip["tri_face"])
    finally:
        lib.rfx_bvh_free(h)
    return FlatBVH(**f32, **i32, leaf_size=leaf_size)
