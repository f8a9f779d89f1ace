"""Carry the JAX package's state across to the port, importing neither JAX
nor the JAX package: every object is read by its fields, as numpy arrays.

- the scene: vertices and faces of an `rfx.tracer.Scene` (or any object with
  those two arrays) as numpy, then as a `rfx_torch.tracer.Scene`;
- the mesh: an `rfx.geometry.TriangleMesh` as a `rfx_torch.geometry.TriangleMesh`;
- the BVH: an `rfx.bvh.FlatBVH` as a `rfx_torch.bvh.FlatBVH` (the two are
  different types with the same fields), packed for the device by
  `rfx_torch.ops.bvh_pack.pack_bvh`;
- a tracer's configuration, read from an `rfx.api.Tracer` instance's
  attributes, and a port `Tracer` built from it;
- the inverse solver's parameters, an `rfx.solver.InverseParams`, as a
  `rfx_torch.solver.InverseParams` of leaf tensors;
- an env-only trace's segments, an `rfx.tracer.EnvSegments`, as a
  `rfx_torch.tracer.EnvSegments`, so both coverage engines can be fed the
  same segments.

Arrays are read with `numpy.array`, which takes JAX arrays as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from rfx_torch.api import Tracer
from rfx_torch.bvh import FlatBVH, as_flat_bvh
from rfx_torch.device import resolve_device
from rfx_torch.geometry import TriangleMesh, as_mesh
from rfx_torch.ops.bvh_pack import PackedBVH, pack_bvh
from rfx_torch.solver import InverseParams
from rfx_torch.tracer import EnvSegments, Scene

__all__ = ["scene_arrays", "scene_from_rfx", "mesh_from_rfx", "flat_bvh_from_rfx",
           "bvh_from_rfx", "tracer_config", "tracer_from_rfx", "segments_from_rfx",
           "inverse_params_from_rfx"]

#: The `rfx.api.Tracer` attributes that make up its configuration.
TRACER_CONFIG_KEYS = ("light_speed_mps", "sample_rate_hz", "sample_window_s", "max_bounces",
                      "tx_num_rays", "n1", "n2", "rx_mode")


def scene_arrays(scene) -> tuple[np.ndarray, np.ndarray]:
    """(vertices (V, 3) f32, faces (F, 3) i32) as numpy copies."""
    return (np.array(scene.vertices, np.float32).reshape(-1, 3),
            np.array(scene.faces, np.int32).reshape(-1, 3))


def scene_from_rfx(scene, device="cuda") -> Scene:
    vertices, faces = scene_arrays(scene)
    dev = resolve_device(device)
    return Scene(torch.as_tensor(vertices, device=dev), torch.as_tensor(faces, device=dev))


def mesh_from_rfx(mesh) -> TriangleMesh:
    """The port's TriangleMesh from an `rfx.geometry.TriangleMesh` (or any
    object with `vertices` and `faces`); TypeError otherwise."""
    return as_mesh(mesh)


def flat_bvh_from_rfx(flat) -> FlatBVH:
    """The port's FlatBVH from an `rfx.bvh.FlatBVH` (or any object with its
    fields); TypeError otherwise."""
    out = as_flat_bvh(flat)
    if out is None:
        raise TypeError(f"expected a FlatBVH, got {type(flat).__name__}")
    return out


def bvh_from_rfx(flat, device="cuda") -> PackedBVH:
    """The kernels' tables for a FlatBVH built by `rfx.bvh.build_bvh`."""
    return pack_bvh(flat_bvh_from_rfx(flat), resolve_device(device))


def tracer_config(tracer) -> dict:
    """Configuration of an `rfx.api.Tracer` (c, rate, window, bounces, ray
    count, n1, n2, rx_mode) as plain Python values."""
    missing = [k for k in TRACER_CONFIG_KEYS if not hasattr(tracer, k)]
    if missing:
        raise TypeError(f"not an rfx.api.Tracer: missing {missing}")
    cfg = {k: getattr(tracer, k) for k in TRACER_CONFIG_KEYS}
    for k in ("light_speed_mps", "sample_rate_hz", "sample_window_s", "n1", "n2"):
        cfg[k] = float(cfg[k])
    for k in ("max_bounces", "tx_num_rays"):
        cfg[k] = int(cfg[k])
    return cfg


def tracer_from_rfx(tracer, *, backend: str = "auto", device="cuda") -> Tracer:
    """A port `Tracer` over the same mesh with the same configuration."""
    cfg = tracer_config(tracer)
    return Tracer(
        mesh_from_rfx(tracer.mesh), cfg["light_speed_mps"], cfg["sample_rate_hz"], cfg["sample_window_s"],
        cfg["max_bounces"], cfg["tx_num_rays"], n1=cfg["n1"], n2=cfg["n2"],
        rx_mode=cfg["rx_mode"], backend=backend, device=device)


def segments_from_rfx(segs, device="cuda") -> EnvSegments:
    """The port's EnvSegments from an `rfx.tracer.EnvSegments` (or any
    object with its six fields): origin and direction (B, N, 3) f32, t_env,
    amplitude and distance (B, N) f32, alive (B, N) bool."""
    dev = resolve_device(device)

    def field(name, dtype, ndim):
        a = np.array(getattr(segs, name), dtype)
        if a.ndim != ndim:
            raise ValueError(f"segments: {name} must have {ndim} dimensions, got {a.shape}")
        return torch.as_tensor(a, device=dev)

    return EnvSegments(field("origin", np.float32, 3), field("direction", np.float32, 3),
                       field("t_env", np.float32, 2), field("amplitude", np.float32, 2),
                       field("distance", np.float32, 2), field("alive", np.bool_, 2))


def inverse_params_from_rfx(params, device="cuda") -> InverseParams:
    """The port's InverseParams (f32 leaf tensors that require grad) from an
    `rfx.solver.InverseParams` (tx_pos (3,), log_n1 (), optional vertices)."""
    dev = resolve_device(device)

    def leaf(a, shape):
        return torch.as_tensor(np.array(a, np.float32).reshape(shape), device=dev).requires_grad_()

    verts = None if params.vertices is None else leaf(params.vertices, (-1, 3))
    return InverseParams(leaf(params.tx_pos, (3,)), leaf(params.log_n1, ()), verts)
