"""Geometry: triangle meshes, STL IO, procedural scenes, icospheres.

The port's own copy of rfx/geometry.py (numpy only; the port imports nothing
of the JAX package), held against the original by
tests/test_torch_host_copies.py. A host-side NumPy `TriangleMesh`; the
device-side SoA arrays (v0 / e1 / e2) are derived from
`vertices` / `faces` by rfx_torch.ops.intersect.mesh_soa, so vertex positions
remain differentiable parameters (ref: tracer.py:22-30 uses trimesh STL
loading + `wp.Mesh` upload).

No third-party mesh dependency: STL parsing (binary + ASCII) is implemented
directly with NumPy, and the receiver icosphere (ref: tracer.py:26-30,
trimesh.primitives.Sphere(subdivisions=1) -> 80 faces) is generated by
subdividing an icosahedron.
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "TriangleMesh",
    "load_stl",
    "save_stl",
    "icosphere",
    "make_box",
    "make_room",
    "make_empty_scene",
    "make_terrain",
    "merge_meshes",
    "as_mesh",
]


@dataclass
class TriangleMesh:
    """Host-side triangle mesh: (V, 3) float32 vertices, (F, 3) int32 faces."""

    vertices: np.ndarray
    faces: np.ndarray
    name: str = "mesh"

    def __post_init__(self):
        self.vertices = np.ascontiguousarray(self.vertices, dtype=np.float32)
        self.faces = np.ascontiguousarray(self.faces, dtype=np.int32)
        if self.vertices.ndim != 2 or self.vertices.shape[1] != 3:
            raise ValueError(f"vertices must be (V, 3), got {self.vertices.shape}")
        if self.faces.ndim != 2 or self.faces.shape[1] != 3:
            raise ValueError(f"faces must be (F, 3), got {self.faces.shape}")

    @property
    def num_vertices(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def num_faces(self) -> int:
        return int(self.faces.shape[0])

    def triangles(self) -> np.ndarray:
        """(F, 3, 3) corner positions."""
        return self.vertices[self.faces]

    def face_normals(self, normalize: bool = True) -> np.ndarray:
        tri = self.triangles()
        n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        if normalize:
            ln = np.linalg.norm(n, axis=1, keepdims=True)
            n = n / np.maximum(ln, 1e-30)
        return n.astype(np.float32)

    def face_centroids(self) -> np.ndarray:
        return self.triangles().mean(axis=1).astype(np.float32)

    def bounds(self) -> tuple[np.ndarray, np.ndarray]:
        return self.vertices.min(axis=0), self.vertices.max(axis=0)

    def transformed(self, scale: float = 1.0, offset=(0.0, 0.0, 0.0)) -> "TriangleMesh":
        return TriangleMesh(
            self.vertices * np.float32(scale) + np.asarray(offset, np.float32),
            self.faces,
            name=self.name,
        )


def as_mesh(obj) -> TriangleMesh:
    """`obj` itself if it is a TriangleMesh; a TriangleMesh of numpy copies of
    its `vertices` and `faces` if it has both (the JAX package's own
    `TriangleMesh` is another type); TypeError otherwise."""
    if isinstance(obj, TriangleMesh):
        return obj
    if not (hasattr(obj, "vertices") and hasattr(obj, "faces")):
        raise TypeError(f"expected a TriangleMesh (vertices (V, 3), faces (F, 3)), got "
                        f"{type(obj).__name__}")
    return TriangleMesh(np.array(obj.vertices, np.float32), np.array(obj.faces, np.int32),
                        name=str(getattr(obj, "name", "mesh")))


# ---------------------------------------------------------------------------
# STL IO (binary + ASCII), no external deps.
# ---------------------------------------------------------------------------

def _dedupe_vertices(raw_tris: np.ndarray) -> TriangleMesh:
    """(F, 3, 3) corner soup -> indexed mesh by exact-bitpattern dedup."""
    flat = raw_tris.reshape(-1, 3).astype(np.float32)
    # Exact dedup on the float bit patterns (STL repeats shared corners).
    keys = flat.view(np.uint32).reshape(-1, 3)
    keys_struct = np.ascontiguousarray(keys).view([("x", np.uint32), ("y", np.uint32), ("z", np.uint32)])
    _, idx, inv = np.unique(keys_struct, return_index=True, return_inverse=True)
    vertices = flat[idx]
    faces = inv.reshape(-1, 3).astype(np.int32)
    return TriangleMesh(vertices, faces)


def load_stl(path: str) -> TriangleMesh:
    """Load a binary or ASCII STL file into an indexed TriangleMesh."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) >= 84:
        (count,) = struct.unpack_from("<I", data, 80)
        if 84 + count * 50 == len(data):
            mesh = _parse_binary_stl(data, count)
            mesh.name = path
            return mesh
    # Fall through to ASCII.
    mesh = _parse_ascii_stl(data.decode("ascii", errors="replace"))
    mesh.name = path
    return mesh


def _parse_binary_stl(data: bytes, count: int) -> TriangleMesh:
    rec = np.frombuffer(data, dtype=np.uint8, count=count * 50, offset=84)
    rec = rec.reshape(count, 50)
    floats = rec[:, :48].reshape(count, 12, 4).copy().view(np.float32).reshape(count, 12)
    tris = floats[:, 3:12].reshape(count, 3, 3)  # skip the normal, keep corners
    return _dedupe_vertices(tris)


def _parse_ascii_stl(text: str) -> TriangleMesh:
    verts = []
    for line in io.StringIO(text):
        parts = line.split()
        if len(parts) == 4 and parts[0] == "vertex":
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    arr = np.asarray(verts, dtype=np.float32)
    if arr.size == 0 or arr.shape[0] % 3 != 0:
        raise ValueError("malformed ASCII STL")
    return _dedupe_vertices(arr.reshape(-1, 3, 3))


def save_stl(mesh: TriangleMesh, path: str) -> None:
    """Write a binary STL."""
    tri = mesh.triangles().astype(np.float32)
    n = mesh.face_normals()
    count = tri.shape[0]
    out = np.zeros((count, 50), dtype=np.uint8)
    floats = np.concatenate([n[:, None, :], tri], axis=1).reshape(count, 12).astype(np.float32)
    out[:, :48] = floats.view(np.uint8).reshape(count, 48)
    with open(path, "wb") as f:
        f.write(b"\x00" * 80)
        f.write(struct.pack("<I", count))
        f.write(out.tobytes())


# ---------------------------------------------------------------------------
# Icosphere (receiver geometry parity with ref tracer.py:27: subdivisions=1
# icosphere = 42 vertices / 80 faces).
# ---------------------------------------------------------------------------

def icosphere(center=(0.0, 0.0, 0.0), radius: float = 1.0, subdivisions: int = 1) -> TriangleMesh:
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)

    for _ in range(subdivisions):
        edge_mid: dict[tuple[int, int], int] = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(a: int, b: int) -> int:
            key = (a, b) if a < b else (b, a)
            if key in edge_mid:
                return edge_mid[key]
            m = verts_list[a] + verts_list[b]
            m = m / np.linalg.norm(m)
            verts_list.append(m)
            edge_mid[key] = len(verts_list) - 1
            return edge_mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, dtype=np.int64)

    verts = verts * float(radius) + np.asarray(center, np.float64)
    return TriangleMesh(verts.astype(np.float32), faces.astype(np.int32), name="icosphere")


# ---------------------------------------------------------------------------
# Procedural scenes. The reference ships binary STL assets (models/room.stl =
# 44-triangle box room, models/almost_empty.stl = 0.1 m cube,
# models/apollo_17_landing_site.stl = lunar terrain, missing from the mirror).
# We generate equivalents procedurally; load_stl() covers user assets.
# ---------------------------------------------------------------------------

_BOX_FACES = np.array(
    [
        [0, 2, 1], [0, 3, 2],  # bottom (z=lo)
        [4, 5, 6], [4, 6, 7],  # top (z=hi)
        [0, 1, 5], [0, 5, 4],  # y=lo
        [2, 3, 7], [2, 7, 6],  # y=hi
        [1, 2, 6], [1, 6, 5],  # x=hi
        [3, 0, 4], [3, 4, 7],  # x=lo
    ],
    dtype=np.int32,
)


def make_box(lo=(-0.5, -0.5, -0.5), hi=(0.5, 0.5, 0.5), name: str = "box") -> TriangleMesh:
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    verts = np.array(
        [
            [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
            [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1],
        ],
        dtype=np.float32,
    )
    return TriangleMesh(verts, _BOX_FACES.copy(), name=name)


def make_room(width: float = 31.6, depth: float = 31.6, height: float = 15.8) -> TriangleMesh:
    """Procedural box room matching the reference room.stl extents
    (ref: models/room.stl is a ~31.6 x 31.6 x 15.8 m closed box)."""
    return make_box(
        lo=(-width / 2, -depth / 2, 0.0),
        hi=(width / 2, depth / 2, height),
        name="room",
    )


def make_empty_scene(size: float = 0.1) -> TriangleMesh:
    """Near-empty scene: a tiny cube at the origin (ref: models/almost_empty.stl)."""
    h = size / 2
    return make_box(lo=(-h, -h, 0.0), hi=(h, h, size), name="almost_empty")


def make_terrain(
    grid: int = 128,
    extent: float = 60.0,
    height_scale: float = 6.0,
    num_craters: int = 24,
    seed: int = 0,
    name: str = "terrain",
) -> TriangleMesh:
    """Procedural lunar-terrain heightfield (stand-in for the reference's
    apollo_17_landing_site.stl, which is a missing large blob in the mirror).

    Multi-octave value noise plus bowl-shaped craters over a (grid x grid)
    vertex lattice spanning [-extent/2, extent/2]^2; 2*(grid-1)^2 triangles.
    """
    rng = np.random.default_rng(seed)
    xs = np.linspace(-extent / 2, extent / 2, grid, dtype=np.float64)
    X, Y = np.meshgrid(xs, xs, indexing="ij")

    # Multi-octave value noise via bilinear upsampling of random lattices.
    Z = np.zeros((grid, grid), dtype=np.float64)
    amp = 1.0
    for octave_cells in (4, 8, 16, 32):
        lattice = rng.standard_normal((octave_cells + 1, octave_cells + 1))
        u = np.linspace(0, octave_cells, grid)
        i0 = np.clip(u.astype(np.int64), 0, octave_cells - 1)
        frac = u - i0
        # separable bilinear interp
        rows = lattice[i0] * (1 - frac)[:, None] + lattice[i0 + 1] * frac[:, None]
        vals = rows[:, i0] * (1 - frac)[None, :] + rows[:, i0 + 1] * frac[None, :]
        Z += amp * vals
        amp *= 0.5
    Z *= height_scale / max(1e-9, np.abs(Z).max())

    # Craters: smooth radial bowls with a raised rim.
    for _ in range(num_craters):
        cx, cy = rng.uniform(-extent / 2, extent / 2, size=2)
        cr = rng.uniform(extent / 40, extent / 8)
        depth = rng.uniform(0.2, 1.0) * height_scale * 0.5
        r = np.sqrt((X - cx) ** 2 + (Y - cy) ** 2) / cr
        bowl = np.where(r < 1.0, -np.cos(np.clip(r, 0, 1) * np.pi / 2) ** 2, 0.0)
        rim = np.where((r >= 1.0) & (r < 1.4), 0.25 * np.exp(-((r - 1.0) / 0.15) ** 2), 0.0)
        Z += depth * (bowl + rim)

    verts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3).astype(np.float32)
    idx = np.arange(grid * grid, dtype=np.int32).reshape(grid, grid)
    a = idx[:-1, :-1].ravel()
    b = idx[1:, :-1].ravel()
    c = idx[1:, 1:].ravel()
    d = idx[:-1, 1:].ravel()
    faces = np.concatenate(
        [np.stack([a, b, c], axis=1), np.stack([a, c, d], axis=1)], axis=0
    ).astype(np.int32)
    return TriangleMesh(verts, faces, name=name)


def merge_meshes(meshes: list[TriangleMesh], name: str = "merged") -> TriangleMesh:
    verts = []
    faces = []
    offset = 0
    for m in meshes:
        verts.append(m.vertices)
        faces.append(m.faces + offset)
        offset += m.num_vertices
    return TriangleMesh(np.concatenate(verts), np.concatenate(faces), name=name)
