"""Frozen copies of the scene builders the benchmark's configurations name.

Copied from `rfx_torch/geometry.py` at commit e4c1a10 (`make_terrain`,
`make_box` / `make_room`, `icosphere`), numpy only, returning plain
(vertices (V, 3) float32, faces (F, 3) int32) arrays. The benchmark builds
each scene here and hands the same arrays to the port and to the plain
reference, so a later change to the port's own builders cannot change what
is measured.
"""

from __future__ import annotations

import numpy as np

__all__ = ["icosphere", "make_box", "make_room", "make_terrain", "build_scene"]


def icosphere(center=(0.0, 0.0, 0.0), radius: float = 1.0, subdivisions: int = 1):
    """The receiver's icosphere: 42 vertices and 80 faces at one subdivision."""
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
    return verts.astype(np.float32), faces.astype(np.int32)


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


def make_box(lo=(-0.5, -0.5, -0.5), hi=(0.5, 0.5, 0.5)):
    x0, y0, z0 = np.asarray(lo, np.float32)
    x1, y1, z1 = np.asarray(hi, np.float32)
    verts = np.array(
        [
            [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
            [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1],
        ],
        dtype=np.float32,
    )
    return verts, _BOX_FACES.copy()


def make_room(width: float = 31.6, depth: float = 31.6, height: float = 15.8):
    """A closed box room of the reference room.stl's extents."""
    return make_box(lo=(-width / 2, -depth / 2, 0.0), hi=(width / 2, depth / 2, height))


def make_terrain(grid: int = 128, extent: float = 60.0, height_scale: float = 6.0,
                 num_craters: int = 24, seed: int = 0):
    """Procedural lunar heightfield: value noise and craters over a (grid x
    grid) lattice spanning [-extent/2, extent/2]^2; 2 (grid-1)^2 triangles."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-extent / 2, extent / 2, grid, dtype=np.float64)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    Z = np.zeros((grid, grid), dtype=np.float64)
    amp = 1.0
    for octave_cells in (4, 8, 16, 32):
        lattice = rng.standard_normal((octave_cells + 1, octave_cells + 1))
        u = np.linspace(0, octave_cells, grid)
        i0 = np.clip(u.astype(np.int64), 0, octave_cells - 1)
        frac = u - i0
        rows = lattice[i0] * (1 - frac)[:, None] + lattice[i0 + 1] * frac[:, None]
        vals = rows[:, i0] * (1 - frac)[None, :] + rows[:, i0 + 1] * frac[None, :]
        Z += amp * vals
        amp *= 0.5
    Z *= height_scale / max(1e-9, np.abs(Z).max())
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
    faces = np.concatenate([np.stack([a, b, c], axis=1), np.stack([a, c, d], axis=1)],
                           axis=0).astype(np.int32)
    return verts, faces


_BUILDERS = {"terrain": make_terrain, "room": make_room, "box": make_box}


def build_scene(spec: dict):
    """(vertices, faces) of a configuration's `scene`: {"builder": name, **kwargs}."""
    spec = dict(spec)
    builder = _BUILDERS[spec.pop("builder")]
    return builder(**spec)
