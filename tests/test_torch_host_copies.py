"""The port keeps its own copies of the JAX package's host modules (it imports
nothing of `rfx`): each copy is held here against its original on the same
numpy inputs, so an edit of one side shows. Also: objects of the JAX
package's types cross into the port field by field, and no file of the port
imports `rfx` or `jax`."""

import dataclasses
import glob
import os
import re

import numpy as np
import pytest
import torch

import rfx.bvh as jbvh
import rfx.config as jconfig
import rfx.geometry as jgeometry
import rfx.utils.checkpoint as jcheckpoint
import rfx.viz as jviz
from rfx_torch import bvh, config, convert, geometry, viz
from rfx_torch.ops import fused
from rfx_torch.ops.bvh_pack import pack_bvh
from rfx_torch.utils import checkpoint

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAT_FIELDS = [f.name for f in dataclasses.fields(jbvh.FlatBVH)]


def _assert_same_mesh(a, b):
    assert a.vertices.dtype == b.vertices.dtype == np.float32
    assert a.faces.dtype == b.faces.dtype == np.int32
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)


@pytest.mark.parametrize("make,kw", [
    ("make_terrain", dict(grid=34, extent=30.0, seed=1)),
    ("make_terrain", dict(grid=12, extent=24.0, seed=9)),
    ("make_room", {}),
    ("make_empty_scene", {}),
    ("make_box", dict(lo=(-1.0, -2.0, 0.0), hi=(3.0, 2.0, 5.0))),
    ("icosphere", dict(center=(1.0, 2.0, 3.0), radius=2.5, subdivisions=1)),
    ("icosphere", dict(center=(0.0, 0.0, 0.0), radius=1.0, subdivisions=2)),
])
def test_geometry_copy_matches_rfx(make, kw):
    ours, theirs = getattr(geometry, make)(**kw), getattr(jgeometry, make)(**kw)
    _assert_same_mesh(ours, theirs)
    np.testing.assert_array_equal(ours.face_normals(), theirs.face_normals())
    np.testing.assert_array_equal(ours.triangles(), theirs.triangles())


def test_stl_round_trip_matches_rfx(tmp_path):
    mesh = geometry.make_terrain(grid=8, extent=10.0, seed=2)
    path = str(tmp_path / "t.stl")
    geometry.save_stl(mesh, path)
    _assert_same_mesh(geometry.load_stl(path), jgeometry.load_stl(path))
    assert geometry.load_stl(path).num_faces == mesh.num_faces
    bad = tmp_path / "bad.stl"
    bad.write_bytes(b"solid x\nfacet normal 0 0 0\n")
    with pytest.raises(ValueError):
        geometry.load_stl(str(bad))


@pytest.mark.parametrize("split,leaf,arity", [("sah", 8, 2), ("median", 8, 2), ("sah", 16, 2),
                                              ("sah", 8, 4)])
def test_numpy_builder_copy_matches_rfx_field_for_field(split, leaf, arity):
    mesh = geometry.make_terrain(grid=20, extent=30.0, seed=4)
    ours = bvh.build_bvh(mesh, leaf_size=leaf, method="numpy", split=split, arity=arity)
    theirs = jbvh.build_bvh(jgeometry.make_terrain(grid=20, extent=30.0, seed=4),
                            leaf_size=leaf, method="numpy", split=split, arity=arity)
    assert [f.name for f in dataclasses.fields(bvh.FlatBVH)] == FLAT_FIELDS
    for name in FLAT_FIELDS:
        a, b = getattr(ours, name), getattr(theirs, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert ours.max_depth() == theirs.max_depth()
    assert bvh.LEAF_SIZE == jbvh.LEAF_SIZE


def test_rfx_objects_cross_by_field():
    """An rfx mesh or FlatBVH is another type than the port's: convert and
    the port's entry points carry it across by its fields."""
    jmesh = jgeometry.make_terrain(grid=12, extent=24.0, seed=9)
    jflat = jbvh.build_bvh(jmesh, leaf_size=8, method="numpy")
    assert not isinstance(jmesh, geometry.TriangleMesh)
    assert not isinstance(jflat, bvh.FlatBVH)
    mesh = convert.mesh_from_rfx(jmesh)
    flat = convert.flat_bvh_from_rfx(jflat)
    assert isinstance(mesh, geometry.TriangleMesh) and isinstance(flat, bvh.FlatBVH)
    _assert_same_mesh(mesh, jmesh)
    for name in FLAT_FIELDS:
        np.testing.assert_array_equal(getattr(flat, name), getattr(jflat, name), err_msg=name)
    assert convert.flat_bvh_from_rfx(flat) is flat and convert.mesh_from_rfx(mesh) is mesh
    a = pack_bvh(flat, torch.device("cpu"))
    b = fused.make_fused_tracer(jflat, max_bounces=1, device="cpu").bvh
    c = fused.make_fused_tracer(jmesh, max_bounces=1, device="cpu").bvh
    for x in (b, c):
        assert torch.equal(a.tri, x.tri) and torch.equal(a.nodes.view(torch.int32), x.nodes.view(torch.int32))
    for wrong in (object(), 3, jmesh):
        with pytest.raises(TypeError):
            convert.flat_bvh_from_rfx(wrong)
    for wrong in (object(), jflat):
        with pytest.raises(TypeError):
            convert.mesh_from_rfx(wrong)
    with pytest.raises(TypeError):
        fused.make_fused_tracer(object(), max_bounces=1, device="cpu")
    from rfx_torch.api import Tracer

    with pytest.raises(TypeError, match="TriangleMesh"):
        Tracer(object(), device="cpu")
    assert isinstance(Tracer(jmesh, max_bounces=1, tx_num_rays=8, device="cpu").mesh,
                      geometry.TriangleMesh)


def test_config_copy_matches_rfx(tmp_path):
    assert set(config.SCENES) == set(jconfig.SCENES)
    for name in ("room", "empty", "terrain-small"):
        _assert_same_mesh(config.resolve_scene(name), jconfig.resolve_scene(name))
    path = str(tmp_path / "s.stl")
    geometry.save_stl(geometry.make_room(), path)
    _assert_same_mesh(config.resolve_scene(path), jconfig.resolve_scene(path))
    for ours, theirs in ((config.TraceConfig, jconfig.TraceConfig),
                         (config.CoverageConfig, jconfig.CoverageConfig)):
        assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())
        cfg = ours(num_rays=77, tx_pos=(1.0, 2.0, 3.0))
        assert dataclasses.asdict(ours.from_json(cfg.to_json())) == dataclasses.asdict(
            theirs.from_json(cfg.to_json()))
    np.testing.assert_array_equal(config.CoverageConfig().grid_points(),
                                  jconfig.CoverageConfig().grid_points())


def test_chunk_accumulator_copy_resumes_as_rfx(tmp_path):
    """The same chunks through both accumulators, each killed after chunk 1
    and resumed: the same sums, the same chunks recomputed."""
    g = np.random.default_rng(3)
    parts = [g.random(16).astype(np.float32) for _ in range(4)]
    results, calls = [], []
    for mod, sub in ((checkpoint, "ours"), (jcheckpoint, "theirs")):
        directory = str(tmp_path / sub)
        seen = []

        def compute(cid, fail_at=None, seen=seen):
            if cid == fail_at:
                raise KeyboardInterrupt
            seen.append(cid)
            return {"ir": parts[cid]}

        with pytest.raises(KeyboardInterrupt):
            mod.run_chunked(lambda cid: compute(cid, fail_at=2), 4, directory)
        assert mod.ChunkAccumulator(directory).done_chunks == {0, 1}
        results.append(mod.run_chunked(compute, 4, directory)["ir"])
        calls.append(list(seen))
        assert mod.run_chunked(compute, 4, directory)["ir"] is not None and seen == calls[-1]
    assert calls[0] == calls[1] == [0, 1, 2, 3]
    np.testing.assert_array_equal(results[0], results[1])
    np.testing.assert_allclose(results[0], np.sum(parts, axis=0), rtol=1e-6)


@pytest.mark.parametrize("n,seed", [(1, 0), (2048, 0), (4096, 31)])
def test_graft_entry_sampler_copy_matches_oracle(n, seed):
    from oracle import sample_sphere_directions

    from rfx_torch.graft_entry import uniform_sphere_directions

    ours = uniform_sphere_directions(n, seed=seed)
    assert ours.dtype == np.float32 and ours.shape == (n, 3)
    np.testing.assert_array_equal(ours, sample_sphere_directions(n, seed=seed))


def test_viz_copy_matches_rfx(tmp_path):
    mesh = geometry.make_room()
    kw = dict(tx_pos=(1.0, 2.0, 3.0), rx_pos=(-1.0, 0.0, 2.0), rx_radius=0.5,
              paths=[np.array([[1.0, 2.0, 3.0], [0.0, 0.0, 0.0], [-1.0, 0.0, 2.0]], np.float32)])
    ours = viz.scene_to_html(mesh=mesh, **kw)
    theirs = jviz.scene_to_html(mesh=jgeometry.make_room(), **kw)
    assert ours == theirs and "three" in ours
    out = str(tmp_path / "scene.html")
    viz.visualize(mesh=mesh, out_path=out, serve=False, **kw)
    assert open(out).read() == ours


_IMPORT = re.compile(r"^\s*(?:from|import)\s+(rfx|jax|jaxlib)(?:\.[\w.]+)?(?:\s|$)", re.M)


def test_no_file_of_the_port_imports_rfx_or_jax():
    files = (glob.glob(os.path.join(REPO, "rfx_torch", "**", "*.py"), recursive=True)
             + glob.glob(os.path.join(REPO, "scripts", "torch_*.py"))
             + [os.path.join(REPO, "chip_smoke.py")])
    assert len(files) > 25
    found = {}
    for path in files:
        hits = _IMPORT.findall(open(path).read())
        if hits:
            found[os.path.relpath(path, REPO)] = hits
    assert not found, f"the port imports the JAX package or JAX: {found}"
    assert _IMPORT.search("import rfx\n") and _IMPORT.search("    from rfx.bvh import x\n")
    assert _IMPORT.search("import jax.numpy as jnp\n") and not _IMPORT.search("import rfx_torch\n")


def test_package_docstring_names_the_sources_and_entry_points():
    """The package's account of itself follows the code: it imports nothing of
    rfx, and it names every CUDA source and the number of C entry points."""
    import re

    import rfx_torch
    from rfx_torch.ops._build import CSRC_DIR

    doc = " ".join(rfx_torch.__doc__.split())
    assert "nothing of `rfx`" in doc and "imported from" not in doc
    sources = sorted(p.name for p in CSRC_DIR.glob("*.cu"))
    entries = [m for p in CSRC_DIR.glob("*.cu")
               for m in re.findall(r'extern "C" int (rfx_\w+)\(', p.read_text())]
    words = {5: "five", 6: "six", 7: "seven", 8: "eight", 9: "nine", 10: "ten"}
    assert f"{words[len(entries)]} C entry points in {words[len(sources)]} sources" in doc
    for name in sources:
        assert f"`{name}`" in doc, name
