"""three.js HTML scene export + HTTP viewer (the port's own copy of
rfx/viz/visualization.py; numpy and the standard library only).

Feature parity with the reference visualizer (ref viz/visualization.py:6-50),
which builds a trimesh Scene (gray env mesh, red TX sphere r=0.25, green RX
sphere, gray path polylines, white point cloud, per-point colored coverage
spheres), exports it with `trimesh.viewer.scene_to_html`, and serves it on
http://:8000 with `/` rewritten to the scene file.

This environment has no trimesh, so the HTML is generated directly: the scene
is embedded as JSON and rendered by a small three.js program (CDN-loaded, as
trimesh's exporter also does). `visualize(...)` keeps the reference call
shape and its blocking serve-forever behavior (`serve=False` to just write
the file).
"""

from __future__ import annotations

import http.server
import json
import os

import numpy as np

__all__ = ["visualize", "scene_to_html", "serve_html"]

_TEMPLATE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>rfx scene</title>
<style>body {{ margin: 0; overflow: hidden; background: #1a1a1a; }}</style>
</head>
<body>
<script type="importmap">
{{ "imports": {{
  "three": "https://cdn.jsdelivr.net/npm/three@0.160.0/build/three.module.js",
  "three/addons/": "https://cdn.jsdelivr.net/npm/three@0.160.0/examples/jsm/"
}} }}
</script>
<script type="module">
import * as THREE from 'three';
import {{ OrbitControls }} from 'three/addons/controls/OrbitControls.js';

const SCENE = {scene_json};

const renderer = new THREE.WebGLRenderer({{ antialias: true }});
renderer.setSize(window.innerWidth, window.innerHeight);
document.body.appendChild(renderer.domElement);
const scene = new THREE.Scene();
scene.background = new THREE.Color(0x1a1a1a);
const camera = new THREE.PerspectiveCamera(60, window.innerWidth / window.innerHeight, 0.01, 1e5);
scene.add(new THREE.AmbientLight(0xffffff, 0.45));
const sun = new THREE.DirectionalLight(0xffffff, 1.0);
sun.position.set(1, 2, 3);
scene.add(sun);

// Environment mesh (gray, double-sided, z-up -> three.js y-up handled by rotating the root)
const root = new THREE.Group();
root.rotation.x = -Math.PI / 2;  // scene data is z-up
scene.add(root);

if (SCENE.mesh) {{
  const g = new THREE.BufferGeometry();
  g.setAttribute('position', new THREE.Float32BufferAttribute(SCENE.mesh.vertices.flat(), 3));
  g.setIndex(SCENE.mesh.faces.flat());
  g.computeVertexNormals();
  const m = new THREE.MeshStandardMaterial({{ color: 0x888888, side: THREE.DoubleSide, flatShading: true }});
  root.add(new THREE.Mesh(g, m));
}}

function addSphere(center, radius, color) {{
  const s = new THREE.Mesh(
    new THREE.SphereGeometry(radius, 16, 12),
    new THREE.MeshStandardMaterial({{ color: color }}));
  s.position.set(center[0], center[1], center[2]);
  root.add(s);
}}

if (SCENE.tx) addSphere(SCENE.tx, 0.25, 0xff0000);
if (SCENE.rx) addSphere(SCENE.rx, SCENE.rx_radius || 0.25, 0x00ff00);

// Ray path polylines (gray)
for (const path of SCENE.paths || []) {{
  const g = new THREE.BufferGeometry();
  g.setAttribute('position', new THREE.Float32BufferAttribute(path.flat(), 3));
  root.add(new THREE.Line(g, new THREE.LineBasicMaterial({{ color: 0xaaaaaa, transparent: true, opacity: 0.55 }})));
}}

// Plain point cloud (white)
if (SCENE.points && SCENE.points.length) {{
  const g = new THREE.BufferGeometry();
  g.setAttribute('position', new THREE.Float32BufferAttribute(SCENE.points.flat(), 3));
  root.add(new THREE.Points(g, new THREE.PointsMaterial({{ color: 0xffffff, size: 0.15 }})));
}}

// Colored coverage points (per-vertex color)
if (SCENE.colored_points && SCENE.colored_points.length) {{
  const g = new THREE.BufferGeometry();
  const pos = [], col = [];
  for (const [p, c] of SCENE.colored_points) {{ pos.push(...p); col.push(c[0]/255, c[1]/255, c[2]/255); }}
  g.setAttribute('position', new THREE.Float32BufferAttribute(pos, 3));
  g.setAttribute('color', new THREE.Float32BufferAttribute(col, 3));
  root.add(new THREE.Points(g, new THREE.PointsMaterial({{ vertexColors: true, size: 0.6 }})));
}}

// Frame the scene
const bbox = new THREE.Box3().setFromObject(root);
const center = bbox.getCenter(new THREE.Vector3());
const size = bbox.getSize(new THREE.Vector3()).length() || 10;
camera.position.copy(center).add(new THREE.Vector3(size * 0.6, size * 0.45, size * 0.6));
const controls = new OrbitControls(camera, renderer.domElement);
controls.target.copy(center);

window.addEventListener('resize', () => {{
  camera.aspect = window.innerWidth / window.innerHeight;
  camera.updateProjectionMatrix();
  renderer.setSize(window.innerWidth, window.innerHeight);
}});
renderer.setAnimationLoop(() => {{ controls.update(); renderer.render(scene, camera); }});
</script>
</body>
</html>
"""


def _tolist(x):
    return np.asarray(x, dtype=np.float64).round(5).tolist()


def scene_to_html(
    mesh=None,
    tx_pos=None,
    rx_pos=None,
    rx_radius: float = 0.25,
    paths=None,
    points=None,
    point_color_pairs=None,
    max_paths: int = 2000,
) -> str:
    """Build the standalone HTML for a scene. Inputs mirror the reference
    `visualize` signature (ref viz/visualization.py:6): TriangleMesh env,
    TX/RX positions, list of (k,3) path arrays, (M,3) points, and
    [(point, (r,g,b) 0-255 color), ...] coverage pairs."""
    payload = {}
    if mesh is not None:
        payload["mesh"] = {
            "vertices": _tolist(mesh.vertices),
            "faces": np.asarray(mesh.faces, dtype=np.int64).tolist(),
        }
    if tx_pos is not None:
        payload["tx"] = _tolist(tx_pos)
    if rx_pos is not None:
        payload["rx"] = _tolist(rx_pos)
        payload["rx_radius"] = float(rx_radius)
    if paths:
        payload["paths"] = [_tolist(p) for p in list(paths)[:max_paths]]
    if points is not None and len(points):
        payload["points"] = _tolist(points)
    if point_color_pairs:
        payload["colored_points"] = [
            [_tolist(p), [int(c[0]), int(c[1]), int(c[2])]] for p, c in point_color_pairs
        ]
    return _TEMPLATE.format(scene_json=json.dumps(payload))


def serve_html(path: str, port: int = 8000):
    """Blocking HTTP server with '/' rewritten to the scene file — the
    reference's serving behavior (ref viz/visualization.py:43-50)."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    fname = "/" + os.path.basename(path)

    class Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, directory=directory, **kwargs)

        def do_GET(self):  # noqa: N802 (stdlib API name)
            if self.path in ("", "/"):
                self.path = fname
            return super().do_GET()

    server = http.server.HTTPServer(("", port), Handler)
    print(f"serving {path} at http://localhost:{port}")
    server.serve_forever()


def visualize(
    mesh=None,
    tx_pos=None,
    rx_pos=None,
    paths=None,
    points=None,
    point_color_pairs=None,
    *,
    rx_radius: float = 0.25,
    out_path: str = "viz/scene.html",
    port: int = 8000,
    serve: bool = True,
):
    """Reference-parity entry (ref viz/visualization.py:6-50): write the
    three.js scene HTML and serve it (blocking). `serve=False` only writes."""
    html = scene_to_html(
        mesh=mesh,
        tx_pos=tx_pos,
        rx_pos=rx_pos,
        rx_radius=rx_radius,
        paths=paths,
        points=points,
        point_color_pairs=point_color_pairs,
    )
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(html)
    if serve:
        serve_html(out_path, port)
    return out_path
