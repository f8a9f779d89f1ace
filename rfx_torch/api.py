"""User-facing facade (port of rfx/api.py): the reference's `Tracer` call
shape, `Tracer(mesh, c, rate, window, max_bounces, n_rays)` then
`compute_cir(tx_pos, tx_power, rx_pos, rx_radius) -> (paths, ir)`,
`compute_coverage(...) -> (M, nbins)` and the coverage metrics
`compute_coverage_dbm_fast` / `compute_coverage_dbm_hybrid`, on an explicit
device.

Backends: `brute` (all-triangle Moller-Trumbore, rfx_torch.tracer), `fused`
and `bvh` (the plain stackless walk of rfx_torch.ops.bvh_traverse under the
scan tracer, on either device). `auto` takes `brute` up to 2048 triangles;
above that `fused` on a CUDA device and `bvh` on a CPU device, as the JAX
facade does (rfx/api.py:83-87): on a CPU both are plain PyTorch, and the
fused trace's plain version is brute force over all triangles. One
`compute_cir` request of 2,048 rays x 4 bounces on the 32,258-triangle bench
terrain, one CPU thread: `bvh` 0.10 s, `fused` 8.80 s, the same nonzero bins
(scripts/torch_bench_cpu_backends.py). The BVH comes
from `rfx_torch.bvh.build_bvh(method="auto")`: the native C++ builder for
large meshes. The fused backend builds one BVH and one
packing for two kernels: the fused bounce-loop kernel
(rfx_torch.ops.fused) answers `compute_cir` with the analytic receiver and
no recorded paths; the per-query BVH kernel (rfx_torch.ops.bvh_trace), under
the scan tracer, answers recorded paths, the icosphere receiver and
coverage, as rfx/api.py:222-244 does with its `pallas` backend.
"""

from __future__ import annotations

import numpy as np
import torch

from rfx_torch import cir as cir_mod
from rfx_torch import sampler
from rfx_torch.bvh import build_bvh
from rfx_torch.coverage import coverage_dbm_fast, coverage_dbm_hybrid, coverage_irs
from rfx_torch.device import resolve_device
from rfx_torch.geometry import TriangleMesh, as_mesh
from rfx_torch.ops.bvh_pack import pack_bvh
from rfx_torch.ops.bvh_trace import make_kernel_env_hit
from rfx_torch.ops.fused import FusedTracer
from rfx_torch.ops.intersect import make_env_intersector
from rfx_torch.tracer import Scene, extract_paths, trace_to_rx
from rfx_torch.utils.profiling import spanned, to_device, to_host

__all__ = ["Tracer", "auto_backend"]

BRUTE_MAX_FACES = 2048


def auto_backend(num_faces: int, device: torch.device) -> str:
    """The backend `Tracer(backend="auto")` takes for a mesh of `num_faces`
    triangles on `device` (see the module docstring)."""
    if num_faces <= BRUTE_MAX_FACES:
        return "brute"
    return "fused" if device.type == "cuda" else "bvh"


class Tracer:
    """RF ray tracer with the reference's call shape, on `device`."""

    #: record_paths="auto" records paths only for batches at or below this
    #: ray count (the JAX facade's bound, rfx/api.py:169).
    AUTO_PATHS_MAX_RAYS = 262_144

    def __init__(
        self,
        environment: TriangleMesh,
        light_speed_mps: float = 2.998e8,
        sample_rate_hz: float = 100e9,
        sample_window_s: float = 200.0e-9,
        max_bounces: int = 4,
        tx_num_rays: int = 5_000_000,
        *,
        n1: float = 5.0,
        n2: float = 1.0,
        rx_mode: str = "analytic",
        backend: str = "auto",
        seed: int = 0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        environment = as_mesh(environment)  # TypeError unless it has vertices and faces
        self.mesh = environment
        self.scene = Scene.from_mesh(environment, self.device)
        self.light_speed_mps = float(light_speed_mps)
        self.sample_rate_hz = float(sample_rate_hz)
        self.sample_window_s = float(sample_window_s)
        self.max_bounces = int(max_bounces)
        self.tx_num_rays = int(tx_num_rays)
        self.n1 = float(n1)
        self.n2 = float(n2)
        if rx_mode not in ("analytic", "icosphere"):
            raise ValueError(f"unknown rx_mode: {rx_mode}")
        self.rx_mode = rx_mode
        self.nbins = int(sample_window_s * sample_rate_hz)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

        if backend == "auto":
            backend = auto_backend(environment.num_faces, self.device)
        if backend not in ("brute", "fused", "bvh"):
            raise ValueError(f"unknown backend: {backend}")
        self.backend = backend
        self._fused = None
        if backend in ("brute", "bvh"):
            self.env_hit = make_env_intersector(backend, mesh=environment, device=self.device)
        else:
            flat = build_bvh(environment, leaf_size=8)
            if rx_mode == "analytic":
                # The fused kernel bakes in the analytic sphere; the
                # per-query kernel shares its packed tables.
                self._fused = FusedTracer(flat, max_bounces=self.max_bounces,
                                          device=self.device)
                bvh = self._fused.bvh
            else:
                bvh = pack_bvh(flat, self.device)
            self.env_hit = make_kernel_env_hit(bvh)

    def _directions(self, directions) -> torch.Tensor:
        if directions is None:
            return sampler.sphere_directions(self.tx_num_rays, generator=self.generator,
                                             device=self.device)
        return to_device("directions_to_device", directions, self.device)

    def _cir(self, result, tx_power) -> torch.Tensor:
        return cir_mod.cir_from_trace(
            result, tx_power=tx_power, num_rays=self.tx_num_rays, nbins=self.nbins,
            light_speed_mps=self.light_speed_mps, sample_rate_hz=self.sample_rate_hz)

    @spanned("rfx.api.compute_cir")
    def compute_cir(self, tx_pos, tx_power, rx_pos, rx_radius, *, directions=None,
                    record_paths="auto", max_paths: int = 10_000):
        """(paths, impulse_response) with the reference's semantics (ref
        tracer.py:63): a list of (k, 3) numpy paths and a numpy (nbins,) IR.

        `directions` is an optional (N, 3) array; by default tx_num_rays
        fresh directions come from this tracer's generator. record_paths
        "auto" records paths for batches of at most AUTO_PATHS_MAX_RAYS rays.
        The fused kernel answers only the analytic receiver without recorded
        paths; everything else runs the scan tracer on this tracer's
        `env_hit`."""
        dirs = self._directions(directions)
        if record_paths == "auto":
            record_paths = dirs.shape[0] <= self.AUTO_PATHS_MAX_RAYS
        if self._fused is not None and not record_paths:
            result = self._fused(dirs, tx_pos, rx_pos, rx_radius, n1=self.n1, n2=self.n2)
        else:
            result = trace_to_rx(self.scene, tx_pos, dirs, rx_pos, rx_radius,
                                 max_bounces=self.max_bounces, n1=self.n1, n2=self.n2,
                                 rx_mode=self.rx_mode, env_hit=self.env_hit,
                                 record_paths=bool(record_paths))
        ir = to_host("ir_to_host", self._cir(result, tx_power)).numpy()
        paths = (extract_paths(np.asarray(tx_pos, np.float32), result, max_paths)
                 if record_paths else [])
        return paths, ir

    @spanned("rfx.api.compute_coverage")
    def compute_coverage(self, tx_pos, tx_power, rx_centers, rx_radius, *, directions=None,
                         rx_batch: int = 64):
        """(M, nbins) numpy impulse responses for M receivers from one env
        trace (rfx/api.py:246-279) on this tracer's `env_hit` and rx_mode.
        The engine is 'auto': the coverage kernel on a CUDA device with the
        analytic receiver, the map engine otherwise (the icosphere receiver
        runs only there, on the card through the icosphere forms of the map
        capture kernels). Measured by `chip_smoke.py` phase 17 on an NVIDIA
        H100 80GB HBM3 (700 W), 2,048 receivers x 1,048,576 rays x 2 bounces
        x 10,000 bins: the icosphere sweep 53-72 ms on the room and 51-76 ms
        on the terrain, against 39-52 ms for the analytic receiver's; the
        plain composition it replaced took 4.1-4.3 s for 64 of those
        receivers.

        On a CUDA device IRs of at least `PINNED_MIN_BYTES` (1 MiB) come
        back in page-locked memory from PyTorch's caching host allocator
        (rfx_torch.utils.profiling): the array keeps its block until it is
        dropped, so a caller holds about one block of page-locked host RAM
        (the IRs' bytes rounded up to a power of two) for each IR array it
        keeps alive, and `rx_power_dbm` sends such an array back by DMA.
        The 1 MiB rule comes from crossovers measured on an H100 (see
        `PINNED_MIN_BYTES`): a cached block beats `.cpu()` from 32 KiB, a
        block made anew for each call from 1-4 MiB. The room sweep's 81.92 MB
        of IRs cross in 1.5 ms each way (53 GB/s), against 37 ms to the host
        and 14 ms back through pageable memory."""
        dirs = self._directions(directions)
        irs = coverage_irs(
            self.scene, tx_pos, dirs, rx_centers, rx_radius, max_bounces=self.max_bounces,
            nbins=self.nbins, num_rays=self.tx_num_rays, light_speed_mps=self.light_speed_mps,
            sample_rate_hz=self.sample_rate_hz, tx_power=tx_power, n1=self.n1, n2=self.n2,
            rx_batch=rx_batch, env_hit=self.env_hit, rx_mode=self.rx_mode)
        return to_host("irs_to_host", irs).numpy()

    def _coverage_kw(self, tx_power, carrier_hz, rx_batch) -> dict:
        return dict(max_bounces=self.max_bounces, num_rays=self.tx_num_rays,
                    sample_window_s=self.sample_window_s, sample_rate_hz=self.sample_rate_hz,
                    carrier_hz=carrier_hz, light_speed_mps=self.light_speed_mps,
                    tx_power=tx_power, n1=self.n1, n2=self.n2, rx_batch=rx_batch,
                    env_hit=self.env_hit)

    def compute_coverage_dbm_fast(self, tx_pos, tx_power, rx_centers, rx_radius, *,
                                  carrier_hz: float = 2.4e9, directions=None,
                                  rx_batch: int = 64):
        """(M,) numpy dBm per receiver through the phasor metric, with no
        per-receiver IR (rfx/api.py:281-306; see
        rfx_torch.coverage.coverage_dbm_fast for its accuracy)."""
        dbm = coverage_dbm_fast(self.scene, tx_pos, self._directions(directions), rx_centers,
                                rx_radius, **self._coverage_kw(tx_power, carrier_hz, rx_batch))
        return dbm.cpu().numpy()

    def compute_coverage_dbm_hybrid(self, tx_pos, tx_power, rx_centers, rx_radius, *,
                                    carrier_hz: float = 2.4e9, directions=None,
                                    rx_batch: int = 64, cancel_threshold: float = 0.5,
                                    spread_threshold_s: float = 10e-9,
                                    exact_fallback_frac: float = 0.15):
        """((M,) numpy dBm, n_flagged): the phasor metric with the exact one
        for the receivers it flags, or for all of them when more than
        `exact_fallback_frac` are flagged (rfx/api.py:308-345; see
        rfx_torch.coverage.coverage_dbm_hybrid)."""
        dbm, n_flagged = coverage_dbm_hybrid(
            self.scene, tx_pos, self._directions(directions), rx_centers, rx_radius,
            cancel_threshold=cancel_threshold, spread_threshold_s=spread_threshold_s,
            exact_fallback_frac=exact_fallback_frac,
            **self._coverage_kw(tx_power, carrier_hz, rx_batch))
        return dbm.cpu().numpy(), n_flagged

    @spanned("rfx.api.rx_power_dbm")
    def rx_power_dbm(self, impulse_response, carrier_hz: float = 2.4e9):
        """Reference RX-power metric (ref main.py:46-55), as numpy."""
        ir = to_device("ir_to_device", impulse_response, self.device)
        dbm, _ = cir_mod.rx_power_dbm(ir, self.sample_window_s, carrier_hz)
        return to_host("dbm_to_host", dbm).numpy()
