"""What every driver's cell shares: its sizes (with the CPU rehearsal's in
place of the configuration's where `--device cpu`), the scene arrays from the
frozen builders, the direction pool and the receivers from the general
generator, and the reference in the port's place for `--program control`."""

from __future__ import annotations

import numpy as np
import torch

from gpubench.harness import inputs
from gpubench.reference import geometry
from gpubench.reference import trace as ref

__all__ = ["Base", "RefProgram"]


class Base:
    """A cell's inputs and sizes. `program` is 'port' or 'control'; `fault`
    names a break of the timed path that a driver plants for its tests."""

    def __init__(self, spec, *, seed: int, device: torch.device, program: str = "port",
                 fault: str | None = None):
        self.spec, self.seed, self.device = spec, int(seed), device
        self.program, self.fault = program, fault
        cfg = {**spec.config["physics"], "scene": spec.config["scene"]}
        traffic = dict(spec.traffic)
        if device.type == "cpu":  # the CPU rehearsal's sizes
            cpu = spec.workload.get("cpu_rehearsal", {})
            cfg.update(cpu.get("config", {}))
            traffic.update(cpu.get("traffic", {}))
        self.cfg, self.traffic = cfg, traffic
        self.check_spec = spec.workload["check"]
        self.rays = int(cfg["rays"])
        self.bounces = int(cfg["max_bounces"])
        self.nbins = int(cfg["nbins"])
        self.c, self.rate = float(cfg["light_speed_mps"]), float(cfg["sample_rate_hz"])
        self.window_s = float(cfg["sample_window_s"])
        if int(self.window_s * self.rate) != self.nbins:
            raise ValueError("nbins must be int(sample_window_s * sample_rate_hz)")
        self.n1, self.n2 = float(cfg["n1"]), float(cfg["n2"])
        self.tx = tuple(float(x) for x in traffic["tx"])
        self.tx_power = float(traffic["tx_power"])
        self.radius = float(traffic["rx_radius"])
        self.rx_mode = traffic.get("rx_mode", "analytic")
        self.carrier = float(traffic["carrier_hz"])

    def build_inputs(self):
        self.verts, self.faces = geometry.build_scene(self.cfg["scene"])
        self.rx = inputs.receivers(self.traffic["receivers"])
        self.schedule = inputs.Schedule(self.traffic, self.seed, self.rx.shape[0])
        self.pool = inputs.direction_pool(self.rays, self.schedule.sets, self.seed, self.device)
        self.check_sets = set(self.schedule.check_sets(self.seed, int(self.check_spec["sets"])))

    def ref_scene(self, dtype=torch.float64):
        return ref.RefScene(self.verts, self.faces, device=self.device, dtype=dtype,
                            columns=int(self.spec.config["reference_columns"]))

    def env(self, scene, i: int):
        return ref.env_trace(scene, self.tx, self.pool[i], bounces=self.bounces, n1=self.n1,
                             n2=self.n2)

    def ref_irs(self, segs, centers):
        """(IRs (M, nbins) in the segments' dtype, ray-bounces (M,)) of the receivers."""
        return ref.receiver_irs(segs, centers, self.radius, rx_mode=self.rx_mode,
                                scale=self.tx_power / self.rays, nbins=self.nbins,
                                light_speed_mps=self.c, sample_rate_hz=self.rate)

    def ref_dbm(self, irs):
        return ref.rx_power_dbm(irs, self.window_s, self.carrier)

    def mesh(self):
        from rfx_torch.geometry import TriangleMesh

        return TriangleMesh(self.verts, self.faces)

    def tracer(self):
        """The port's facade with the configuration's physics."""
        from rfx_torch.api import Tracer

        return Tracer(self.mesh(), self.c, self.rate, self.window_s, self.bounces, self.rays,
                      n1=self.n1, n2=self.n2, rx_mode=self.rx_mode, device=self.device)

    def shapes(self) -> dict:
        return {"rays": self.rays, "faces": int(self.faces.shape[0]), "nbins": self.nbins,
                "bounces": self.bounces, "receivers": int(self.rx.shape[0])}

    def counts(self) -> dict:
        return dict(getattr(self, "_counts", {}))

    def release(self):
        self.prog = None


class RefProgram:
    """The plain reference in the port's place, in `dtype` (the control): the
    facade's calls that the drivers make, with the environment traced once a
    direction set."""

    def __init__(self, cell: Base, dtype):
        self.cell, self.dtype = cell, dtype
        self.scene = cell.ref_scene(dtype)
        self._segs = {}

    def _env(self, directions):
        key = directions.data_ptr()
        if key not in self._segs:
            self._segs[key] = ref.env_trace(self.scene, self.cell.tx, directions,
                                            bounces=self.cell.bounces, n1=self.cell.n1,
                                            n2=self.cell.n2)
        return self._segs[key]

    def compute_cir(self, tx, tx_power, rx_pos, rx_radius, *, directions):
        irs, _ = self.cell.ref_irs(self._env(directions), np.asarray(rx_pos)[None])
        return [], irs[0].float().cpu().numpy()

    def compute_coverage(self, tx, tx_power, rx_centers, rx_radius, *, directions):
        irs, _ = self.cell.ref_irs(self._env(directions), rx_centers)
        return irs.float().cpu().numpy()

    def rx_power_dbm(self, impulse_response, carrier_hz: float = 2.4e9):
        ir = torch.as_tensor(np.asarray(impulse_response), device=self.cell.device).to(self.dtype)
        dbm = ref.rx_power_dbm(ir.reshape(-1, ir.shape[-1]), self.cell.window_s, carrier_hz)
        dbm = dbm.float().cpu().numpy()
        return dbm[0] if np.asarray(impulse_response).ndim == 1 else dbm
