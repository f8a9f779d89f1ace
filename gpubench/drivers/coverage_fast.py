"""Fast coverage sweeps, closed loop, one caller: sweep k is the command
line's `--metric fast` path, `Tracer.compute_coverage_dbm_fast(tx, tx_power,
grid, radius, carrier_hz=carrier, directions=set_k)`, set_k the pool's k mod
8. A sweep ends with every receiver's dBm on the host; no IR is formed.

The check: every sweep of the window that took one of the check's direction
sets against the plain reference's phasor dBm for that set
(`reference/phasor.py` on `reference/trace.py`'s environment trace and first
captures): the dBm's gap over the receivers, the widest and the mean.

Faults for the check's tests: `half_batch` traces half of each sweep's rays
and scales by that half; `alter` doubles each answer's amplitudes where the
answer is produced (its dBm plus 20 log10 2).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpubench.drivers.common import Base, RefProgram
from gpubench.harness.compare import Checks, dbm_gap, dbm_gap_mean
from gpubench.reference import phasor

__all__ = ["Cell"]


class _HalfBatch:
    def __init__(self, tracer):
        self.tracer = tracer
        tracer.tx_num_rays //= 2

    def compute_coverage_dbm_fast(self, tx, tx_power, rx_centers, rx_radius, *, carrier_hz,
                                  directions):
        return self.tracer.compute_coverage_dbm_fast(
            tx, tx_power, rx_centers, rx_radius, carrier_hz=carrier_hz,
            directions=directions[: directions.shape[0] // 2])


class _Altered:
    def __init__(self, tracer):
        self.tracer = tracer

    def compute_coverage_dbm_fast(self, *args, **kwargs):
        return self.tracer.compute_coverage_dbm_fast(*args, **kwargs) + 20.0 * math.log10(2.0)


class _Control(RefProgram):
    """The plain reference in `dtype` in the port's place, the environment
    traced once a direction set."""

    def compute_coverage_dbm_fast(self, tx, tx_power, rx_centers, rx_radius, *, carrier_hz,
                                  directions):
        dbm = self.cell.ref_dbm_fast(self._env(directions), rx_centers, carrier_hz)
        return dbm.float().cpu().numpy()


class Cell(Base):
    def setup(self):
        self.build_inputs()
        if self.program == "control":
            self.prog = _Control(self, torch.bfloat16)
        else:
            tracer = self.tracer()
            self.prog = {None: tracer, "half_batch": _HalfBatch, "alter": _Altered}[self.fault]
            if self.fault is not None:
                self.prog = self.prog(tracer)
        self.answers = []
        for k in range(int(self.spec.workload.get("warm_units", 2))):
            self.unit(k)
        self.answers = []

    def unit(self, k: int):
        i = self.schedule.set_of(k)
        dbm = self.prog.compute_coverage_dbm_fast(self.tx, self.tx_power, self.rx, self.radius,
                                                  carrier_hz=self.carrier,
                                                  directions=self.pool[i])
        if i in self.check_sets:
            self.answers.append((i, dbm))

    def ref_dbm_fast(self, segs, centers, carrier_hz: float) -> torch.Tensor:
        """(M,) float64 dBm of the receivers through the reference's phasor identity."""
        return phasor.receiver_phasor_dbm(
            segs, centers, self.radius, scale=self.tx_power / self.rays, nbins=self.nbins,
            light_speed_mps=self.c, sample_rate_hz=self.rate, sample_window_s=self.window_s,
            carrier_hz=carrier_hz)

    def end_to_end(self, *, latencies, done, seconds) -> dict:
        return {"sweep_ms": seconds / max(done, 1) * 1e3}

    def check(self) -> Checks:
        checks = Checks(self.check_spec["limits"])
        scene = self.ref_scene()
        live = []
        for i in sorted(self.check_sets):
            mine = [dbm for j, dbm in self.answers if j == i]
            if not mine:
                continue
            segs = self.env(scene, i)
            live.append(sum(s["ray"].numel() for s in segs))
            want = self.ref_dbm_fast(segs, self.rx, self.carrier).cpu().numpy()
            for got in mine:
                checks.add("dbm_gap_db", dbm_gap(got, want))
                checks.add("dbm_gap_db_mean", dbm_gap_mean(got, want))
                checks.compared += 1
        if live:
            self._counts = {"live_segments": float(np.mean(live))}
        return checks
