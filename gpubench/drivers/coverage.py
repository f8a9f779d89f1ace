"""Coverage sweeps, closed loop, one caller: sweep k is the command line's
exact path, `Tracer.compute_coverage(tx, tx_power, grid, radius,
directions=set_k)` and then `Tracer.rx_power_dbm(irs, carrier)`, set_k the
pool's k mod 8. A sweep ends with every receiver's dBm on the host.

The check: every sweep of the window that took one of the check's direction
sets against the reference's dBm map for that set (the dBm's gap over the
receivers, the widest and the mean), and the IRs of the last such sweep
against the reference's (the pooled L1 gap, the widest over the receivers,
the gap of the sum, the widest and the mean, and the share of 10-bin blocks
that hold paths on one side only, the mean over the receivers),
and that sweep's dBm against the reference's dBm of its own IRs (the RX
power alone).

Faults for the check's tests: `half_batch` traces half of each sweep's rays
and scales by that half; `alter` doubles each answer's IRs where they are
produced.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench.drivers.common import Base, RefProgram
from gpubench.harness.compare import (Checks, dbm_gap, dbm_gap_mean, pooled_l1, sum_gap,
                                      sum_gap_mean, support_gap_mean)

__all__ = ["Cell"]


class _HalfBatch:
    def __init__(self, tracer):
        self.tracer = tracer
        tracer.tx_num_rays //= 2

    def compute_coverage(self, tx, tx_power, rx_centers, rx_radius, *, directions):
        return self.tracer.compute_coverage(tx, tx_power, rx_centers, rx_radius,
                                            directions=directions[: directions.shape[0] // 2])

    def rx_power_dbm(self, irs, carrier_hz):
        return self.tracer.rx_power_dbm(irs, carrier_hz)


class _Altered(_HalfBatch):
    def __init__(self, tracer):
        self.tracer = tracer

    def compute_coverage(self, tx, tx_power, rx_centers, rx_radius, *, directions):
        return self.tracer.compute_coverage(tx, tx_power, rx_centers, rx_radius,
                                            directions=directions) * 2.0


class Cell(Base):
    def setup(self):
        self.build_inputs()
        if self.program == "control":
            self.prog = RefProgram(self, torch.bfloat16)
        else:
            tracer = self.tracer()
            self.prog = {None: tracer, "half_batch": _HalfBatch, "alter": _Altered}[self.fault]
            if self.fault is not None:
                self.prog = self.prog(tracer)
        self.answers, self.kept = [], {}
        for k in range(int(self.spec.workload.get("warm_units", 2))):
            self.unit(k)
        self.answers, self.kept = [], {}

    def unit(self, k: int):
        i = self.schedule.set_of(k)
        irs = self.prog.compute_coverage(self.tx, self.tx_power, self.rx, self.radius,
                                         directions=self.pool[i])
        dbm = self.prog.rx_power_dbm(irs, self.carrier)
        if i in self.check_sets:
            self.answers.append((i, dbm))
            self.kept[i] = irs

    def end_to_end(self, *, latencies, done, seconds) -> dict:
        return {"sweep_ms": seconds / max(done, 1) * 1e3}

    def check(self) -> Checks:
        checks = Checks(self.check_spec["limits"])
        width = int(self.check_spec["pool_bins"])
        scene = self.ref_scene()
        live = []
        for i in sorted(self.check_sets):
            mine = [a for a in self.answers if a[0] == i]
            if not mine:
                continue
            segs = self.env(scene, i)
            live.append(sum(s["ray"].numel() for s in segs))
            irs, _ = self.ref_irs(segs, self.rx)
            dbm = self.ref_dbm(irs).cpu().numpy()
            irs = irs.cpu().numpy()
            for _, got in mine:
                checks.add("dbm_gap_db", dbm_gap(got, dbm))
                checks.add("dbm_gap_db_mean", dbm_gap_mean(got, dbm))
                checks.compared += 1
            own = self.ref_dbm(torch.as_tensor(self.kept[i], device=self.device).double())
            checks.add("kp_gap_db", dbm_gap(mine[-1][1], own.cpu().numpy()))
            checks.add("ir_pooled_l1", pooled_l1(self.kept[i], irs, width))
            checks.add("ir_support_gap_mean", support_gap_mean(self.kept[i], irs, width))
            checks.add("ir_sum_gap", sum_gap(self.kept[i], irs))
            checks.add("ir_sum_gap_mean", sum_gap_mean(self.kept[i], irs))
        if live:
            self._counts = {"live_segments": float(np.mean(live))}
        return checks
