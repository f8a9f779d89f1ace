"""CIR requests, closed loop, one caller: request k is the reference's
`main.py` call, `Tracer.compute_cir(tx, tx_power, rx_k, radius,
directions=set_k)` and then `Tracer.rx_power_dbm(ir, carrier)`, with set_k the
pool's k mod 8 and rx_k the receivers in the seed's order. A request ends with
its IR and dBm on the host.

The check covers the requests of the window that took one of the check's
direction sets (drawn from the seed). The dBm of every such request is held
against the reference's dBm for its set and receiver: the gap, the widest
and the mean over the requests. The IR of the last such request of each
(set, receiver) pair is held against the reference's IR: the gap of its sum,
the widest and the mean over the pairs, its pooled L1 gap, the widest, and
the share of its 10-bin blocks that hold paths on one side only, the mean;
and, where the workload sets a limit for it, the gap between that request's
dBm and the reference's dBm of its own IR, which holds the RX power alone to
the rounding of its carrier. A number without a limit is not compared. The
window keeps one IR a pair, not one a request, so that what it holds does
not grow with the requests it serves.

Faults for the check's tests: `half_batch` traces half of each request's
rays and scales by that half (the mean over the rest); `alter` doubles each
answer's IR where it is produced.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench.drivers.common import Base, RefProgram
from gpubench.harness.compare import Checks, dbm_gap, pooled_l1, sum_gap, support_gap_mean

__all__ = ["Cell"]


class _HalfBatch:
    def __init__(self, tracer):
        self.tracer = tracer
        tracer.tx_num_rays //= 2

    def compute_cir(self, tx, tx_power, rx_pos, rx_radius, *, directions):
        return self.tracer.compute_cir(tx, tx_power, rx_pos, rx_radius,
                                       directions=directions[: directions.shape[0] // 2])

    def rx_power_dbm(self, ir, carrier_hz):
        return self.tracer.rx_power_dbm(ir, carrier_hz)


class _Altered(_HalfBatch):
    def __init__(self, tracer):
        self.tracer = tracer

    def compute_cir(self, tx, tx_power, rx_pos, rx_radius, *, directions):
        paths, ir = self.tracer.compute_cir(tx, tx_power, rx_pos, rx_radius, directions=directions)
        return paths, ir * 2.0


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
        for k in range(int(self.spec.workload.get("warm_units", 3))):
            self.unit(k)
        self.answers, self.kept = [], {}

    def unit(self, k: int):
        i, j = self.schedule.set_of(k), self.schedule.rx_of(k)
        _, ir = self.prog.compute_cir(self.tx, self.tx_power, tuple(self.rx[j]), self.radius,
                                      directions=self.pool[i])
        dbm = self.prog.rx_power_dbm(ir, self.carrier)
        if i in self.check_sets:
            self.answers.append((i, j, dbm))
            self.kept[i, j] = (ir, dbm)

    def end_to_end(self, *, latencies, done, seconds) -> dict:
        return {"cir_mrays_s": done * self.rays / seconds / 1e6,
                "cir_p95_ms": float(np.percentile(np.asarray(latencies) * 1e3, 95))}

    def check(self) -> Checks:
        checks = Checks(self.check_spec["limits"])
        width = int(self.check_spec["pool_bins"])
        scene = self.ref_scene()
        traced = []
        for i in sorted(self.check_sets):
            js = sorted(j for s, j in self.kept if s == i)
            if not js:
                continue
            irs, bounces = self.ref_irs(self.env(scene, i), self.rx[js])
            dbm = self.ref_dbm(irs).cpu().numpy()
            irs = irs.cpu().numpy()
            traced.append(bounces.double().mean().item())
            row = {j: r for r, j in enumerate(js)}
            for _, j, got in (a for a in self.answers if a[0] == i):
                gap = dbm_gap(got, dbm[row[j]])
                checks.add("dbm_gap_db", gap)
                checks.add("dbm_gap_db_mean", gap)
                checks.compared += 1
            mine = [self.kept[i, j] for j in js]
            own = self.ref_dbm(torch.as_tensor(np.stack([ir for ir, _ in mine]), device=self.device)
                               .double()).cpu().numpy()
            for r, ((ir, got), got_ref) in enumerate(zip(mine, own)):
                checks.add("kp_gap_db", dbm_gap(got, got_ref))
                checks.add("ir_pooled_l1", pooled_l1(ir, irs[r], width))
                checks.add("ir_support_gap_mean", support_gap_mean(ir, irs[r], width))
                checks.add("ir_sum_gap", sum_gap(ir, irs[r]))
                checks.add("ir_sum_gap_mean", sum_gap(ir, irs[r]))
        if traced:
            self._counts = {"ray_bounces": float(np.mean(traced))}
        return checks
