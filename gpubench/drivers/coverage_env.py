"""Exact coverage sweeps whose check also reads the environment trace: the
`coverage` driver's units and check, and besides, once the window has
ended, the port's own environment trace of each check set's rays on the
timed tracer's intersector (`rfx_torch.tracer.trace_env` on
`Tracer.env_hit`, as `compute_coverage` runs it, at full size) against the
plain reference's `env_trace` of the same rays, which the check computes
anyway. Where every path inside the window is direct, the IRs cannot see
the environment trace: a closest hit that misses everywhere, names the wrong
face or returns a t beyond the receivers leaves them as they are.

The environment's numbers; a segment is a ray live at a bounce:
- `env_live_gap`: the segments that one side alone traces, over the
  reference's segments (the widest over the check sets);
- `env_hit_gap`: of the segments both sides trace, the share that hits on
  one side and escapes on the other (the widest);
- `env_face_gap`: of the segments that hit on both sides, the share whose
  face differs (the widest);
- `env_t_gap_mean`: of those with the same face, the mean of
  |t - t_ref| / t_ref (the mean over the check sets).

Under `--program control` the control's own environment trace (the
reference in bfloat16) stands in for the port's. Faults for the check's
tests: the `coverage` driver's, and `env_miss`, which makes the timed
tracer's closest hit miss everywhere.
"""

from __future__ import annotations

import torch

from gpubench.drivers import coverage
from gpubench.harness.compare import Checks

__all__ = ["Cell", "env_gaps", "port_env", "ref_env"]


class _Faces:
    """The tracer's closest hit, keeping each call's faces."""

    def __init__(self, env_hit):
        self.env_hit, self.faces = env_hit, []

    def __call__(self, o, d, v0, e1, e2):
        t, face, nrm = self.env_hit(o, d, v0, e1, e2)
        self.faces.append(face)
        return t, face, nrm


def _missing(env_hit):
    def env_hit_missing(o, d, v0, e1, e2):
        t, face, nrm = env_hit(o, d, v0, e1, e2)
        return torch.full_like(t, float("inf")), torch.full_like(face, -1), torch.zeros_like(nrm)

    return env_hit_missing


def _dense(segs: list[dict], n: int, bounces: int, device) -> tuple[torch.Tensor, ...]:
    """(live, hit, face, t), each (bounces, n), from one entry a bounce of
    the live rays' `ray`, `hit`, `face` and `t`."""
    live = torch.zeros(bounces, n, dtype=torch.bool, device=device)
    hit = torch.zeros_like(live)
    face = torch.full((bounces, n), -1, dtype=torch.long, device=device)
    t = torch.full((bounces, n), float("inf"), dtype=torch.float64, device=device)
    for b, s in enumerate(segs[:bounces]):
        ray = s["ray"].to(device)
        live[b, ray] = True
        hit[b, ray] = s["hit"].to(device, torch.bool)
        face[b, ray] = s["face"].to(device, torch.long)
        t[b, ray] = s["t"].to(device, torch.float64)
    return live, hit, face, t


def env_gaps(port: list[dict], ref: list[dict], n: int, bounces: int) -> dict:
    """The four environment numbers of one set of `n` rays (see the module's
    docstring); each side a list, one entry a bounce, of its live rays'
    `ray` ids, `hit`, `face` and `t`."""
    device = ref[0]["ray"].device if ref else torch.device("cpu")
    lp, hp, fp, tp = _dense(port, n, bounces, device)
    lr, hr, fr, tr = _dense(ref, n, bounces, device)
    both = lp & lr
    hits = both & hp & hr
    same = hits & (fp == fr)

    def share(num, den):
        num, den = int(num), int(den)
        return num / den if den else (float("inf") if num else 0.0)

    rel = ((tp - tr).abs() / tr)[same]
    return {"env_live_gap": share((lp ^ lr).sum(), lr.sum()),
            "env_hit_gap": share((both & (hp ^ hr)).sum(), both.sum()),
            "env_face_gap": share((hits & (fp != fr)).sum(), hits.sum()),
            "env_t_gap_mean": float(rel.mean()) if rel.numel() else 0.0}


def port_env(tracer, tx, directions, *, bounces: int, n1: float, n2: float) -> list[dict]:
    """The environment trace that the facade's `compute_coverage` runs, on
    the tracer's own closest hit: one entry a bounce of the live rays' `ray`
    ids, `hit`, `face` and `t`."""
    from rfx_torch.ops.intersect import is_hit
    from rfx_torch.tracer import trace_env

    faces = _Faces(tracer.env_hit)
    segs = trace_env(tracer.scene, tx, directions, max_bounces=bounces, n1=n1, n2=n2,
                     env_hit=faces)
    out = []
    for b in range(segs.alive.shape[0]):
        ray = torch.nonzero(segs.alive[b]).flatten()
        t = segs.t_env[b, ray]
        out.append(dict(ray=ray, hit=is_hit(t), face=faces.faces[b][ray], t=t))
    return out


def ref_env(segs: list[dict]) -> list[dict]:
    """The reference's `env_trace` in `port_env`'s form."""
    return [dict(ray=s["ray"], hit=s["face"] >= 0, face=s["face"], t=s["t_env"]) for s in segs]


class Cell(coverage.Cell):
    def setup(self):
        self._env_ref, self._env_port = {}, {}
        self.env_miss = self.fault == "env_miss"
        if self.env_miss:
            self.fault = None  # the timed tracer itself carries this one
        super().setup()

    def tracer(self):
        tracer = super().tracer()
        if self.env_miss:
            tracer.env_hit = _missing(tracer.env_hit)
        return tracer

    def release(self):
        """The port's environment trace of each check set that the window
        answered, on the timed tracer, before the tracer goes."""
        for i in sorted(self.kept):
            self._env_port[i] = self._port_env(i)
        super().release()

    def _port_env(self, i: int) -> list[dict]:
        if self.program == "control":
            return ref_env(self.prog._env(self.pool[i]))
        return port_env(getattr(self.prog, "tracer", self.prog), self.tx, self.pool[i],
                        bounces=self.bounces, n1=self.n1, n2=self.n2)

    def env(self, scene, i: int):
        segs = super().env(scene, i)
        self._env_ref[i] = ref_env(segs)
        return segs

    def check(self) -> Checks:
        checks = super().check()
        for i in sorted(self._env_ref):
            if i in self._env_port:
                gaps = env_gaps(self._env_port[i], self._env_ref[i], self.rays, self.bounces)
                for name, value in gaps.items():
                    checks.add(name, value)
        return checks
