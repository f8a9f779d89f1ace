"""The comparisons that decide `correct`: each number a widest gap between
what the timed path answered and what the plain reference computes on the
same inputs, held against its limit from the workload file."""

from __future__ import annotations

import math

import numpy as np

__all__ = ["dbm_gap", "dbm_gap_mean", "pooled_l1", "sum_gap", "sum_gap_mean", "support_gap_mean",
           "Checks"]


def _dbm_gaps(port, ref) -> np.ndarray:
    """|port - ref| in dB of each entry; 0 where both are -inf, inf where
    only one is (or where the port's is NaN)."""
    p = np.asarray(port, np.float64).ravel()
    r = np.asarray(ref, np.float64).ravel()
    both = np.isneginf(p) & np.isneginf(r)
    with np.errstate(invalid="ignore"):
        gap = np.where(both, 0.0, np.abs(p - r))
    return np.where(np.isnan(gap) & ~both, np.inf, gap)


def dbm_gap(port, ref) -> float:
    """The largest of the entries' dB gaps."""
    gap = _dbm_gaps(port, ref)
    return float(gap.max()) if gap.size else 0.0


def dbm_gap_mean(port, ref) -> float:
    """The mean of the entries' dB gaps."""
    gap = _dbm_gaps(port, ref)
    return float(gap.mean()) if gap.size else 0.0


def _pool(x: np.ndarray, width: int) -> np.ndarray:
    x = np.asarray(x, np.float64)
    pad = (-x.shape[-1]) % width
    x = np.concatenate([x, np.zeros(x.shape[:-1] + (pad,))], axis=-1)
    return x.reshape(x.shape[:-1] + (-1, width)).sum(-1)


def pooled_l1(port, ref, width: int) -> float:
    """Largest relative L1 gap of rows of IRs summed over blocks of `width`
    bins (so that a path whose delay rounds into the neighbouring bin moves
    the number only at a block's edge): sum |P - R| / sum |R| per row, 0 where
    both rows are empty, inf where only the reference's is."""
    p, r = _pool(np.atleast_2d(port), width), _pool(np.atleast_2d(ref), width)
    num = np.abs(p - r).sum(-1)
    den = np.abs(r).sum(-1)
    out = np.where(den > 0, num / np.where(den > 0, den, 1.0), np.where(num > 0, np.inf, 0.0))
    return float(out.max()) if out.size else 0.0


def support_gap_mean(port, ref, width: int) -> float:
    """The mean over rows of IRs of 1 - |S_P & S_R| / |S_P | S_R|, S the
    blocks of `width` bins that hold a nonzero bin: 0 where the answer's
    paths arrive in the reference's blocks, 1 where none does (a row empty
    on both sides reads 0)."""
    p, r = _pool(np.abs(np.atleast_2d(port)), width) > 0, _pool(np.abs(np.atleast_2d(ref)), width) > 0
    union = (p | r).sum(-1)
    out = np.where(union > 0, 1.0 - (p & r).sum(-1) / np.maximum(union, 1), 0.0)
    return float(out.mean()) if out.size else 0.0


def _sum_gaps(port, ref) -> np.ndarray:
    """|sum P - sum R| / |sum R| of each row of IRs (the captured amplitude
    in total, which no rounding of a delay moves); inf where only the
    reference's row is empty."""
    p, r = np.atleast_2d(np.asarray(port, np.float64)), np.atleast_2d(np.asarray(ref, np.float64))
    sp, sr = p.sum(-1), r.sum(-1)
    return np.where(sr != 0, np.abs(sp - sr) / np.where(sr != 0, np.abs(sr), 1.0),
                    np.where(sp != 0, np.inf, 0.0))


def sum_gap(port, ref) -> float:
    out = _sum_gaps(port, ref)
    return float(out.max()) if out.size else 0.0


def sum_gap_mean(port, ref) -> float:
    out = _sum_gaps(port, ref)
    return float(out.mean()) if out.size else 0.0


class Checks:
    """Numbers compared, each with its limit: a name ending in `_mean` is the
    mean over what was compared, any other the widest."""

    def __init__(self, limits: dict):
        self.limits = {k: float(v) for k, v in limits.items()}
        self._max = {k: 0.0 for k in self.limits}
        self._sum = {k: [0.0, 0] for k in self.limits}
        self.compared = 0

    def add(self, name: str, value: float):
        """Fold one reading into `name`; a number the cell sets no limit for
        is not compared."""
        if name not in self.limits:
            return
        v = float(value)
        if math.isnan(v):
            v = math.inf
        self._max[name] = max(self._max[name], v)
        self._sum[name][0] += v
        self._sum[name][1] += 1

    @property
    def values(self) -> dict:
        return {k: (self._sum[k][0] / max(self._sum[k][1], 1) if k.endswith("_mean")
                    else self._max[k]) for k in self.limits}

    def ok(self) -> bool:
        values = self.values
        return self.compared > 0 and all(values[k] <= self.limits[k] for k in self.limits)

    def report(self) -> dict:
        values = self.values
        out = {k: {"value": values[k], "limit": self.limits[k]} for k in self.limits}
        out["compared"] = {"value": self.compared, "limit": 1}
        return out
