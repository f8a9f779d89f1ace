"""Structured logging + metrics (the port's own copy of rfx/utils/logging.py,
with `rfx_torch` as the root logger's name).

The reference instruments with bare print()s, including three per bounce per
path inside the hot Fresnel routine (ref tracer.py:41,46,59 — SURVEY.md 5
flags this as the dominant host cost). Here: standard logging with a metrics
helper that reports rays/s as a first-class scalar, and nothing on the hot
path.
"""

from __future__ import annotations

import logging
import os
import sys

_CONFIGURED = False


def get_logger(name: str = "rfx_torch") -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        level = os.environ.get("RFX_LOG_LEVEL", "INFO").upper()
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s", "%H:%M:%S")
        )
        root = logging.getLogger("rfx_torch")
        root.addHandler(handler)
        root.setLevel(level)
        root.propagate = False
        _CONFIGURED = True
    return logging.getLogger(name)


def log_trace_stats(log: logging.Logger, *, n_rays: int, bounces: int, captured: int, seconds: float):
    mrays = n_rays / max(seconds, 1e-12) / 1e6
    log.info(
        "trace n_rays=%d bounces=%d captured=%d seconds=%.4f Mrays/s=%.2f",
        n_rays, bounces, captured, seconds, mrays,
    )
