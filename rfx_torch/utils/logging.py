"""Structured logging (the port's own copy of rfx/utils/logging.py, with
`rfx_torch` as the root logger's name).

The reference instruments with bare print()s, including three per bounce per
path inside the hot Fresnel routine (ref tracer.py:41,46,59 — SURVEY.md 5
flags this as the dominant host cost). Here: standard logging, and nothing on
the hot path; a request's own measurements are the spans and counters of
rfx_torch.utils.profiling.
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

