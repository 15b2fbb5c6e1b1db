"""Structured logging.

Twin of ``sara_tpu/utils/log.py``, a rebuild of the reference's logging
layer (reference: cpp/src/DO/Sara/Logging/Logger.hpp:15-60 — Boost.Log
severity logger with source-location attributes, SARA_LOG{T,D,I,W,E}
macros) on top of the stdlib logging module. The port's root logger is
``sara_tpu_torch``; its level comes from ``SARA_TPU_LOG`` (default INFO),
the reference's variable.
"""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "[%(levelname).1s %(asctime)s %(name)s %(filename)s:%(lineno)d] %(message)s"
_configured = False


def get_logger(name: str = "sara_tpu_torch") -> logging.Logger:
    global _configured
    if not _configured:
        level = os.environ.get("SARA_TPU_LOG", "INFO").upper()
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        root = logging.getLogger("sara_tpu_torch")
        root.addHandler(h)
        root.setLevel(level)
        root.propagate = False
        _configured = True
    return logging.getLogger(name)
