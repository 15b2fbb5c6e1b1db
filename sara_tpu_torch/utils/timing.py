"""Timers (twin of ``sara_tpu/utils/timing.py``).

``Timer`` and ``TicToc`` are host wall clocks, as in the twin. A host clock
around work on the card measures the launches, not the work, unless the
caller synchronizes; ``EventTimer`` times the card's own stream with CUDA
events instead. ``device_trace`` wraps ``torch.profiler`` (the twin wraps
``jax.profiler``) and stays a no-op, with a warning, where no profiler can
start.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch


class Timer:
    def __init__(self):
        self.restart()

    def restart(self):
        self._start = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._start

    def elapsed_ms(self) -> float:
        return 1e3 * self.elapsed()


class TicToc:
    """Named tic/toc accumulator for per-stage pipeline timings."""

    def __init__(self):
        self._t0 = {}
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    def tic(self, name: str = "default"):
        self._t0[name] = time.perf_counter()

    def toc(self, name: str = "default") -> float:
        dt = time.perf_counter() - self._t0[name]
        self.totals[name] += dt
        self.counts[name] += 1
        return dt * 1e3

    def report(self) -> str:
        lines = []
        for k in sorted(self.totals):
            n = self.counts[k]
            lines.append(f"{k}: total {self.totals[k]*1e3:.1f} ms, "
                         f"n={n}, avg {self.totals[k]/max(n,1)*1e3:.2f} ms")
        return "\n".join(lines)


class EventTimer:
    """Device time of the work queued between ``start()`` and ``stop()`` on
    the current CUDA stream, from a pair of CUDA events. ``elapsed_ms()``
    waits for the second event."""

    def __init__(self):
        self._begin = torch.cuda.Event(enable_timing=True)
        self._end = torch.cuda.Event(enable_timing=True)

    def start(self):
        self._begin.record()
        return self

    def stop(self):
        self._end.record()
        return self

    def elapsed_ms(self) -> float:
        self._end.synchronize()
        return float(self._begin.elapsed_time(self._end))


class device_trace:
    """Context manager around a ``torch.profiler`` trace of the CPU and, where
    there is a card, CUDA activity, exported as a Chrome trace
    ``trace.json`` under ``logdir``. A no-op (with a warning) where the
    profiler cannot start."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self._prof = None

    def __enter__(self):
        try:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        except Exception as e:  # pragma: no cover - platform dependent
            import logging

            self._prof = None
            logging.getLogger("sara_tpu_torch").warning(
                "trace unavailable: %s", e)
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            try:
                import os

                self._prof.__exit__(None, None, None)
                os.makedirs(self.logdir, exist_ok=True)
                self._prof.export_chrome_trace(
                    os.path.join(self.logdir, "trace.json"))
            except Exception:
                pass
        return False
