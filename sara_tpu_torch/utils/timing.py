"""Timers (twin of ``sara_tpu/utils/timing.py``).

``Timer`` and ``TicToc`` are host wall clocks, as in the twin. A host clock
around work on the card measures the launches, not the work, unless the
caller synchronizes; ``EventTimer`` times the card's own stream with CUDA
events instead, and ``median_ms`` times repeated calls so. ``device_trace``
wraps ``torch.profiler`` (the twin wraps ``jax.profiler``) and stays a
no-op, with a warning, where no profiler can start. ``count_syncs`` counts
the host syncs of one call on the card.
"""

from __future__ import annotations

import statistics
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


def median_ms(fn, device, reps: int = 5):
    """``(result, ms, first_s)``: the result of the last of ``reps`` calls
    of ``fn`` after one warm-up call, their median time in ms and the
    warm-up call's seconds. On a CUDA ``device`` each call is timed by a
    pair of CUDA events recorded after a synchronize; on the CPU by the
    host clock."""
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        if on_card:
            timer = EventTimer().start()
            out = fn()
            times.append(timer.stop().elapsed_ms())
        else:
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return out, float(statistics.median(times)), first_s


def count_syncs(fn) -> dict:
    """The host syncs PyTorch reports in one call of ``fn`` on the card
    (``torch.cuda.set_sync_debug_mode("warn")``): their count and the
    source lines (file:line) that made them."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # The notice that the debug mode is a prototype (emitted once per
    # process, by set_sync_debug_mode itself) is not a sync.
    where = [f"{w.filename.split('/')[-1]}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)
             and "prototype" not in str(w.message)]
    return {"syncs": len(where),
            "at": {k: where.count(k) for k in sorted(set(where))}}


class device_trace:
    """Context manager around a ``torch.profiler`` trace of the CPU and, where
    there is a card, CUDA activity, exported as a Chrome trace
    ``trace.json`` under ``logdir``; ``averages`` then holds the trace's
    ``key_averages()``. A no-op (with a warning, ``averages`` None) where
    the profiler cannot start."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self._prof = None
        self.averages = None

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
                self.averages = self._prof.key_averages()
                os.makedirs(self.logdir, exist_ok=True)
                self._prof.export_chrome_trace(
                    os.path.join(self.logdir, "trace.json"))
            except Exception:
                pass
        return False
