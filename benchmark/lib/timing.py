"""Clocks of the benchmark: host spans, CUDA-event spans and sync counts.

The arithmetic is the port's ``utils/timing.py`` (``EventTimer``,
``count_syncs``), copied here so that the yardstick does not move with the
program. Host spans (``Spans``) are kept in memory and read once the run
has ended; their names also label the device's idle gaps in a trace.
"""

from __future__ import annotations

import time
import warnings
from collections import defaultdict
from contextlib import contextmanager

import torch


class Spans:
    """Named host-clock spans (seconds since ``t0``) and CUDA-event spans
    (read after the run). ``on`` False records nothing: the untraced run
    keeps only the clocks its end-to-end metrics need."""

    def __init__(self, on: bool):
        self.on = on
        self.t0 = time.perf_counter()
        self.host = []                      # (name, start_s, end_s)
        self._events = defaultdict(list)    # name -> [(start, end, units)]

    @contextmanager
    def host_span(self, name: str):
        if not self.on:
            yield
            return
        a = time.perf_counter() - self.t0
        try:
            yield
        finally:
            self.host.append((name, a, time.perf_counter() - self.t0))

    @contextmanager
    def device_span(self, name: str, units: float = 1.0):
        """CUDA events around the work queued inside the block on the
        current stream, over ``units`` (frames, pairs, iterations)."""
        if not self.on:
            yield
            return
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        try:
            yield
        finally:
            b.record()
            self._events[name].append((a, b, units))

    def device_ms(self, name: str):
        """(total device ms, total units) of the named event spans."""
        pairs = self._events.get(name, [])
        if not pairs:
            return None, 0.0
        torch.cuda.synchronize()
        ms = sum(float(a.elapsed_time(b)) for a, b, _ in pairs)
        return ms, sum(u for _, _, u in pairs)

    def host_s(self, name: str):
        """(total seconds, count) of the named host spans."""
        d = [b - a for n, a, b in self.host if n == name]
        return (sum(d), len(d)) if d else (None, 0)


def count_syncs(fn) -> int:
    """The host syncs PyTorch reports in one call of ``fn`` on the card
    (``torch.cuda.set_sync_debug_mode("warn")``)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # The notice that the debug mode is a prototype is not a sync.
    return sum(1 for w in caught if "synchroniz" in str(w.message)
               and "prototype" not in str(w.message))
