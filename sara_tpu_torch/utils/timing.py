"""Timers (twin of ``sara_tpu/utils/timing.py``).

``Timer`` and ``TicToc`` are host wall clocks, as in the twin. A host clock
around work on the card measures the launches, not the work, unless the
caller synchronizes; ``EventTimer`` times the card's own stream with CUDA
events instead, and ``median_ms`` times repeated calls so. ``device_trace``
wraps ``torch.profiler`` (the twin wraps ``jax.profiler``) and stays a
no-op, with a warning, where no profiler can start. ``count_syncs`` counts
the host syncs of one call on the card.

``trace`` records the port's own stages (spans) and counts (counters)
where the work happens: the SIFT frontend, the matcher and the PCG bundle
adjuster call it. It keeps something only while a ``torch.profiler``
session collects, and is off otherwise; ``device_trace`` writes its
summary, and the device's idle gaps named by its spans, to ``spans.json``.
"""

from __future__ import annotations

import itertools
import json
import os
import statistics
import threading
import time
from collections import defaultdict

import torch

# True exactly while a torch.profiler session collects on this thread.
_profiling = torch._C._autograd._profiler_enabled


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


class _Off:
    """The span of a recorder that is off: it enters and leaves."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """One span while the recorder is on: its id, its parent's id (the
    innermost span open on the thread), name, units, host start and end
    (``time.perf_counter``) and, where CUDA is in use, a pair of timing
    events on the current stream. It also stands in the profiler's own
    timeline as a ``record_function`` range."""

    __slots__ = ("rec", "id", "parent", "name", "units", "t0", "t1",
                 "ev0", "ev1", "_rf")

    def __init__(self, rec, name, units):
        self.rec, self.name, self.units = rec, name, float(units)
        self.ev0 = self.ev1 = None

    def __enter__(self):
        stack = self.rec._stack()
        self.id = next(self.rec._ids)
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if torch.cuda.is_initialized():
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        self.t0 = time.perf_counter()
        return None

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        if self.ev0 is not None:
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev1.record()
        self._rf.__exit__(*exc)
        self.rec._stack().pop()
        self.rec._spans.append(self)
        return False


def _reduced(value):
    """A counter's value as a number: a callable is called first, a tensor
    summed and read back."""
    if callable(value):
        value = value()
    if isinstance(value, torch.Tensor):
        return value.sum().item()
    return value


class Recorder:
    """Spans and counters of the port's stages, kept only while a
    ``torch.profiler`` session collects (the profiler is the one switch).

    Off, ``span`` is one check and returns a shared no-op context, and
    ``count`` one check: no event, no allocation, no ``record_function``.
    On, a span records its host clock, a ``record_function`` range and, on
    a CUDA device, a pair of timing events; a counter keeps its value by
    reference. Neither synchronises nor launches device work: events are
    read and tensors reduced only in ``summary()``, after the work.
    Counters are never taken inside a ``torch.func`` transform."""

    def __init__(self):
        self._spans = []
        self._counts = defaultdict(list)
        self._ids = itertools.count()
        self._local = threading.local()

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, units: float = 1.0):
        """A context manager around one stage; ``units`` (frames, pairs,
        iterations) is what a per-unit figure divides by."""
        if not _profiling():
            return _OFF
        return _Span(self, name, units)

    def count(self, name: str, value):
        """Add ``value`` to counter ``name``: a number from shapes, a
        tensor (its sum), or a callable returning either (called in
        ``summary()``, so that it may read tensors the work made)."""
        if _profiling():
            self._counts[name].append(value)

    def summary(self) -> dict:
        """``{"spans": {name: {calls, host_s, self_s, device_ms, units}},
        "counts": {name: number}}`` of what was recorded since the last
        ``clear()``. ``self_s`` is ``host_s`` less the host time of child
        spans; ``device_ms`` is None where no span of the name had CUDA
        events. Waits for the recorded events."""
        spans = list(self._spans)
        inner = defaultdict(float)
        for s in spans:
            if s.parent is not None:
                inner[s.parent] += s.t1 - s.t0
        out = {}
        for s in spans:
            d = out.setdefault(s.name, {"calls": 0, "host_s": 0.0,
                                        "self_s": 0.0, "device_ms": None,
                                        "units": 0.0})
            d["calls"] += 1
            d["host_s"] += s.t1 - s.t0
            d["self_s"] += s.t1 - s.t0 - inner[s.id]
            d["units"] += s.units
            if s.ev1 is not None:
                s.ev1.synchronize()
                d["device_ms"] = ((d["device_ms"] or 0.0)
                                  + float(s.ev0.elapsed_time(s.ev1)))
        counts = {k: sum(_reduced(v) for v in vals)
                  for k, vals in self._counts.items()}
        return {"spans": out, "counts": counts}

    def clear(self):
        """Forget every span and counter recorded so far."""
        self._spans.clear()
        self._counts.clear()


trace = Recorder()


def idle_gaps(events, span_names) -> dict:
    """The device's busy and window seconds in a profile's ``events``, and
    its idle seconds by program span: each gap between device events is
    named by the innermost span of ``span_names`` whose host range
    (``record_function``) covers its midpoint, "host" where none does.
    The device's copies of the spans' ranges are not device work."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in events:
        a, b = float(e.time_range.start), float(e.time_range.end)
        if e.name in span_names:
            if e.device_type == DeviceType.CPU:
                host.append((a, b, e.name))
        elif e.device_type == DeviceType.CUDA and b > a:
            dev.append((a, b))
    merged = []
    for a, b in sorted(dev):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    idle = defaultdict(float)
    for (_, b0), (a1, _) in zip(merged, merged[1:]):
        mid = (b0 + a1) / 2
        cover = [h for h in host if h[0] <= mid <= h[1]]
        name = min(cover, key=lambda h: h[1] - h[0])[2] if cover else "host"
        idle[name] += (a1 - b0) * 1e-6
    return {"busy_s": sum(b - a for a, b in merged) * 1e-6,
            "window_s": (merged[-1][1] - merged[0][0]) * 1e-6 if merged
            else 0.0,
            "idle_s": dict(sorted(idle.items(), key=lambda kv: -kv[1]))}


class device_trace:
    """Context manager around a ``torch.profiler`` trace of the CPU and, where
    there is a card, CUDA activity, exported as a Chrome trace
    ``trace.json`` under ``logdir``; ``averages`` then holds the trace's
    ``key_averages()``. While it is open ``trace`` records (it starts
    empty); on exit ``spans.json`` beside ``trace.json`` holds its
    ``summary()`` and the device's idle gaps by program span
    (:func:`idle_gaps`), which ``spans`` also holds. A no-op (with a
    warning, ``averages`` and ``spans`` None) where the profiler cannot
    start."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self._prof = None
        self.averages = None
        self.spans = None

    def __enter__(self):
        try:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            trace.clear()
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
                self._prof.__exit__(None, None, None)
                self.averages = self._prof.key_averages()
                os.makedirs(self.logdir, exist_ok=True)
                self._prof.export_chrome_trace(
                    os.path.join(self.logdir, "trace.json"))
                summary = trace.summary()
                self.spans = {**summary, "device": idle_gaps(
                    self._prof.events(), set(summary["spans"]))}
                with open(os.path.join(self.logdir, "spans.json"), "w") as f:
                    json.dump(self.spans, f, indent=1)
            except Exception:
                pass
        return False
