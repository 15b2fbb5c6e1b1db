"""Arithmetic of the readers of the program's own spans and counters
(``sara_tpu_torch/utils/timing.py::trace``), which the program records
while the traced slice's profiler runs. Where the program has no such
recorder, or it saw nothing of the name, a reader gets None."""

from __future__ import annotations


def summary(ctx):
    """The recorder's summary, read once per run and kept on ``ctx``."""
    if not hasattr(ctx, "program"):
        try:
            from sara_tpu_torch.utils.timing import trace
        except ImportError:
            trace = None
        ctx.program = trace.summary() if trace is not None else None
    return ctx.program


def span(ctx, name: str):
    s = summary(ctx)
    return s["spans"].get(name) if s else None


def count(ctx, name: str):
    s = summary(ctx)
    return s["counts"].get(name) if s else None


def share(ctx, part: str, whole: str):
    """Counter ``part`` over counter ``whole``."""
    a, b = count(ctx, part), count(ctx, whole)
    return a / b if a is not None and b else None


def device_ms_per_unit(ctx, name: str):
    """Device ms of the named spans over their units."""
    s = span(ctx, name)
    if not s or s["device_ms"] is None or not s["units"]:
        return None
    return s["device_ms"] / s["units"]


def device_ms_per_iteration(ctx, *names: str):
    """Device ms of the named BA spans over the LM iterations counted."""
    spans = [span(ctx, n) for n in names]
    its = count(ctx, "ba.iterations")
    if not its or any(s is None or s["device_ms"] is None for s in spans):
        return None
    return sum(s["device_ms"] for s in spans) / its
