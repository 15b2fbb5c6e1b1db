"""Arithmetic the metric readers share: device time per unit, least time
from a work count, idle share."""

from __future__ import annotations


def device_ms_per(ctx, span: str):
    ms, units = ctx.spans.device_ms(span)
    return ms / units if units else None


def least_s(ctx, work):
    ops, byts = work
    return max(ops / ctx.peaks["ops_per_s"], byts / ctx.peaks["bytes_per_s"])


def roofline_pct(ctx, work_key: str, span: str):
    """Share (%) of the least time of one unit's needed work in its
    measured device time; None where either is missing."""
    ms = device_ms_per(ctx, span)
    work = ctx.work.get(work_key)
    if not ms or work is None:
        return None
    return 100.0 * least_s(ctx, work) / (ms * 1e-3)


def idle(ctx):
    p = ctx.profile
    if not p or p["window_s"] <= 0:
        return None
    return 1.0 - p["busy_s"] / p["window_s"]
