"""Device busy time, idle gaps and device operations of a steady slice.

The arithmetic of the port's ``chip_smoke.profile_frame``, copied: a
``torch.profiler`` trace with device activity only (host operators are not
recorded, which would slow a call of thousands of launches), device-side
events only (a host operator also reports its kernels' time). Added here:
the busy time is the union of the device events' intervals, the window runs
from a marker launched at the slice's start to the end of its last device
event, and each idle gap is named by the innermost host span (``Spans``)
that covers its middle. The trace's clock is tied to the host's by the
marker, so a gap's name can be off by the launch latency of one kernel.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch


def _device_events(prof):
    from torch.autograd import DeviceType
    out = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = float(e.time_range.start), float(e.time_range.end)
        if b > a:
            out.append((a, b, e.name))
    out.sort()
    return out


def _union(intervals):
    merged = []
    for a, b, _ in intervals:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def profile_slice(fn, spans, top: int = 10):
    """Run ``fn()`` under the profiler and return a summary: ``busy_s``,
    ``window_s``, ``device_ops`` (their count) and a ``breakdown`` of the
    device operations that took most time and the idle seconds by host
    span. None where the profiler saw no device event."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    marker = torch.empty(1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t_mark = time.perf_counter() - spans.t0
        marker.zero_()
        fn()
        torch.cuda.synchronize()
    ev = _device_events(prof)
    if not ev:
        return None
    t_first = ev[0][0]
    merged = _union(ev)
    busy_us = sum(b - a for a, b in merged)
    window_us = merged[-1][1] - t_first
    by_name = defaultdict(float)
    for a, b, name in ev:
        by_name[name] += (b - a) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = defaultdict(float)
    host = [s for s in spans.host if s[2] >= t_mark]
    for (_, b0), (a1, _) in zip(merged, merged[1:]):
        mid = t_mark + ((b0 + a1) / 2 - t_first) * 1e-6
        cover = [s for s in host if s[1] <= mid <= s[2]]
        name = min(cover, key=lambda s: s[2] - s[1])[0] if cover else "host"
        idle[name] += (a1 - b0) * 1e-6
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy_us * 1e-6, "window_s": window_us * 1e-6,
            "device_ops": len(ev),
            "breakdown": {"device_ops": [[n[:120], s] for n, s in ops],
                          "idle_gaps": [[n, s] for n, s in gaps]}}
