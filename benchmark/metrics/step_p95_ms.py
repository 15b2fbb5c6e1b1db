"""95th percentile of the window's step latencies, each from dispatch to
its matches on the host (host clock)."""
import numpy as np


def read(ctx):
    lat = ctx.stats.get("latency_s")
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
