"""Frames detected, described and matched, and read back, over all the
time of the window (host clock)."""


def read(ctx):
    s = ctx.stats
    return s["frames"] / s["wall_s"] if "frames" in s else None
