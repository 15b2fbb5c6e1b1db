"""The window's wall time over all the LM iterations of the solves
completed in it, each solve's host pack included (host clock)."""


def read(ctx):
    s = ctx.stats
    return 1e3 * s["wall_s"] / s["iterations"] if s.get("iterations") else None
