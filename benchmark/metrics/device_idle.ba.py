"""Share of the profiled slice in which no device operation ran."""
from benchmark.metrics._read import idle


def read(ctx):
    return idle(ctx)
