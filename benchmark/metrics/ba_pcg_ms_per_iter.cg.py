"""Device ms per LM iteration of the program's ``ba.pcg`` span: the
whole PCG solve of the reduced camera system."""
from benchmark.metrics._program import device_ms_per_iteration


def read(ctx):
    return device_ms_per_iteration(ctx, "ba.pcg")
