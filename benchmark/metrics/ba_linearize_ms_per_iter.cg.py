"""Device ms per LM iteration of the program's ``ba.jacobians`` and
``ba.blocks`` spans: the Jacobians, the normal equations' blocks, their
damping and inverses, and the right-hand side."""
from benchmark.metrics._program import device_ms_per_iteration


def read(ctx):
    return device_ms_per_iteration(ctx, "ba.jacobians", "ba.blocks")
