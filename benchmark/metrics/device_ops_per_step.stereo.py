"""Device operations (kernels, copies, memsets) in the profiled slice,
over its steps."""


def read(ctx):
    p = ctx.profile
    return p["device_ops"] / ctx.trace_units if p else None
