"""Host syncs PyTorch reports per step (``set_sync_debug_mode``), the
readback of the matches included."""


def read(ctx):
    return ctx.syncs
