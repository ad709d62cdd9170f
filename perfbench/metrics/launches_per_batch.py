"""Kernel launches per batch in the profiled slice."""


def read(ctx):
    p = ctx.profile
    if not p or not p["kernels"] or not ctx.slice_batches:
        return None
    return p["kernels"] / ctx.slice_batches
