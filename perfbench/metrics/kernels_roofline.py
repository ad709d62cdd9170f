"""The profiled slice's least time over the device's busy time, in %."""


def read(ctx):
    p = ctx.profile
    if not p or p["busy_s"] <= 0 or not ctx.slice_batches:
        return None
    return 100.0 * ctx.slice_least_s / p["busy_s"]
