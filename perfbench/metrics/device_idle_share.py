"""Share of the profiled slice with no device work: 1 - busy / slice
length, in %."""


def read(ctx):
    p = ctx.profile
    if not p or p["busy_s"] <= 0 or p["slice_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["slice_s"])
