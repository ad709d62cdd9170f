"""The whole window's share of the card's peak: the least time of every
batch dispatched in the window over the window's wall time, in %.

Reads the traced run's context, as every file here does, and returns a
number, or None where the run holds nothing to read (the metric is then
left out of the result line). A metric named `<file>.<suffix>` in
`BENCHMARK.json` is read by `<file>.py`.
"""


def read(ctx):
    if ctx.least_s is None or ctx.least_s <= 0:
        return None
    return 100.0 * ctx.least_s / ctx.window.window_s
