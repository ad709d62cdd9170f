"""Request latency over the window, 95th percentile, in ms."""
from perfbench.harness import percentile


def read(ctx):
    return percentile(ctx.latency_ms, 95) if ctx.latency_ms else None
