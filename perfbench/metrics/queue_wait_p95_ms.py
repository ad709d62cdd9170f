"""95th percentile of the tracer's `request` spans (submit to admission
into a launch), in ms."""
from perfbench.harness import percentile


def read(ctx):
    tracer = ctx.window.tracer
    if tracer is None:
        return None
    begin = {}
    waits = []
    for e in tracer.spans("request"):
        if e.ph == "B":
            begin[e.attrs["request"]] = e.ts
        elif e.ph == "E" and e.attrs["request"] in begin:
            waits.append((e.ts - begin.pop(e.attrs["request"])) * 1e3)
    return percentile(waits, 95) if waits else None
