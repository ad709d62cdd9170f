"""A profiled slice of the window, and what its trace says.

`ProfilerSlice` opens `torch.profiler` (host ops and CUDA activity) at a
fixed offset into the window and closes it a fixed length later, with the
card synchronized at both ends, so every batch dispatched inside the
slice ran inside it. `summarize` reduces the trace to the device's busy
time (kernel, copy and set intervals merged, so overlapping work counts
once), the kernel launches, the busiest device operations and the idle
gaps labelled by what the host was doing: the harness phase (`bench:*`
ranges) and the innermost host event over the gap's midpoint.
"""
from __future__ import annotations

import collections
import contextlib
import time

import torch

SLICE = "bench:slice"
NAME_CHARS = 160   # kernel names in the breakdown are cut to this


def phase(enabled: bool):
    """A `record_function` factory for the harness's own phases, or a
    no-op one when the run is not traced."""
    if not enabled:
        return lambda name: contextlib.nullcontext()
    from torch.profiler import record_function
    return lambda name: record_function(f"bench:{name}")


class ProfilerSlice:
    """Profile [start_at, start_at + length) of the host clock."""

    def __init__(self, device: torch.device, start_at: float = 0.0,
                 length: float = 0.0, enabled: bool = False):
        self.device, self.start_at, self.length = device, start_at, length
        self.state = "wait" if enabled else "off"
        self.t_start = self.t_stop = None
        self.prof = None
        self._marker = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def open(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.start()
        self._marker = record_function(SLICE)
        self._marker.__enter__()
        self.t_start = time.monotonic()
        self.state = "on"

    def close(self):
        if self.state != "on":
            return
        self._sync()
        self.t_stop = time.monotonic()
        self._marker.__exit__(None, None, None)
        self.prof.stop()
        self.state = "done"

    def tick(self, now: float) -> None:
        if self.state == "wait" and now >= self.start_at:
            self.open()
        elif self.state == "on" and now >= self.start_at + self.length:
            self.close()


def warm_profiler(device: torch.device, fn) -> None:
    """Open and close the profiler once around `fn` (set-up), so the
    window's slice does not pay the first start, nor miss kernels."""
    s = ProfilerSlice(device, enabled=True)
    s.open()
    fn()
    s.close()


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _label_gaps(gaps, host):
    """Each gap's label: '<harness phase>/<innermost host event>' over its
    midpoint ('loop' / 'none' where nothing covers it)."""
    host = sorted(host, key=lambda e: e[0])
    order = sorted(range(len(gaps)), key=lambda i: gaps[i][0] + gaps[i][1])
    labels = [None] * len(gaps)
    active, j = [], 0
    for i in order:
        m = (gaps[i][0] + gaps[i][1]) / 2
        while j < len(host) and host[j][0] <= m:
            active.append(host[j])
            j += 1
        active = [e for e in active if e[1] >= m]
        outer = [e for e in active if e[2].startswith("bench:")]
        inner = [e for e in active if not e[2].startswith("bench:")]
        o = min(outer, key=lambda e: e[1] - e[0])[2][6:] if outer else "loop"
        n = min(inner, key=lambda e: e[1] - e[0])[2] if inner else "none"
        labels[i] = f"{o}/{n}"
    return labels


def summarize(prof) -> dict | None:
    """busy_s, slice_s, kernels, device_ops and idle_gaps of one slice, or
    None when the trace holds no slice marker."""
    from torch.autograd import DeviceType
    events = prof.events()
    marks = [e for e in events
             if e.name == SLICE and e.device_type == DeviceType.CPU]
    if not marks:
        return None
    s0, s1 = marks[0].time_range.start, marks[0].time_range.end
    dev, host = [], []
    for e in events:
        a, b = max(e.time_range.start, s0), min(e.time_range.end, s1)
        if b <= a or e.name.startswith("bench:"):
            if e.device_type == DeviceType.CPU and e.name != SLICE:
                host.append((a, b, e.name))
            continue
        if getattr(e, "is_user_annotation", False):
            continue
        if e.device_type == DeviceType.CUDA:
            dev.append((a, b, e.name))
        elif e.device_type == DeviceType.CPU:
            host.append((a, b, e.name))
    busy = _merge([(a, b) for a, b, _ in dev])
    edges = [s0] + [x for iv in busy for x in iv] + [s1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    by_op = collections.Counter()
    for a, b, name in dev:
        by_op[name[:NAME_CHARS]] += (b - a) * 1e-6
    by_gap = collections.Counter()
    for (a, b), label in zip(gaps, _label_gaps(gaps, host)):
        by_gap[label] += (b - a) * 1e-6
    kernels = sum(1 for *_, name in dev
                  if not name.startswith(("Memcpy", "Memset")))
    return {"busy_s": sum(b - a for a, b in busy) * 1e-6,
            "slice_s": (s1 - s0) * 1e-6,
            "kernels": kernels,
            "device_ops": [[n, s] for n, s in by_op.most_common(10)],
            "idle_gaps": [[n, s] for n, s in by_gap.most_common(10)]}
