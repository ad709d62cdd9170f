"""Span-based lifecycle tracer with an injectable clock.

Port of `repro.obs.tracing` (pure Python). Every recording call takes an
optional ``now`` and only falls back to the tracer's clock when the
caller doesn't provide one — so a simulated-clock run produces a
bit-identical trace every time.

Two span styles:

  * ``with tracer.span("flush", now=...):`` — a synchronous phase; emits
    one COMPLETE event (begin + duration) when the block exits.
  * ``tracer.begin(name, key, now)`` / ``tracer.end(key, now)`` — an
    ASYNC lifecycle that outlives any one call frame (a request between
    submit and resolve). Keys must be unique among open spans: a double
    begin or an end without a begin raises immediately instead of
    silently producing an unbalanced trace.

Spans around work on the card: a span closes on the HOST clock, and
PyTorch returns from a CUDA launch before the card has run it. A span
around a retrieve, an ingest or a compact therefore measures the host's
launch time unless the caller synchronizes (``torch.cuda.synchronize()``)
inside the span before it closes. The tracer never synchronizes itself.

Events are plain host-side records (`TraceEvent`); the exporters in
`repro_torch.obs.export` render them as JSON-lines or Chrome
``trace_event`` JSON (openable in Perfetto / chrome://tracing).
`NullTracer` (`NULL_TRACER`) makes every call a no-op when disabled.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time


@dataclasses.dataclass
class TraceEvent:
    """One trace record.

    ph follows Chrome trace_event phases: "B"/"E" (async begin/end),
    "X" (complete, with `dur`), "i" (instant). `ts`/`dur` are SECONDS in
    whatever clock produced them (exporters scale to µs)."""

    name: str
    ph: str
    ts: float
    tid: int | str = 0
    dur: float | None = None
    attrs: dict = dataclasses.field(default_factory=dict)


class Tracer:
    """Append-only host-side event recorder."""

    enabled = True

    def __init__(self, clock=time.monotonic):
        self.clock = clock
        self.events: list[TraceEvent] = []
        self._open: dict[object, TraceEvent] = {}

    def _now(self, now: float | None) -> float:
        return self.clock() if now is None else now

    def __len__(self) -> int:
        return len(self.events)

    # -- recording --------------------------------------------------------

    def instant(self, name: str, *, now: float | None = None,
                tid: int | str = 0, **attrs) -> None:
        self.events.append(TraceEvent(name=name, ph="i", ts=self._now(now),
                                      tid=tid, attrs=attrs))

    def begin(self, name: str, key, *, now: float | None = None,
              tid: int | str = 0, **attrs) -> None:
        """Open an async span identified by `key` (e.g. a request id)."""
        if key in self._open:
            raise ValueError(f"span key {key!r} already open "
                             f"({self._open[key].name})")
        ev = TraceEvent(name=name, ph="B", ts=self._now(now), tid=tid,
                        attrs=attrs)
        self._open[key] = ev
        self.events.append(ev)

    def end(self, key, *, now: float | None = None, **attrs) -> None:
        """Close the async span opened under `key`."""
        opened = self._open.pop(key, None)
        if opened is None:
            raise KeyError(f"end() for span key {key!r} that is not open")
        self.events.append(TraceEvent(name=opened.name, ph="E",
                                      ts=self._now(now), tid=opened.tid,
                                      attrs=attrs))

    @contextlib.contextmanager
    def span(self, name: str, *, now: float | None = None,
             tid: int | str = 0, **attrs):
        """Synchronous phase: one complete ("X") event on exit.

        With an explicit `now` the duration is 0 in simulated time
        (deterministic); without one, start/end are read from the
        tracer's clock."""
        t0 = self._now(now)
        try:
            yield self
        finally:
            t1 = t0 if now is not None else self._now(None)
            self.events.append(TraceEvent(name=name, ph="X", ts=t0,
                                          tid=tid, dur=t1 - t0,
                                          attrs=attrs))

    # -- introspection ----------------------------------------------------

    def open_spans(self) -> list:
        """Keys of spans begun but not yet ended (a finished serving run
        must report none — the trace-completeness property)."""
        return list(self._open)

    def spans(self, name: str | None = None) -> list[TraceEvent]:
        """Events, optionally filtered by name."""
        if name is None:
            return list(self.events)
        return [e for e in self.events if e.name == name]

    def clear(self) -> None:
        self.events.clear()
        self._open.clear()


class NullTracer:
    """Tracing switched off: every call a no-op, `span` an empty context."""

    enabled = False
    events: list = []

    def instant(self, name, *, now=None, tid=0, **attrs):
        pass

    def begin(self, name, key, *, now=None, tid=0, **attrs):
        pass

    def end(self, key, *, now=None, **attrs):
        pass

    @contextlib.contextmanager
    def span(self, name, *, now=None, tid=0, **attrs):
        yield self

    def open_spans(self):
        return []

    def spans(self, name=None):
        return []

    def clear(self):
        pass

    def __len__(self):
        return 0


NULL_TRACER = NullTracer()
