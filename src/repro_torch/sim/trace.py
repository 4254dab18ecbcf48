"""Chrome-trace export for timelines + the real-run trace recorder.

One schema for simulated and measured runs: a :class:`repro.sim.timeline.
Timeline` — whether built by a scheduling policy in ``simulate_*`` or by
wall-clock timers in ``launch/train.py`` / ``posttrain/pipeline.py``
(``--trace out.json``) — serializes to the Chrome Trace Event format, so
both render side by side in ``chrome://tracing`` or https://ui.perfetto.dev
(open the page, drag the JSON in).

Layout: one process, one thread ("tid") per lane, complete events
(``"ph": "X"``) with microsecond timestamps; the event kind rides in
``cat`` (color grouping in the viewer) and ``args.kind``.  Zero-duration
events — ``Lane.mark`` instants, or real-run spans shorter than one timer
tick — are emitted as thread-scoped *instant* events (``"ph": "i"``,
``"s": "t"``) instead of zero-width complete events, which Perfetto and
chrome://tracing drop or render invisibly.  Run-level metadata — source
("sim" | "real"), scheme, policy, staleness — lands in ``otherData``, and
the per-lane idle attribution is precomputed into
``otherData.idle_attribution`` so a trace file is self-describing even
without the viewer.
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Optional

from repro_torch.sim.timeline import Timeline


def chrome_trace(timeline: Timeline, *, extra_meta: Optional[dict] = None
                 ) -> dict:
    """The Chrome Trace Event representation of a timeline (a plain dict,
    ready for ``json.dump``)."""
    events = []
    for tid, lane in enumerate(timeline.lanes):
        events.append({
            "ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
            "args": {"name": lane.name},
        })
        for ev in lane.events:
            if ev.duration <= 0.0:
                # viewers drop/hide dur-0 complete events; an instant
                # ("ph": "i", thread scope) renders as a visible tick
                events.append({
                    "name": ev.name or ev.kind,
                    "cat": ev.kind,
                    "ph": "i",
                    "s": "t",
                    "ts": ev.start * 1e6,
                    "pid": 0,
                    "tid": tid,
                    "args": {"kind": ev.kind},
                })
                continue
            events.append({
                "name": ev.name or ev.kind,
                "cat": ev.kind,
                "ph": "X",
                "ts": ev.start * 1e6,    # seconds -> microseconds
                "dur": ev.duration * 1e6,
                "pid": 0,
                "tid": tid,
                "args": {"kind": ev.kind},
            })
    for track, samples in timeline.counters.items():
        for t, value in samples:
            # counter track ("ph": "C"): viewers render one stacked graph
            # per (pid, name) under the thread lanes
            events.append({
                "name": track,
                "ph": "C",
                "ts": t * 1e6,
                "pid": 0,
                "args": {"value": value},
            })
    other = {"source": timeline.source, **timeline.meta,
             "makespan_s": timeline.makespan,
             "idle_attribution": timeline.idle_breakdown()}
    if extra_meta:
        other.update(extra_meta)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": other}


def write_trace(path: str, timeline: Timeline, *,
                extra_meta: Optional[dict] = None) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(timeline, extra_meta=extra_meta), f,
                  indent=1, sort_keys=True)
        f.write("\n")
    return path


def read_trace(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class TraceRecorder:
    """Wall-clock event recorder for *real* runs, emitting the same
    timeline/trace schema the simulator uses — so a measured training or
    post-training run renders in the same viewer as its simulation.

    Timestamps are relative to construction time (``perf_counter``), one
    lane per actor ("trainer", "host", "generator", "push", ...):

        rec = TraceRecorder(meta={"driver": "launch.train"})
        with rec.span("trainer", "compute", "step 3"):
            run_step()
        rec.write("out.json")
    """

    def __init__(self, *, source: str = "real",
                 meta: Optional[dict] = None):
        self.timeline = Timeline(source=source, meta=meta)
        self._t0 = time.perf_counter()

    def now(self) -> float:
        """Seconds since the recorder started."""
        return time.perf_counter() - self._t0

    @contextlib.contextmanager
    def span(self, lane: str, kind: str, name: str = ""):
        """Record the wall-clock extent of the with-block as one event."""
        start = self.now()
        try:
            yield
        finally:
            self.timeline.lane(lane).place(start, self.now() - start,
                                           kind, name)

    def event(self, lane: str, kind: str, start: float, duration: float,
              name: str = ""):
        """Record an event from explicit relative timestamps."""
        self.timeline.lane(lane).place(start, duration, kind, name)

    def instant(self, lane: str, kind: str, name: str = ""):
        """Record a point-in-time marker (a version publish, a gate that
        cleared instantly) — serialized as a Chrome-trace instant event."""
        self.timeline.lane(lane).mark(kind, name, at=self.now())

    def count(self, track: str, value: float,
              at: Optional[float] = None):
        """Sample a counter track (cumulative wire bytes, queue depth) at
        ``at`` (default: now) — rendered as a ``"ph": "C"`` graph."""
        self.timeline.count(track, self.now() if at is None else at, value)

    def write(self, path: str, *, extra_meta: Optional[dict] = None) -> str:
        return write_trace(path, self.timeline, extra_meta=extra_meta)


def maybe_span(recorder: Optional[TraceRecorder], lane: str, kind: str,
               name: str = ""):
    """``recorder.span(...)`` when tracing is on, a no-op context when the
    recorder is None — keeps driver loops free of tracing conditionals."""
    if recorder is None:
        return contextlib.nullcontext()
    return recorder.span(lane, kind, name)
