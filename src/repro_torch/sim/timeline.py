"""The timeline schema and the 1F1B pipeline issue order: verbatim
copies of ``repro.sim.timeline``'s ``Event``, ``Lane`` and ``Timeline``
(typed events on named lanes, per-kind totals and the idle attribution:
the schema ``sim.trace`` serializes, for real runs recorded by
``sim.trace.TraceRecorder``) and of its ``stage_partition`` and
``instructions_1f1b`` (the copy rule: the port imports nothing of the
JAX package; ``tests/test_torch_obs.py`` and ``tests/test_torch_pipe.py``
hold the copies to the originals).  Event kinds: ``compute`` and
``decode`` (useful work), ``comm`` (exposed wire time), ``barrier``,
``gate`` (a staleness bound or upstream data) and ``push`` (the
trainer-to-generator weight push, or waiting on it).  The scheduling policies and the
simulator (``repro.sim.engine``) are not ported yet (ROADMAP.md queue 1
item 8).

``instructions_1f1b`` is the one definition of the order in which the
``'1f1b'`` schedule (``repro_torch.core.backend.build_schedule_grad``)
issues each rank's microbatch forwards and backwards.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

#: the closed event vocabulary (see module docstring)
EVENT_KINDS = ("compute", "decode", "comm", "barrier", "gate", "push")
#: kinds that count as useful work in the idle attribution
BUSY_KINDS = ("compute", "decode")


@dataclasses.dataclass(frozen=True)
class Event:
    """One typed interval on one lane."""

    kind: str
    start: float
    duration: float
    name: str = ""

    @property
    def end(self) -> float:
        return self.start + self.duration


class Lane:
    """One device / decode slot / actor: a cursor plus its event record.

    ``t`` is the float-exact scheduling cursor (all makespan arithmetic);
    events are the presentational record.  Event *starts* are clamped to
    stay monotone per lane (derived sub-event offsets can drift from the
    cursor by ulps), durations are stored exactly as given so per-kind
    sums — busy conservation, idle attribution — stay exact.

    Per-kind duration totals are accumulated *at placement* (``_totals``),
    so ``kind_totals`` is an O(1) read instead of a re-scan of the event
    list — placing and accounting N events is O(N) total.  The running
    sums add durations in exactly the emission order the retired
    re-scan summed them in, so they are bit-identical to it.

    ``record=False`` keeps the cursor arithmetic and the running totals
    but skips materializing ``Event`` records entirely — the mode the
    auto-tuner scores thousands of candidate timelines in, where the
    event list would be allocated only to be thrown away.  Makespan,
    finish times, ``kind_totals`` and the idle attribution are identical
    in both modes; only trace export needs ``record=True``.
    """

    def __init__(self, name: str, record: bool = True):
        self.name = name
        self.t = 0.0
        self.record = record
        self.events: List[Event] = []
        self._edge = 0.0  # last event start, for monotone placement
        self._totals = {k: 0.0 for k in EVENT_KINDS}

    def _emit(self, start: float, duration: float, kind: str, name: str):
        if duration <= 0.0:
            return  # zero/negative (ulp-artifact) intervals carry no info
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {kind!r}; "
                             f"one of {EVENT_KINDS}")
        self._totals[kind] += duration
        if not self.record:
            return
        start = max(start, self._edge)
        self._edge = start
        self.events.append(Event(kind, start, duration, name))

    def mark(self, kind: str, name: str = "",
             at: Optional[float] = None):
        """An explicit zero-duration *instant* marker at ``at`` (default:
        the cursor).  Unlike the derived sub-segments — whose zero-width
        entries are arithmetic artifacts and are dropped by ``_emit`` — a
        marker is deliberate (a gate that cleared instantly, a push that
        took less than one timer tick) and is kept, serialized as a
        Chrome-trace instant event (``"ph": "i"``) so viewers render it
        instead of dropping an invisible zero-width box."""
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {kind!r}; "
                             f"one of {EVENT_KINDS}")
        if not self.record:
            return
        start = self.t if at is None else at
        start = max(start, self._edge)
        self._edge = start
        self.events.append(Event(kind, start, 0.0, name))

    def wait(self, until: float, kind: str = "barrier", name: str = ""):
        """Advance the cursor to ``max(t, until)``, recording the gap."""
        if until > self.t:
            self._emit(self.t, until - self.t, kind, name)
            self.t = until

    def advance(self, duration: float, kind: str, name: str = ""):
        """One event of ``duration`` at the cursor; cursor += duration."""
        self._emit(self.t, duration, kind, name)
        self.t = self.t + duration

    def block(self, total: float,
              segments: Sequence[Tuple[str, float, str]]):
        """A scheduled block: the cursor advances by ``total`` in ONE
        addition (the closed-form float contract); ``segments`` —
        ``(kind, duration, name)`` triples — are laid inside the block at
        derived offsets for the trace and the attribution sums."""
        s = self.t
        self.t = self.t + total
        for kind, dur, name in segments:
            self._emit(s, dur, kind, name)
            s = s + dur

    def place(self, start: float, duration: float, kind: str,
              name: str = ""):
        """Absolute placement (annotation lanes, real-run recorders);
        bumps the cursor to the event end so makespans stay meaningful.
        A zero-duration placement — a real-run span shorter than one
        timer tick — is kept as an instant marker rather than silently
        dropped."""
        if duration <= 0.0:
            self.mark(kind, name, at=start)
        else:
            self._emit(start, duration, kind, name)
        self.t = max(self.t, start + max(duration, 0.0))

    def kind_totals(self) -> Dict[str, float]:
        """Per-kind duration sums, read off the running totals kept at
        placement time (bit-identical to re-summing ``self.events`` —
        same additions in the same order — without the re-scan)."""
        return dict(self._totals)


class Timeline:
    """An ordered set of lanes plus run-level metadata.

    ``source`` is "sim" for simulated runs and "real" for wall-clock
    recordings (``repro.sim.trace.TraceRecorder``) — both serialize to the
    same Chrome-trace schema, so they render in one viewer.

    ``record=False`` propagates to every lane (see :class:`Lane`): cursors
    and per-kind totals stay exact, event records are skipped — the cheap
    mode for score-only simulations that never export a trace.
    """

    def __init__(self, source: str = "sim", meta: Optional[dict] = None,
                 record: bool = True):
        self.source = source
        self.meta = dict(meta or {})
        self.record = record
        self._lanes: Dict[str, Lane] = {}
        self._counters: Dict[str, List[Tuple[float, float]]] = {}

    def lane(self, name: str) -> Lane:
        ln = self._lanes.get(name)
        if ln is None:
            ln = self._lanes[name] = Lane(name, record=self.record)
        return ln

    def count(self, track: str, t: float, value: float):
        """Sample a counter track (cumulative wire bytes, queue depth,
        staleness) at time ``t`` — rendered as a ``"ph": "C"`` graph
        under the lanes in the Chrome-trace export.  Annotation-only:
        samples never feed back into lane cursor arithmetic (and are
        skipped entirely in ``record=False`` score-only mode)."""
        if not self.record:
            return
        self._counters.setdefault(track, []).append((float(t), float(value)))

    @property
    def counters(self) -> Dict[str, List[Tuple[float, float]]]:
        return {k: list(v) for k, v in self._counters.items()}

    @property
    def lanes(self) -> List[Lane]:
        return list(self._lanes.values())

    @property
    def makespan(self) -> float:
        return max((ln.t for ln in self._lanes.values()), default=0.0)

    def idle_breakdown(self, makespan: Optional[float] = None
                       ) -> Dict[str, Dict[str, float]]:
        """Per-lane attribution of the full run: busy (compute+decode)
        plus where every idle second went — exposed comm, barrier waits,
        staleness/data gates, push traffic, and ``drain`` (done early,
        waiting for the run to end)."""
        mk = self.makespan if makespan is None else makespan
        out = {}
        for ln in self.lanes:
            tot = ln.kind_totals()
            out[ln.name] = {
                "busy": sum(tot[k] for k in BUSY_KINDS),
                "comm": tot["comm"],
                "barrier": tot["barrier"],
                "gate": tot["gate"],
                "push": tot["push"],
                "drain": max(0.0, mk - ln.t),
            }
        return out


def stage_partition(num_layers: int, stages: int) -> List[int]:
    """Contiguous per-stage layer counts: ``num_layers`` split into
    ``stages`` chunks with the remainder going to the earliest stages (the
    standard pipeline partition).  Stages beyond the layer count get zero
    layers — they still relay activations, they just do no compute."""
    if stages <= 0:
        raise ValueError(f"stages must be positive, got {stages}")
    if num_layers < 0:
        raise ValueError(f"num_layers must be >= 0, got {num_layers}")
    base, rem = divmod(num_layers, stages)
    return [base + (1 if s < rem else 0) for s in range(stages)]


def instructions_1f1b(num_microbatches: int, stages: int, *, stage: int = 0,
                      interleave: bool = False) -> List[Tuple[str, int]]:
    """The 1F1B issue order at one pipeline stage: ``[("F", j) | ("B", j)]``.

    Stage ``s`` of ``S`` runs ``S - 1 - s`` warmup forwards (filling the
    pipeline), then strict one-forward-one-backward alternation (bounding
    in-flight activations at the warmup depth + 1), then drains the
    remaining backwards.  ``interleave=True`` halves the warmup depth —
    the reduced-residency interleaved variant, where each stage holds two
    half-size virtual stages so its fill obligation is split.

    This function is the ONE definition of the issue order: the sim's
    :class:`PipelineStagePolicy` schedules per-stage lanes from it and the
    executable ``schedule='1f1b'`` gradient loop
    (``repro.core.backend.build_schedule_grad``) issues its microbatch
    forward/backward calls from the same list, so executable and simulated
    pipelines share their schedule shape by construction.
    """
    M, S = num_microbatches, stages
    if S <= 0:
        raise ValueError(f"stages must be positive, got {S}")
    if not 0 <= stage < S:
        raise ValueError(f"stage {stage} out of range for {S} stages")
    if M < 0:
        raise ValueError(f"num_microbatches must be >= 0, got {M}")
    w = S - 1 - stage
    if interleave:
        w = (w + 1) // 2
    w = min(w, M)
    out: List[Tuple[str, int]] = [("F", j) for j in range(w)]
    for j in range(M - w):
        out.append(("F", w + j))
        out.append(("B", j))
    out.extend(("B", j) for j in range(M - w, M))
    return out
