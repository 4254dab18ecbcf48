"""Dependency-free metrics registry: counters, gauges, log2 histograms.

One :class:`MetricsRegistry` per run.  Metrics are identified by a name
plus a frozen label set (``backend`` / ``op`` / ``tier`` / ``lane`` /
...), and every step the registry snapshots all of them into one JSONL
line — the telemetry stream ``launch.train --metrics out.jsonl`` (and
friends) write, and ``python -m repro.launch.report`` renders.

Schema identity is the point: the comm-backend seam
(``repro.core.backend``) records the SAME counter names from the
executable primitives (at jit trace time) and from the simulator's cost
hooks, so a simulated and a real run of one config produce metrics files
with identical counter-name sets and the divergence report can align
them (``repro.obs.divergence``).

Trace-time accounting (the ``per_step`` ledger)
-----------------------------------------------
The executable gathers/scatters run inside ``jit`` + ``shard_map``, so
the Python recording a backend does fires once per *compiled program*,
not once per executed step.  ``Counter.inc_per_step`` therefore records
into a per-step **ledger**: the amount a compiled program moves each
time it runs.  ``MetricsRegistry.step()`` commits the whole ledger into
the cumulative counters once per driver step — exact, because every
step replays the same compiled programs.

Two refinements keep the ledger exact under recompilation and loops:

* :func:`MetricsRegistry.program` — a scope that groups trace-time
  records under a key and REPLACES the key's previous group when a
  retrace happens inside it (a new batch shape recompiles the step; the
  old program no longer runs).  Records outside any scope accumulate.
* :func:`trace_scale` — multiplies trace-time amounts inside the scope,
  for code traced once but executed N times per step
  (``jax.lax.scan`` bodies, e.g. ``odc.prefetch_scan``'s per-layer
  prefetch).

Known limit: a rematerialized (``jax.checkpoint``) region re-runs its
gathers on the backward pass without retracing — those repeat moves are
not counted (issue-order accounting, as documented in
``docs/architecture.md``).

This module imports nothing from the rest of ``repro`` (stdlib only),
so any layer — core, sim, posttrain, launch — can record into it.
"""
from __future__ import annotations

import bisect
import contextlib
import json
from typing import Dict, List, Optional, Tuple

#: fixed log2 message-size bucket upper bounds: 2^0 .. 2^48 bytes
#: (one byte to a quarter petabyte — everything a wire can carry here)
LOG2_BUCKETS: Tuple[float, ...] = tuple(float(2 ** p) for p in range(49))


def _label_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def metric_id(name: str, labels: dict) -> str:
    """Canonical ``name{k=v,...}`` identity string (stable label order)."""
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in _label_key(labels))
    return f"{name}{{{inner}}}"


class _Metric:
    kind = "?"

    def __init__(self, registry: "MetricsRegistry", name: str, labels: dict):
        self._registry = registry
        self.name = name
        self.labels = {str(k): str(v) for k, v in labels.items()}

    @property
    def id(self) -> str:
        return metric_id(self.name, self.labels)


class Counter(_Metric):
    """Monotone cumulative count (messages, bytes, events)."""

    kind = "counter"

    def __init__(self, registry, name, labels):
        super().__init__(registry, name, labels)
        self.value = 0.0

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError(
                f"counter {self.id} is monotone; cannot inc by {amount}")
        self.value += amount

    def inc_per_step(self, amount: float):
        """Record into the per-step ledger (trace-time accounting): the
        amount is committed into ``value`` on every ``registry.step()``
        from now on — the bytes one compiled program moves per run."""
        if amount < 0:
            raise ValueError(
                f"counter {self.id} is monotone; cannot inc by {amount}")
        self._registry._ledger_record(("inc", self, amount * _scale()))

    def to_row(self) -> dict:
        return {"kind": self.kind, "name": self.name, "labels": self.labels,
                "value": self.value}


class Gauge(_Metric):
    """Last-value instrument (queue depth, staleness, loss)."""

    kind = "gauge"

    def __init__(self, registry, name, labels):
        super().__init__(registry, name, labels)
        self.value = 0.0

    def set(self, value: float):
        self.value = float(value)

    def to_row(self) -> dict:
        return {"kind": self.kind, "name": self.name, "labels": self.labels,
                "value": self.value}


class Histogram(_Metric):
    """Fixed-bucket histogram; default buckets are the log2 message-size
    ladder (:data:`LOG2_BUCKETS`), with an explicit overflow bucket."""

    kind = "histogram"

    def __init__(self, registry, name, labels,
                 buckets: Tuple[float, ...] = LOG2_BUCKETS):
        super().__init__(registry, name, labels)
        self.buckets = tuple(sorted(buckets))
        self.counts = [0.0] * (len(self.buckets) + 1)  # [-1] = overflow
        self.count = 0.0
        self.sum = 0.0

    def _bucket_index(self, value: float) -> int:
        # first upper bound >= value; beyond the last bound -> overflow
        return bisect.bisect_left(self.buckets, value)

    def observe(self, value: float, n: float = 1.0):
        if n < 0:
            raise ValueError(f"histogram {self.id}: negative count {n}")
        self.counts[self._bucket_index(value)] += n
        self.count += n
        self.sum += value * n

    def observe_per_step(self, value: float, n: float = 1.0):
        """Ledger variant of :meth:`observe` (see ``Counter.inc_per_step``)."""
        if n < 0:
            raise ValueError(f"histogram {self.id}: negative count {n}")
        self._registry._ledger_record(("obs", self, (value, n * _scale())))

    def quantile(self, q: float) -> float:
        """Bucket-upper-bound estimate of the q-quantile (0..1)."""
        if self.count <= 0:
            return 0.0
        target = q * self.count
        seen = 0.0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target and c > 0:
                return (self.buckets[i] if i < len(self.buckets)
                        else self.buckets[-1])
        return self.buckets[-1]

    def to_row(self) -> dict:
        buckets = {}
        for i, c in enumerate(self.counts):
            if c:
                key = (str(int(self.buckets[i])) if i < len(self.buckets)
                       else "overflow")
                buckets[key] = c
        return {"kind": self.kind, "name": self.name, "labels": self.labels,
                "count": self.count, "sum": self.sum, "buckets": buckets}


class MetricsRegistry:
    """All of one run's metrics, plus the per-step trace-time ledger and
    an optional JSONL sink (one snapshot line per committed step)."""

    def __init__(self, meta: Optional[dict] = None):
        self.meta = dict(meta or {})
        self._metrics: Dict[Tuple[str, str, tuple], _Metric] = {}
        # trace-time ledger: group key -> committed-every-step records;
        # None is the open accumulate group, others replace on retrace
        self._groups: Dict[object, List[tuple]] = {}
        self._capture: List[Tuple[object, List[tuple]]] = []
        self._stepno = -1
        self._sink = None
        self._sink_path = None

    # -- metric accessors (get-or-create) -----------------------------------
    def _get(self, cls, name: str, labels: dict, **kw):
        key = (cls.kind, name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = cls(self, name, labels, **kw)
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def total(self, name: str, **label_filter) -> float:
        """Sum of one counter name's value across label sets (optionally
        filtered by exact label values)."""
        out = 0.0
        for (kind, n, _), m in self._metrics.items():
            if kind != "counter" or n != name:
                continue
            if all(m.labels.get(k) == str(v)
                   for k, v in label_filter.items()):
                out += m.value
        return out

    # -- trace-time ledger ---------------------------------------------------
    def _ledger_record(self, record: tuple):
        if self._capture:
            self._capture[-1][1].append(record)
        else:
            self._groups.setdefault(None, []).append(record)

    @contextlib.contextmanager
    def program(self, key):
        """Scope for executing (and possibly re-tracing) one compiled
        program: trace-time records made inside REPLACE the key's prior
        per-step group — a retrace supersedes the old program — while no
        records (the cached-program case) leaves the group in place."""
        buf: List[tuple] = []
        self._capture.append((key, buf))
        try:
            yield
        finally:
            self._capture.pop()
            if buf:
                self._groups[key] = buf

    def _commit_ledger(self):
        for entries in self._groups.values():
            for op, metric, arg in entries:
                if op == "inc":
                    metric.inc(arg)
                else:
                    metric.observe(*arg)

    # -- snapshots ------------------------------------------------------------
    def snapshot(self, step: Optional[int] = None) -> dict:
        rows = [m.to_row() for _, m in sorted(self._metrics.items())]
        return {"step": self._stepno if step is None else step,
                "metrics": rows}

    def step(self, step: Optional[int] = None) -> dict:
        """Commit the per-step ledger and snapshot every metric; writes
        one JSONL line when a sink is attached.  Returns the snapshot."""
        self._commit_ledger()
        self._stepno = self._stepno + 1 if step is None else int(step)
        snap = self.snapshot()
        if self._sink is not None:
            json.dump(snap, self._sink, sort_keys=True)
            self._sink.write("\n")
            self._sink.flush()
        return snap

    # -- JSONL sink ------------------------------------------------------------
    def attach_jsonl(self, path: str):
        """Open ``path`` and write the run header; each ``step()`` then
        appends one snapshot line."""
        self._sink = open(path, "w")
        self._sink_path = path
        json.dump({"obs_schema": 1, "meta": self.meta}, self._sink,
                  sort_keys=True)
        self._sink.write("\n")
        return self

    def close(self) -> Optional[str]:
        if self._sink is not None:
            self._sink.close()
            self._sink = None
        return self._sink_path


# ===========================================================================
# the active registry (what the comm seam records into)
# ===========================================================================
_ACTIVE: Optional[MetricsRegistry] = None
_SUPPRESS = 0
_SCALES: List[float] = []


def active() -> Optional[MetricsRegistry]:
    """The registry recording sites write to; None = recording off (every
    accounting site returns immediately — the telemetry-off fast path)."""
    return None if _SUPPRESS else _ACTIVE


def set_active(reg: Optional[MetricsRegistry]) -> Optional[MetricsRegistry]:
    global _ACTIVE
    _ACTIVE = reg
    return reg


@contextlib.contextmanager
def recording(reg: MetricsRegistry):
    """Scoped ``set_active`` (tests, report CLI)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = reg
    try:
        yield reg
    finally:
        _ACTIVE = prev


@contextlib.contextmanager
def suppressed():
    """Temporarily disable recording — for cost hooks that compute via
    other recording hooks (``weight_push_time`` pricing a push through
    ``layer_comm_time`` must not also record a gather)."""
    global _SUPPRESS
    _SUPPRESS += 1
    try:
        yield
    finally:
        _SUPPRESS -= 1


def _scale() -> float:
    s = 1.0
    for f in _SCALES:
        s *= f
    return s


@contextlib.contextmanager
def trace_scale(n: float):
    """Multiply trace-time (per-step) amounts recorded inside: for code
    traced once but executed ``n`` times per step (scan bodies)."""
    _SCALES.append(float(n))
    try:
        yield
    finally:
        _SCALES.pop()


def program(key):
    """``active().program(key)`` or a no-op scope when recording is off —
    keeps driver loops free of telemetry conditionals."""
    reg = active()
    if reg is None:
        return contextlib.nullcontext()
    return reg.program(key)


# ===========================================================================
# JSONL readers (report CLI, tests)
# ===========================================================================
def read_jsonl(path: str) -> Tuple[dict, List[dict]]:
    """(meta, snapshot rows) of a metrics JSONL file."""
    meta: dict = {}
    rows: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if "obs_schema" in obj:
                meta = obj.get("meta", {})
            else:
                rows.append(obj)
    return meta, rows


def metric_names(rows, *, kind: Optional[str] = None,
                 prefix: str = "") -> set:
    """The set of metric identity strings (``name{k=v,...}``) appearing
    in snapshot rows — the schema-identity view the sim-vs-real
    acceptance check compares."""
    out = set()
    for row in rows:
        for m in row.get("metrics", ()):
            if kind is not None and m.get("kind") != kind:
                continue
            if prefix and not m.get("name", "").startswith(prefix):
                continue
            out.add(metric_id(m["name"], m.get("labels", {})))
    return out
