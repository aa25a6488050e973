"""Port of `nos_tpu/tracing.py`, copied near verbatim: `Tracer` (:72),
`FlightRecorder` (:144), `TickProfiler` (:262) and `EngineTracing` (:354);
only the constants come from the port's own copy.

On CUDA a kernel launch returns before the kernel runs, so the profiler's
`dispatch()` windows measure the host's issue time of the programs, not
their device time: `dispatch_s` is the host wall spent issuing work (a
CUDA graph replay is one short call), and `host_overhead_s` the rest of
the tick's wall. A tick that blocks on the device (a token read-back, a
spill copy-out) shows that wait inside whichever phase blocked. The
profiler only reads `time.perf_counter()`: it never synchronizes the
device, so tracing on and off issue the same work and read back the same
bytes.

Serving-plane tracing: request-lifecycle spans, an engine flight
recorder, and a tick-phase profiler.

The serving engine's aggregate counters (observability.Metrics,
telemetry.ServingReport) say *how much* happened, never *where the time
went*: when one request's TTFT lands in the p95 tail, or a chaos-gate
seed misbehaves, or the host's share of a tick needs attributing,
counts alone cannot answer. This module is the
attribution layer, three coupled pieces:

  - ``Tracer`` — per-request lifecycle spans. One trace per request
    (``router.select -> req.submit -> req.reserved ->
    req.prefill_chunk[i] -> req.first_token -> req.decode ->
    req.finish``, plus the exceptional edges ``req.preempt / req.spill /
    req.revive / req.restore / req.drain_migrate`` —
    constants.TRACE_EVENTS). The trace id is threaded through
    ``_Request``/``_Slot`` and rides ``SlotCheckpoint``, so a restored
    or preempted stream keeps ONE coherent trace across recoveries.

  - ``FlightRecorder`` — a bounded per-engine ring buffer of structured
    engine events (constants.FLIGHT_EVENTS). ``DecodeServer._recover``
    snapshots the ring into a postmortem dump on every
    poison/transient/device-lost recovery, so the events *leading up to*
    a fault survive the fault.

  - ``TickProfiler`` — per-phase wall-time attribution of
    ``DecodeServer._tick`` (constants.TICK_PHASES), with a per-tick
    ``host_overhead_s`` vs ``dispatch_s`` split: ``dispatch()`` wraps the
    program invocations (host issue time on CUDA, see above), everything
    else in the tick is host scheduling overhead. Phase durations feed bucketed Prometheus histograms
    (observability.Metrics ``_bucket`` series) and
    telemetry.ServingReport (samples pooled across replicas by
    ``merge``, percentiles re-derived).

Disciplines, all host-side by construction:

  - NO DEVICE TRAFFIC, EVER: every stamp is ``time.perf_counter()``; no
    hook materializes, probes, or syncs a device buffer (tracing that
    perturbs the pipeline it measures is worse than no tracing).
  - NO REQUEST CONTENT: span attrs and flight-recorder payloads are
    counts and ids only — token counts, slot/serial/block ids, replica
    ids — never token values, prompts, or generated text (the same
    contract as telemetry.ServingReport).
  - BOUNDED MEMORY: traces, per-trace events, the ring, and postmortem
    dumps are all capacity-capped ring buffers; a long-lived engine's
    tracing footprint is a constant.
  - DEFAULT-OFF COST: an engine built without a tracing bundle pays a
    disabled-flag check per tick phase and nothing else; outputs are
    bit-identical tracing-on vs tracing-off (pinned by
    tests/test_torch_tracing.py's counter-gated oracle).

Event names live in ``nos_tpu_torch.constants`` (TRACE_EV_* / FLIGHT_EV_*
/ TICK_PHASE_*).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional

from nos_tpu_torch import constants


class Tracer:
    """Request-lifecycle span store: trace id -> bounded event list.

    Thread-safe (client threads submit, the engine thread records, the
    debug HTTP thread reads). Ids are a deterministic counter — no RNG,
    so two runs of the same traffic mint the same ids. ``event`` on an
    id this store has never seen (or already evicted) re-creates the
    entry: a checkpoint migrated in from another replica's tracer must
    keep collecting events here rather than vanish."""

    def __init__(self, max_traces: int = 512, max_events_per_trace: int = 256):
        self.max_traces = int(max_traces)
        self.max_events_per_trace = int(max_events_per_trace)
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, deque]" = OrderedDict()
        self._next_id = 0
        #: Traces evicted to honor `max_traces` (observability of loss).
        self.dropped_traces = 0

    def new_trace(self) -> str:
        with self._lock:
            self._next_id += 1
            tid = f"{constants.TRACE_ID_PREFIX}{self._next_id:08d}"
            self._traces[tid] = deque(maxlen=self.max_events_per_trace)
            self._evict_locked()
            return tid

    def _evict_locked(self) -> None:
        while len(self._traces) > self.max_traces:
            self._traces.popitem(last=False)
            self.dropped_traces += 1

    def event(
        self,
        trace_id: Optional[str],
        name: str,
        dur_s: Optional[float] = None,
        **attrs,
    ) -> None:
        """Record one event on `trace_id` (no-op for None, so callers
        can thread an optional id without guarding). `attrs` are counts
        and ids only — never request content."""
        if trace_id is None:
            return
        ev: Dict[str, object] = {
            "t": time.perf_counter(),
            "name": name,
            "attrs": attrs,
        }
        if dur_s is not None:
            ev["dur_s"] = float(dur_s)
        with self._lock:
            dq = self._traces.get(trace_id)
            if dq is None:
                dq = deque(maxlen=self.max_events_per_trace)
                self._traces[trace_id] = dq
                self._evict_locked()
            dq.append(ev)

    def trace(self, trace_id: str) -> Optional[List[dict]]:
        """The trace's events in record order, or None for an unknown
        (or evicted) id."""
        with self._lock:
            dq = self._traces.get(trace_id)
            return [dict(ev) for ev in dq] if dq is not None else None

    def trace_ids(self) -> List[str]:
        """Resident trace ids, oldest first."""
        with self._lock:
            return list(self._traces)


class FlightRecorder:
    """Bounded ring buffer of structured engine events, plus the
    postmortem dumps recovery snapshots out of it.

    The ring holds the *most recent* `capacity` events; ``dump(reason)``
    freezes the current ring contents into a postmortem entry (itself a
    bounded deque), which is what makes the recorder useful: the events
    leading up to a fault survive both the fault and the ring's own
    churn afterwards. Event names come from constants.FLIGHT_EVENTS;
    payloads are counts/ids only."""

    def __init__(self, capacity: int = 1024, max_postmortems: int = 8):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._postmortems: deque = deque(maxlen=int(max_postmortems))
        self._seq = 0

    def record(self, name: str, **payload) -> None:
        with self._lock:
            self._seq += 1
            self._ring.append(
                {
                    "seq": self._seq,
                    "t": time.perf_counter(),
                    "name": name,
                    **payload,
                }
            )

    @property
    def events_recorded(self) -> int:
        """Lifetime event count (the ring keeps only the newest)."""
        return self._seq

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [dict(ev) for ev in self._ring]

    def dump(self, reason: str) -> dict:
        """Freeze the ring into a postmortem entry and return it."""
        with self._lock:
            entry = {
                "reason": reason,
                "t": time.perf_counter(),
                "events": [dict(ev) for ev in self._ring],
            }
            self._postmortems.append(entry)
            return entry

    def postmortem_dumps(self) -> List[dict]:
        with self._lock:
            return list(self._postmortems)


class _NoopCtx:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopCtx()


class _Phase:
    """One phase context: exclusive-time attribution via the profiler's
    phase stack (a nested phase's duration is charged to itself and
    subtracted from its parent, so the per-tick phase values sum to the
    instrumented wall time with no double counting)."""

    __slots__ = ("prof", "name", "t0", "child")

    def __init__(self, prof: "TickProfiler", name: str):
        self.prof = prof
        self.name = name

    def __enter__(self):
        self.t0 = self.prof._clock()
        self.child = 0.0
        self.prof._stack.append(self)
        return self

    def __exit__(self, *exc):
        prof = self.prof
        dur = prof._clock() - self.t0
        prof._stack.pop()
        tick = prof._tick_phase
        tick[self.name] = tick.get(self.name, 0.0) + (dur - self.child)
        if prof._stack:
            prof._stack[-1].child += dur
        return False


class _Dispatch:
    """One dispatch context: accumulates into the tick's dispatch-time
    split WITHOUT touching the phase stack — dispatch time stays inside
    its enclosing phase's attribution (phases partition the tick;
    dispatch vs host-overhead is the orthogonal cut)."""

    __slots__ = ("prof", "t0")

    def __init__(self, prof: "TickProfiler"):
        self.prof = prof

    def __enter__(self):
        self.t0 = self.prof._clock()
        return self

    def __exit__(self, *exc):
        prof = self.prof
        prof._tick_dispatch += prof._clock() - self.t0
        return False


class TickProfiler:
    """Per-phase wall-time attribution for the engine tick.

    Usage (DecodeServer._tick): ``begin_tick()``, wrap each scheduler
    phase in ``with prof.phase(constants.TICK_PHASE_*)`` (nesting
    allowed — exclusive times), wrap every program invocation in
    ``with prof.dispatch()``, then ``end_tick(metrics)``. Totals
    accumulate across ticks (``phase_s``, ``tick_wall_s``,
    ``dispatch_s``, ``host_overhead_s``); per-tick host-overhead and
    dispatch values also land in bounded sample deques so
    telemetry.ServingReport can pool them across replicas and re-derive
    fleet percentiles. ``end_tick`` observes each phase's per-tick value
    into the ``nos_tpu_decode_tick_phase_seconds`` histogram (plus the
    tick/host-overhead/dispatch histograms) when a metrics registry is
    handed in.

    `clock` is injectable for deterministic tests; production uses
    time.perf_counter (monotonic, never a device sync)."""

    def __init__(
        self,
        enabled: bool = True,
        max_samples: int = 2048,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self.enabled = bool(enabled)
        self._clock = clock
        # Accumulated across ticks.
        self.ticks = 0
        self.tick_wall_s = 0.0
        self.dispatch_s = 0.0
        self.host_overhead_s = 0.0
        self.phase_s: Dict[str, float] = {}
        self.host_overhead_samples: deque = deque(maxlen=int(max_samples))
        self.dispatch_samples: deque = deque(maxlen=int(max_samples))
        # Per-tick working state.
        self._tick_t0 = 0.0
        self._tick_dispatch = 0.0
        self._tick_phase: Dict[str, float] = {}
        self._stack: List[_Phase] = []
        self._in_tick = False

    def phase(self, name: str):
        if not self.enabled or not self._in_tick:
            return _NOOP
        return _Phase(self, name)

    def dispatch(self):
        if not self.enabled or not self._in_tick:
            return _NOOP
        return _Dispatch(self)

    def begin_tick(self) -> None:
        if not self.enabled:
            return
        self._tick_t0 = self._clock()
        self._tick_dispatch = 0.0
        self._tick_phase = {}
        self._stack = []
        self._in_tick = True

    def end_tick(self, metrics=None) -> None:
        if not self.enabled or not self._in_tick:
            return
        self._in_tick = False
        wall = self._clock() - self._tick_t0
        self.ticks += 1
        self.tick_wall_s += wall
        for name, v in self._tick_phase.items():
            self.phase_s[name] = self.phase_s.get(name, 0.0) + v
        dispatch = self._tick_dispatch
        host = max(0.0, wall - dispatch)
        self.dispatch_s += dispatch
        self.host_overhead_s += host
        self.dispatch_samples.append(dispatch)
        self.host_overhead_samples.append(host)
        if metrics is not None:
            for name, v in self._tick_phase.items():
                metrics.observe("nos_tpu_decode_tick_phase_seconds", v, phase=name)
            metrics.observe("nos_tpu_decode_tick_seconds", wall)
            metrics.observe("nos_tpu_decode_tick_dispatch_seconds", dispatch)
            metrics.observe("nos_tpu_decode_tick_host_overhead_seconds", host)

    def attribution_coverage(self) -> float:
        """Fraction of the measured tick wall time the phase buckets
        account for (1.0 = everything attributed; the tracing-overhead
        gate demands >= 0.95)."""
        if self.tick_wall_s <= 0.0:
            return 1.0
        return min(1.0, sum(self.phase_s.values()) / self.tick_wall_s)


class EngineTracing:
    """The bundle an engine is armed with: one Tracer (request spans —
    SHARE one instance across a replica fleet so migrated streams keep
    one coherent trace), one FlightRecorder (per-engine ring), one
    TickProfiler (per-engine attribution). ``DecodeServer(...,
    tracing=EngineTracing())`` turns all three on; the default (None)
    engine pays no tracing cost."""

    def __init__(
        self,
        tracer: Optional[Tracer] = None,
        recorder: Optional[FlightRecorder] = None,
        profiler: Optional[TickProfiler] = None,
    ):
        self.tracer = tracer if tracer is not None else Tracer()
        self.recorder = recorder if recorder is not None else FlightRecorder()
        self.profiler = profiler if profiler is not None else TickProfiler()
