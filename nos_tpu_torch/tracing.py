"""Port of `nos_tpu/tracing.py`: `Tracer` (:72), `FlightRecorder` (:144),
`TickProfiler` (:262) and `EngineTracing` (:354); the constants come from
the port's own copy. The port's TickProfiler adds to the reference's a
kind on each dispatch, `stage` and `read_wait` spans, the `read_wait_s`
total and a span log on a clock a device trace can be joined with
(docs/tracing_torch.md).

On CUDA a kernel launch returns before the kernel runs, so the profiler's
`dispatch()` windows measure the host's issue time of the programs, not
their device time: `dispatch_s` is the host wall spent issuing work (a
CUDA graph replay is one short call), and `host_overhead_s` the rest of
the tick's wall. A tick that blocks on the device (a token read-back, a
spill copy-out) shows that wait inside whichever phase blocked; a token
ref's wait is also a `read_wait` span, summed in `read_wait_s`. The
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
from array import array
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from nos_tpu_torch import constants

# Dispatch kinds (TickProfiler.dispatch): the program a dispatch wraps,
# the names of the span log's dispatch records. The port's own, as are the
# span kinds: the reference's profiler has neither.
DISPATCH_PREFILL_CHUNK = "prefill_chunk"
DISPATCH_PREFILL_WINDOW = "prefill_window"
DISPATCH_PREFILL_LAST = "prefill_last"
DISPATCH_MACRO = "macro"
DISPATCH_BURST = "burst"
DISPATCH_VERIFY = "verify"
DISPATCH_SCATTER = "scatter"
DISPATCH_REVIVE = "revive"
DISPATCH_COW = "cow"
DISPATCH_KINDS = (
    DISPATCH_PREFILL_CHUNK,
    DISPATCH_PREFILL_WINDOW,
    DISPATCH_PREFILL_LAST,
    DISPATCH_MACRO,
    DISPATCH_BURST,
    DISPATCH_VERIFY,
    DISPATCH_SCATTER,
    DISPATCH_REVIVE,
    DISPATCH_COW,
)

# Span kinds of the span log: a tick, a tick phase (named by
# constants.TICK_PHASES), a dispatch (named by DISPATCH_KINDS), a
# host->device upload through HostStage, a blocking device->host wait.
SPAN_TICK = "tick"
SPAN_PHASE = "phase"
SPAN_DISPATCH = "dispatch"
SPAN_STAGE = "stage"
SPAN_READ_WAIT = "read_wait"



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

    __slots__ = ("prof", "name", "t0", "child", "rec")

    def __init__(self, prof: "TickProfiler", name: str):
        self.prof = prof
        self.name = name

    def __enter__(self):
        prof = self.prof
        self.t0 = prof._clock()
        self.child = 0.0
        self.rec = prof._open_span(SPAN_PHASE, self.name, self.t0)
        prof._stack.append(self)
        return self

    def __exit__(self, *exc):
        prof = self.prof
        t1 = prof._clock()
        dur = t1 - self.t0
        prof._stack.pop()
        prof._close_span(self.rec, t1)
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

    __slots__ = ("prof", "kind", "t0", "rec")

    def __init__(self, prof: "TickProfiler", kind: str):
        self.prof = prof
        self.kind = kind

    def __enter__(self):
        prof = self.prof
        self.t0 = prof._clock()
        self.rec = prof._open_span(SPAN_DISPATCH, self.kind, self.t0)
        prof._dispatching += 1
        return self

    def __exit__(self, *exc):
        prof = self.prof
        t1 = prof._clock()
        prof._dispatching -= 1
        prof._close_span(self.rec, t1)
        prof._tick_dispatch += t1 - self.t0
        return False


class _Span:
    """A `stage` or `read_wait` span on the ticking thread: one record in
    the span log. A read wait outside any dispatch also adds its duration
    to the tick's read-wait total; one inside a dispatch stays in
    `dispatch_s` alone, so no second counts twice."""

    __slots__ = ("prof", "kind", "t0", "rec", "wait")

    def __init__(self, prof: "TickProfiler", kind: str):
        self.prof = prof
        self.kind = kind

    def __enter__(self):
        prof = self.prof
        self.t0 = prof._clock()
        self.rec = prof._open_span(self.kind, self.kind, self.t0)
        self.wait = self.kind == SPAN_READ_WAIT and not prof._dispatching
        return self

    def __exit__(self, *exc):
        prof = self.prof
        t1 = prof._clock()
        prof._close_span(self.rec, t1)
        if self.wait:
            prof._tick_read_wait += t1 - self.t0
        return False


class TickProfiler:
    """Per-phase wall-time attribution for the engine tick.

    Usage (DecodeServer._tick): ``begin_tick()``, wrap each scheduler
    phase in ``with prof.phase(constants.TICK_PHASE_*)`` (nesting
    allowed — exclusive times), wrap every program invocation in
    ``with prof.dispatch(DISPATCH_*)``, then
    ``end_tick(metrics)``. Totals accumulate across ticks (``phase_s``,
    ``tick_wall_s``, ``dispatch_s``, ``host_overhead_s``,
    ``read_wait_s``); per-tick host-overhead and dispatch values also
    land in bounded sample deques so telemetry.ServingReport can pool
    them across replicas and re-derive fleet percentiles. ``end_tick``
    observes each phase's per-tick value into the
    ``nos_tpu_decode_tick_phase_seconds`` histogram (plus the
    tick/host-overhead/dispatch histograms) when a metrics registry is
    handed in.

    ``read_wait_s`` is the part of ``host_overhead_s`` the ticking thread
    spent blocked on device->host reads outside any dispatch
    (``read_wait()`` wraps the token refs' waits, ``stage()`` the
    HostStage uploads; both record on the ticking thread only), so the
    host's own work is ``host_overhead_s - read_wait_s``.

    The span log is a second view of the same enters and exits (no clock
    read of its own): one record a tick, phase, dispatch, stage and read
    wait (kind, name, start, end, tick number, the enclosing record's
    index), a ring of `span_capacity` records: past that each new record
    overwrites the oldest, counted in ``spans_dropped``, so the log
    always holds the latest ones. ``span_log()`` reads it out on the
    ``time.perf_counter_ns`` scale, and ``clock_pair()`` pairs that clock
    with the Unix-epoch one, so a reader can lay the spans beside a
    device trace.

    `clock` is injectable for deterministic tests; production uses
    time.perf_counter (monotonic, never a device sync)."""

    #: Span records a profiler keeps, 48 bytes each (24 MiB when full):
    #: half an hour of a serving engine at a few hundred spans a second.
    SPAN_CAPACITY = 1 << 19

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
        self.read_wait_s = 0.0
        self.phase_s: Dict[str, float] = {}
        self.host_overhead_samples: deque = deque(maxlen=int(max_samples))
        self.dispatch_samples: deque = deque(maxlen=int(max_samples))
        # The span log: 6 doubles a record (label code, start, end, tick,
        # parent's number, own number; numbers count every record opened),
        # record n at row n % span_capacity; labels are coded in first-use
        # order.
        self.span_capacity = self.SPAN_CAPACITY
        self.spans_dropped = 0
        self._log = array("d")
        self._n_spans = 0
        self._codes: Dict[Tuple[str, str], int] = {}
        self._open: List[int] = []
        #: `threading.get_ident()` of the thread that ran the latest tick
        #: (Kineto names the thread of a CUDA runtime call by the low 32
        #: bits of the same pthread id).
        self.thread_id: Optional[int] = None
        # Per-tick working state.
        self._tick_t0 = 0.0
        self._tick_rec = -1
        self._tick_dispatch = 0.0
        self._tick_read_wait = 0.0
        self._tick_phase: Dict[str, float] = {}
        self._stack: List[_Phase] = []
        self._dispatching = 0
        self._in_tick = False

    def phase(self, name: str):
        if not self.enabled or not self._in_tick:
            return _NOOP
        return _Phase(self, name)

    def dispatch(self, kind: str):
        """The context around one program invocation; `kind` is one of
        DISPATCH_KINDS."""
        if not self.enabled or not self._in_tick:
            return _NOOP
        return _Dispatch(self, kind)

    def stage(self):
        """The context around one host->device upload: pinning, the host
        copy and issuing the transfer."""
        return self._span(SPAN_STAGE)

    def read_wait(self):
        """The context around one blocking wait for a device->host read."""
        return self._span(SPAN_READ_WAIT)

    def _span(self, kind: str):
        # Other threads (a fleet supervisor's probe, a client's submit)
        # read and upload too; only the ticking thread's calls count.
        if not self.enabled or not self._in_tick or threading.get_ident() != self.thread_id:
            return _NOOP
        return _Span(self, kind)

    def _open_span(self, kind: str, name: str, t0: float) -> int:
        """Write an open record under the innermost open one, over the
        oldest once the log is full; returns its number."""
        n = self._n_spans
        code = self._codes.get((kind, name))
        if code is None:
            code = self._codes[(kind, name)] = len(self._codes)
        row = array("d", (code, t0, -1.0, self.ticks, self._open[-1] if self._open else -1, n))
        cap = self.span_capacity
        if n < cap:
            self._log.extend(row)
        else:
            at = 6 * (n % cap)
            self._log[at:at + 6] = row
            self.spans_dropped += 1
        self._n_spans = n + 1
        self._open.append(n)
        return n

    def _close_span(self, rec: int, t1: float) -> None:
        self._open.pop()
        if rec >= self._n_spans - self.span_capacity:  # not yet overwritten
            self._log[6 * (rec % self.span_capacity) + 2] = t1

    def begin_tick(self) -> None:
        if not self.enabled:
            return
        self._tick_t0 = self._clock()
        self._tick_dispatch = 0.0
        self._tick_read_wait = 0.0
        self._tick_phase = {}
        self._stack = []
        self._dispatching = 0
        self.thread_id = threading.get_ident()
        self._open = []
        self._tick_rec = self._open_span(SPAN_TICK, SPAN_TICK,
                                         self._tick_t0)
        self._in_tick = True

    def end_tick(self, metrics=None) -> None:
        if not self.enabled or not self._in_tick:
            return
        self._in_tick = False
        t1 = self._clock()
        wall = t1 - self._tick_t0
        self._close_span(self._tick_rec, t1)
        self.ticks += 1
        self.tick_wall_s += wall
        for name, v in self._tick_phase.items():
            self.phase_s[name] = self.phase_s.get(name, 0.0) + v
        dispatch = self._tick_dispatch
        host = max(0.0, wall - dispatch)
        self.dispatch_s += dispatch
        self.host_overhead_s += host
        self.read_wait_s += self._tick_read_wait
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

    def span_log(self) -> Dict[str, object]:
        """The span log as columns, one row a record in the order the spans
        opened: ``kind`` and ``name`` (lists of str), ``start_ns`` and
        ``end_ns`` (int64 arrays on the perf_counter_ns scale; ``end_ns``
        -1 while a span is open), ``tick`` and ``parent`` (int64 arrays,
        ``parent`` a row of this log, -1 for a tick or a parent already
        overwritten), and ``dropped`` (the records overwritten before the
        first row). Safe while the engine ticks: the log is copied in one
        call under the interpreter lock, and each row carries its number."""
        raw = self._log.tobytes()
        labels = {code: label for label, code in list(self._codes.items())}
        rows = np.frombuffer(raw, dtype=np.float64).reshape(-1, 6)
        number = rows[:, 5].astype(np.int64)
        first = int(number.min()) if len(number) else 0
        rows = rows[np.argsort(number, kind="stable")]
        codes = rows[:, 0].astype(np.int64).tolist()
        end = rows[:, 2]
        parent = rows[:, 4].astype(np.int64)
        return {
            "kind": [labels[c][0] for c in codes],
            "name": [labels[c][1] for c in codes],
            "start_ns": np.rint(rows[:, 1] * 1e9).astype(np.int64),
            "end_ns": np.where(end < 0, -1, np.rint(end * 1e9)).astype(np.int64),
            "tick": rows[:, 3].astype(np.int64),
            "parent": np.where(parent >= first, parent - first, -1),
            "dropped": first,
        }

    @staticmethod
    def clock_pair() -> Tuple[int, int]:
        """(``time.time_ns()``, ``time.perf_counter_ns()``) read together,
        the second the midpoint of two reads around the first. A reader
        takes one pair when a window opens and one when it closes, and
        maps span stamps onto the epoch clock between them."""
        p0 = time.perf_counter_ns()
        wall = time.time_ns()
        p1 = time.perf_counter_ns()
        return wall, (p0 + p1) // 2


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
