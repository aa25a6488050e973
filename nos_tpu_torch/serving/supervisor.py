"""Port of `nos_tpu/serving/supervisor.py`: the `SITE_*` call sites
(:96-114), `ReplicaFaultSpec` (:122), `ReplicaFaultInjector` (:153),
`FailoverReport` (:296) and `FleetSupervisor` (:308), copied near
verbatim (host-only code; only the imports point at the port).

FleetSupervisor: the fleet-level failure domain around the engine one.

A *single* DecodeServer has a complete failure model — taxonomy,
checkpoint/restore, surgical recovery, a seeded chaos gate. The fleet
plane built on top of it (ReplicaSet/PrefixRouter, drain/migrate,
FleetMonitor) still assumed every replica answers every call: a replica
whose host dies strands its futures forever, the router keeps scoring
it, and nothing re-homes its in-flight streams. This module is the same
discipline one scope up — the paper's operator treats node-agent loss as
eventually-reconciled spec/status; vLLM/SGLang-class fleets treat
replica death as a first-class drained-or-failed-over event. Three
layers:

  - **Guarded replica calls** — every cross-replica interaction
    (``probe``, ``submit``, ``transfer_in_checkpoint``,
    ``drain_extract``, shadow reconcile) routes through ONE supervised
    call wrapper: per-call timeout (a hung host is a failure, not a
    wait), capped jittered exponential backoff for TRANSIENT
    classifications, and classification through the engine's taxonomy
    (`classify_fault`) extended with the fleet-scope
    ``ReplicaUnreachableError`` — a call that exhausts its budget raises
    that, never the raw transport error.

  - **Replica health machine** — ``active -> suspect -> dead`` driven by
    CONSECUTIVE supervised-probe failures (the same sustained-breach
    shape as the SLOTracker: point blips never demote a replica).
    Suspect and dead replicas are excluded from router placement
    (`ReplicaHandle.admitting`); a suspect replica returns to ``active``
    only after a FULL healthy probe window (`recover_after` consecutive
    successes — no flapping). The seeded ``ReplicaFaultInjector``
    mirrors runtime/faults.py's named-site design (probe / submit /
    transfer_in / drain_extract, fail-before-work) for deterministic
    chaos tests.

  - **In-flight failover** — on ``dead``, the supervisor re-homes what
    it can. Streams with a last-known `SlotCheckpoint` (captured
    opportunistically: the engines' burst-boundary ``checkpoint_hook``
    plus a passive ``checkpoint_snapshot()`` ride-along on every probe)
    replay onto a surviving replica through the existing
    ``transfer_in_checkpoint`` path — serial + PRNG step preserved, so
    the client's stream finishes BIT-IDENTICALLY to the fault-free run
    (any checkpoint prefix is valid: the destination regenerates
    everything past the capture point, the replay-exactness
    argument). Streams with no checkpoint resolve with a classified
    ``ReplicaLostError`` CARRYING the request for client resubmit —
    never a silent hang. The dead replica's router shadow drops, tenant
    pins dissolve, and ``ReplicaSet.retire`` fires so the FleetMonitor's
    series-removal hygiene runs exactly as on graceful drain.

The supervisor is strictly OPT-IN: a fleet without one behaves
byte-identically to the pre-supervisor plane (health stays ``active``,
no hooks armed, no wrapper in any call path). Telemetry:
``nos_tpu_fleet_{replica_suspects,replica_deaths,failovers,
failover_replay_tokens,futures_failed_over,futures_errored}`` counters
plus pooled ``failover_latency`` samples through ``report()`` /
`ServingReport.merge`, a bounded `constants.FLEET_EVENTS` event log, and
a ``TRACE_EV_FAILOVER`` span edge so one trace id survives replica death
like it survives device-lost (docs/robustness.md "Fleet failure
domains").
"""

from __future__ import annotations

import logging
import random
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as _FutureTimeout
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from nos_tpu_torch import constants
from nos_tpu_torch.runtime.checkpoint import SlotCheckpoint
from nos_tpu_torch.runtime.faults import (
    FAULT_REPLICA_UNREACHABLE,
    FAULT_TRANSIENT,
    ReplicaLostError,
    ReplicaUnreachableError,
    TransientDispatchError,
    classify_fault,
)
from nos_tpu_torch.runtime.radix_tree import RadixTree
from nos_tpu_torch.serving.replica import ReplicaHandle, ReplicaSet
from nos_tpu_torch.serving.router import PrefixRouter
from nos_tpu_torch.telemetry import ServingReport, percentile

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# Named cross-replica call sites (the fleet analog of faults.SITES).
# Injection fires BEFORE the site's work, so an injected fault never
# leaves a half-submitted request or half-transferred checkpoint.
# ---------------------------------------------------------------------------
SITE_PROBE = "probe"
SITE_SUBMIT = "submit"
SITE_TRANSFER_IN = "transfer_in"
SITE_DRAIN_EXTRACT = "drain_extract"
# Phase-handoff boundaries (docs/disaggregation.md): the source-side
# publish of a finished prefill's KV chain into the fleet store, and
# the destination-side checkpoint revive. Each is a distinct failure
# surface — source death mid-publish vs destination death mid-revive —
# and the chaos suite injects at each independently.
SITE_HANDOFF_PUBLISH = "handoff_publish"
SITE_HANDOFF_REVIVE = "handoff_revive"
REPLICA_SITES = (
    SITE_PROBE,
    SITE_SUBMIT,
    SITE_TRANSFER_IN,
    SITE_DRAIN_EXTRACT,
    SITE_HANDOFF_PUBLISH,
    SITE_HANDOFF_REVIVE,
)

#: Kinds a ReplicaFaultSpec may inject: a transient blip (the wrapper's
#: backoff retries it) or hard unreachability (the wrapper escalates).
REPLICA_FAULT_KINDS = (FAULT_TRANSIENT, FAULT_REPLICA_UNREACHABLE)


@dataclass(frozen=True)
class ReplicaFaultSpec:
    """Fire a fleet-scope fault on the `occurrence`-th (1-based) visit
    of `site` on `replica`. `persistent=True` models HOST DEATH: once
    fired, every later call to that replica — any site — raises
    ReplicaUnreachableError until the injector is told otherwise
    (`revive`). Occurrences keep counting across recoveries, mirroring
    runtime/faults.FaultSpec."""

    replica: str
    site: str
    occurrence: int
    kind: str = FAULT_REPLICA_UNREACHABLE
    persistent: bool = False

    def __post_init__(self):
        if self.site not in REPLICA_SITES:
            raise ValueError(
                f"unknown replica site {self.site!r}; sites: {REPLICA_SITES}"
            )
        if self.kind not in REPLICA_FAULT_KINDS:
            raise ValueError(
                f"unknown fleet fault kind {self.kind!r}; "
                f"kinds: {REPLICA_FAULT_KINDS}"
            )
        if self.occurrence < 1:
            raise ValueError("occurrence is 1-based")
        if self.persistent and self.kind != FAULT_REPLICA_UNREACHABLE:
            raise ValueError("persistent (host-death) faults are unreachable")


@dataclass
class ReplicaFaultInjector:
    """Seeded, named-site fleet fault injection — the chaos harness the
    fleet failover gate drives. The supervisor calls
    `check(replica_id, site)` at every supervised call; the injector
    counts visits per (replica, site) and raises the scheduled fault on
    the matching occurrence, BEFORE the call's work. A replica in the
    `downed` set (a fired persistent spec, or an explicit `kill`)
    raises on EVERY visit — host death is a state, not an event."""

    schedule: Sequence[ReplicaFaultSpec] = ()
    armed: bool = True

    def __post_init__(self):
        self._pending: Dict[Tuple[str, str, int], ReplicaFaultSpec] = {
            (s.replica, s.site, s.occurrence): s for s in self.schedule
        }
        self._visits: Dict[Tuple[str, str], int] = {}
        self.downed: set = set()
        self.fired: List[ReplicaFaultSpec] = []

    def arm(self) -> None:
        self.armed = True

    def disarm(self) -> None:
        self.armed = False

    def kill(self, replica_id: str) -> None:
        """Down a replica directly (the bench's deterministic host
        kill): every later supervised call to it raises."""
        self.downed.add(replica_id)

    def revive(self, replica_id: str) -> None:
        """Bring a downed replica back (the recovery half of a
        suspect-then-recover chaos scenario)."""
        self.downed.discard(replica_id)

    def check(self, replica_id: str, site: str) -> None:
        if not self.armed:
            return
        key = (replica_id, site)
        self._visits[key] = self._visits.get(key, 0) + 1
        if replica_id in self.downed:
            raise ReplicaUnreachableError(
                f"injected: {replica_id} is down ({site})",
                site=site,
                replica=replica_id,
            )
        spec = self._pending.pop(
            (replica_id, site, self._visits[key]), None
        )
        if spec is None:
            return
        self.fired.append(spec)
        if spec.persistent:
            self.downed.add(replica_id)
        msg = (
            f"injected {spec.kind} fault at {replica_id}:{site}"
            f"#{spec.occurrence}"
        )
        if spec.kind == FAULT_TRANSIENT:
            raise TransientDispatchError(msg, site=site)
        raise ReplicaUnreachableError(msg, site=site, replica=replica_id)

    def visits(self, replica_id: str, site: str) -> int:
        return self._visits.get((replica_id, site), 0)

    def add(self, spec: ReplicaFaultSpec) -> None:
        """Add one spec to a live injector (with `visits`, a test can
        aim a fault at "the NEXT visit" after deterministic driving)."""
        self._pending[(spec.replica, spec.site, spec.occurrence)] = spec

    def has_pending(self) -> bool:
        return bool(self._pending) or bool(self.downed)

    @classmethod
    def seeded(
        cls,
        seed: int,
        replicas: Sequence[str],
        n_faults: int = 2,
        sites: Sequence[str] = REPLICA_SITES,
        max_occurrence: int = 8,
        kill_one: bool = True,
        armed: bool = True,
    ) -> "ReplicaFaultInjector":
        """A randomized-but-reproducible fleet schedule: transient blips
        across replicas x sites, plus (`kill_one`) one persistent
        host-death spec on the probe path — the shape the fleet chaos
        gate wants every seed to exercise."""
        rng = random.Random(seed)
        replicas = list(replicas)
        sites = list(sites)
        specs: List[ReplicaFaultSpec] = []
        taken = set()
        attempts = 0
        while len(specs) < n_faults and attempts < 100 * max(1, n_faults):
            attempts += 1
            rid = rng.choice(replicas)
            site = rng.choice(sites)
            occurrence = rng.randint(1, max_occurrence)
            if (rid, site, occurrence) in taken:
                continue
            taken.add((rid, site, occurrence))
            specs.append(
                ReplicaFaultSpec(rid, site, occurrence, FAULT_TRANSIENT)
            )
        if kill_one and replicas:
            rid = rng.choice(replicas)
            occurrence = rng.randint(2, max_occurrence)
            while (rid, SITE_PROBE, occurrence) in taken:
                occurrence += 1
            specs.append(
                ReplicaFaultSpec(
                    rid,
                    SITE_PROBE,
                    occurrence,
                    FAULT_REPLICA_UNREACHABLE,
                    persistent=True,
                )
            )
        return cls(schedule=specs, armed=armed)


@dataclass
class _TrackedStream:
    """What the supervisor remembers about one submitted stream — the
    request identity a `ReplicaLostError` must carry, keyed by the
    client Future the failover must resolve."""

    prompt: List[int]
    max_new: int
    tenant: Optional[str]
    future: Future
    trace_id: Optional[str] = None


@dataclass
class _Health:
    fail_streak: int = 0
    ok_streak: int = 0


@dataclass
class FailoverReport:
    """What one replica death moved: per-stream outcomes plus the
    latency of the whole failover (detection -> last stream placed)."""

    replica_id: str
    failed_over: int = 0
    errored: int = 0
    replay_tokens: int = 0
    latency_s: float = 0.0
    placements: List[Tuple[int, str]] = field(default_factory=list)


class FleetSupervisor:
    """The fleet failure domain. Construct it over an existing
    `ReplicaSet` + `PrefixRouter`, submit through it
    (`supervisor.submit(...)`), and give it a probe cadence (manual
    `probe()` in tests/bench, `start(interval_s)` in deployments).
    Thread-safe: health/tracking state mutates under one lock; engine
    queues remain the cross-thread boundary for requests themselves."""

    def __init__(
        self,
        replica_set: ReplicaSet,
        router: PrefixRouter,
        suspect_after: int = 2,
        dead_after: int = 4,
        recover_after: int = 3,
        call_timeout_s: Optional[float] = None,
        max_call_retries: int = 2,
        backoff_base_s: float = 0.01,
        backoff_cap_s: float = 0.25,
        jitter_seed: int = 0,
        fault_injector: Optional[ReplicaFaultInjector] = None,
        metrics=None,
        ledger=None,
        max_events: int = 256,
        interval_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
        sleep: Optional[Callable[[float], None]] = None,
        arm_checkpoint_hooks: bool = True,
    ):
        """`suspect_after`/`dead_after` are CONSECUTIVE supervised-probe
        failure counts (dead_after counted from the first failure of the
        streak, so dead_after > suspect_after); `recover_after` is the
        full healthy window a suspect must clear before it is routed to
        again. `call_timeout_s` bounds every supervised call (None =
        no timeout — deterministic tests); timeouts classify transient
        and retry up to `max_call_retries` under capped jittered
        exponential backoff (`backoff_base_s` doubling to
        `backoff_cap_s`, jitter seeded by `jitter_seed` so chaos runs
        reproduce). `sleep` is injectable so tests pay no wall clock.
        `arm_checkpoint_hooks` wires each engine's burst-boundary
        checkpoint hook into this supervisor's last-known table
        (engines without the hook are probed-captured only).

        `ledger` (optional, serving/accounting.py CostLedger — the one
        shared with the fleet's engines) closes the cost receipt of
        every stream this supervisor ERROR-resolves (a dead replica's
        uncheckpointed stream, or a submit racing a death) with a
        FAILED status: those streams never reach an engine's finish/
        failure terminus, so without the hook their receipts would sit
        open forever. Failed-over streams need nothing here — their
        receipts close on the survivor that finishes them."""
        if not (1 <= suspect_after < dead_after):
            raise ValueError(
                f"need 1 <= suspect_after < dead_after, got "
                f"{suspect_after}/{dead_after}"
            )
        if recover_after < 1:
            raise ValueError("recover_after is a count of successes, >= 1")
        self.replica_set = replica_set
        self.router = router
        self.suspect_after = int(suspect_after)
        self.dead_after = int(dead_after)
        self.recover_after = int(recover_after)
        self.call_timeout_s = call_timeout_s
        self.max_call_retries = int(max_call_retries)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self._jitter = random.Random(jitter_seed)
        self.fault_injector = fault_injector
        self.metrics = metrics
        self.ledger = ledger
        self.interval_s = float(interval_s)
        self._clock = clock
        self._sleep = sleep if sleep is not None else time.sleep
        self._lock = threading.RLock()
        # Sweeps serialize on their own lock so concurrent probe()
        # callers (manual + background cadence) cannot double-count a
        # failure streak, WITHOUT holding the state lock across the
        # supervised calls themselves.
        self._probe_lock = threading.Lock()
        self._health: Dict[str, _Health] = {}
        # Per-replica stream tracking: replica id -> {id(future): stream}
        # and the last-known checkpoint per stream, same key. Checkpoints
        # are keyed by FUTURE identity because the future is the one
        # object that survives re-homing unchanged.
        self._streams: Dict[str, Dict[int, _TrackedStream]] = {}
        self._checkpoints: Dict[str, Dict[int, SlotCheckpoint]] = {}
        # Fleet failure-domain counters (telemetry satellite).
        self.replica_suspects = 0
        self.replica_deaths = 0
        self.failovers = 0
        self.failover_replay_tokens = 0
        self.futures_failed_over = 0
        self.futures_errored = 0
        self.supervised_calls = 0
        self.supervised_retries = 0
        self.failover_latency_s: List[float] = []
        self.events = deque(maxlen=int(max_events))
        self._thread: Optional[threading.Thread] = None
        self._stop_ev = threading.Event()
        if arm_checkpoint_hooks:
            for h in self.replica_set.handles:
                setter = getattr(h.engine, "set_checkpoint_hook", None)
                if setter is not None:
                    setter(self._checkpoint_hook_for(h.replica_id))

    # -- guarded calls --------------------------------------------------------
    def _backoff_delay(self, attempt: int) -> float:
        """Capped jittered exponential: base * 2^(attempt-1), capped,
        scaled by a seeded jitter in [0.5, 1.0) — decorrelates fleet
        retry storms without derailing deterministic tests."""
        raw = min(self.backoff_cap_s, self.backoff_base_s * (2 ** (attempt - 1)))
        return raw * (0.5 + 0.5 * self._jitter.random())

    def _call_with_timeout(self, fn, args, kwargs):
        if self.call_timeout_s is None:
            return fn(*args, **kwargs)
        box: Future = Future()

        def runner():
            try:
                box.set_result(fn(*args, **kwargs))
            except BaseException as exc:  # nos-lint: ignore[NOS012] — not a
                # swallow: the exception is DELIVERED through the box and
                # re-raised in supervised_call's caller thread, where it
                # classifies through the taxonomy like an inline failure.
                box.set_exception(exc)

        t = threading.Thread(target=runner, daemon=True)
        t.start()
        try:
            return box.result(timeout=self.call_timeout_s)
        except _FutureTimeout:
            # The worker thread is abandoned (in-process calls cannot be
            # cancelled); classification below treats the timeout as
            # transient — "timed out" is a taxonomy transport marker.
            raise TimeoutError(
                f"supervised call timed out after {self.call_timeout_s}s"
            ) from None

    def supervised_call(self, handle: ReplicaHandle, site: str, fn, *args, **kwargs):
        """THE one wrapper every cross-replica interaction routes
        through: injector check (fail-before-work), per-call timeout,
        classification through the taxonomy, capped jittered backoff
        on TRANSIENT, and escalation to `ReplicaUnreachableError` (the
        fleet-scope kind) when the budget is exhausted or the failure
        was never transient to begin with."""
        rid = handle.replica_id
        attempt = 0
        self.supervised_calls += 1
        while True:
            try:
                if self.fault_injector is not None:
                    self.fault_injector.check(rid, site)
                return self._call_with_timeout(fn, args, kwargs)
            except Exception as exc:
                kind = classify_fault(exc)
                if kind == FAULT_TRANSIENT and attempt < self.max_call_retries:
                    attempt += 1
                    self.supervised_retries += 1
                    self._sleep(self._backoff_delay(attempt))
                    continue
                raise ReplicaUnreachableError(
                    f"{site} on {rid} failed ({kind}) after "
                    f"{attempt} retries",
                    site=site,
                    replica=rid,
                ) from exc

    # -- ingress --------------------------------------------------------------
    def submit(
        self,
        prompt: Sequence[int],
        max_new: int = 16,
        tenant: Optional[str] = None,
    ) -> Future:
        """The supervised fleet front end: route, submit through the
        guarded wrapper, and TRACK the stream so a later replica death
        can re-home or classify it. An unreachable submit marks a
        probe-equivalent failure against the replica and retries the
        next candidate — the client never sees a placement-time flake."""
        tried: List[ReplicaHandle] = []
        last_exc: Optional[Exception] = None
        for _ in range(max(1, len(self.replica_set.handles))):
            try:
                handle = self.router.select(prompt, tenant=tenant, exclude=tried)
            except RuntimeError as exc:
                # Every candidate tried or excluded: surface the most
                # informative error (the last unreachable, if any).
                if last_exc is not None:
                    raise last_exc from exc
                raise
            trace_id = None
            if self.router.tracer is not None:
                trace_id = self.router.tracer.new_trace()
                self.router.tracer.event(
                    trace_id,
                    constants.TRACE_EV_ROUTER_SELECT,
                    replica=handle.replica_id,
                )
            try:
                fut = self.supervised_call(
                    handle,
                    SITE_SUBMIT,
                    handle.engine.submit,
                    prompt,
                    max_new,
                    tenant=tenant,
                    trace_id=trace_id,
                )
            except ReplicaUnreachableError as exc:
                last_exc = exc
                with self._lock:
                    self._note_failure_locked(handle, exc)
                tried.append(handle)
                continue
            with self._lock:
                if (
                    handle.state == constants.REPLICA_STATE_RETIRED
                    or handle.health == constants.REPLICA_HEALTH_DEAD
                ):
                    # Lost the race with the prober: the replica died
                    # (its failover already swept the tracking tables
                    # and forsook the engine queue) between the
                    # successful engine.submit and this lock. Tracking
                    # now would file the stream under a retired key no
                    # failover will ever visit — the silent hang this
                    # module exists to prevent. Resolve it like any
                    # uncheckpointed stream on a dead replica:
                    # classified, carrying the request for resubmit.
                    exc = ReplicaLostError(
                        f"replica {handle.replica_id} died during "
                        "submit; resubmit the attached request",
                        replica=handle.replica_id,
                        prompt=list(prompt),
                        max_new=max_new,
                        tenant=tenant,
                        trace_id=trace_id,
                    )
                    try:
                        fut.set_exception(exc)
                        self.futures_errored += 1
                        if self.metrics is not None:
                            self.metrics.inc("nos_tpu_fleet_futures_errored")
                        if self.ledger is not None:
                            # Failure terminus for the accounting
                            # plane: no engine will ever close this
                            # stream's receipt.
                            self.ledger.close_request(
                                trace_id,
                                tenant,
                                status=constants.RECEIPT_STATUS_FAILED,
                                tokens=0,
                            )
                        self._event_locked(
                            constants.FLEET_EV_FAILOVER,
                            replica=handle.replica_id,
                            failed_over=0,
                            errored=1,
                            replay_tokens=0,
                        )
                    except InvalidStateError:
                        pass  # the engine resolved it first: keep that
                    return fut
                self._streams.setdefault(handle.replica_id, {})[id(fut)] = (
                    _TrackedStream(
                        prompt=list(prompt),
                        max_new=max_new,
                        tenant=tenant,
                        future=fut,
                        trace_id=trace_id,
                    )
                )
            return fut
        raise last_exc if last_exc is not None else RuntimeError(
            "no admitting replica: cannot submit"
        )

    # -- checkpoint capture ---------------------------------------------------
    def _checkpoint_hook_for(self, replica_id: str):
        def hook(cks: List[SlotCheckpoint]) -> None:
            with self._lock:
                self._absorb_checkpoints_locked(replica_id, cks)

        return hook

    def _absorb_checkpoints_locked(
        self, replica_id: str, cks: List[SlotCheckpoint]
    ) -> None:
        table = self._checkpoints.setdefault(replica_id, {})
        for ck in cks:
            if ck.future is None or ck.future.done():
                continue
            table[id(ck.future)] = ck
        # Prune entries whose stream resolved (bounded by construction:
        # one entry per OUTSTANDING future) — the stream tracking too,
        # or a long-running fleet retains every request it ever served
        # and each failover walks that whole history.
        for key in [k for k, c in table.items() if c.future.done()]:
            del table[key]
        streams = self._streams.get(replica_id)
        if streams:
            for key in [k for k, s in streams.items() if s.future.done()]:
                del streams[key]

    # -- health machine -------------------------------------------------------
    def probe(self) -> Dict[str, str]:
        """One supervised health sweep over every non-retired replica:
        probe + passive checkpoint ride-along through the guarded
        wrapper, success/failure folded into the health machine, DEAD
        transitions fire failover inline. Returns the health map.

        The supervised calls run OUTSIDE the state lock (a sweep-only
        lock serializes concurrent probers): an unreachable replica
        costs up to (timeout + backoff) x retries per call, and holding
        the state lock through that would stall every healthy engine's
        burst-boundary checkpoint hook and every submit() — a
        fleet-wide pause exactly during failure handling. Each result
        folds into the health machine under the state lock afterwards,
        re-checking the handle (a concurrent `mark_dead`/retire may
        have raced the call)."""
        with self._probe_lock:
            with self._lock:
                targets: List[ReplicaHandle] = []
                for handle in list(self.replica_set.handles):
                    rid = handle.replica_id
                    if handle.state == constants.REPLICA_STATE_RETIRED:
                        # Retirement hygiene. Failover retirement
                        # resolved/re-homed every tracked future before
                        # retiring, and graceful drain re-homed each
                        # stream with its client Future INTACT — so
                        # dropping the tracking here strands nothing.
                        self._streams.pop(rid, None)
                        self._checkpoints.pop(rid, None)
                        continue
                    if handle.health == constants.REPLICA_HEALTH_DEAD:
                        continue
                    targets.append(handle)
            for handle in targets:
                engine = handle.engine

                def _probe_and_capture(engine=engine):
                    p = engine.probe()
                    capture = getattr(engine, "checkpoint_snapshot", None)
                    cks = capture() if capture is not None else []
                    return p, cks

                try:
                    _, cks = self.supervised_call(
                        handle, SITE_PROBE, _probe_and_capture
                    )
                except ReplicaUnreachableError as exc:
                    with self._lock:
                        if handle.state != constants.REPLICA_STATE_RETIRED:
                            self._note_failure_locked(handle, exc)
                    continue
                with self._lock:
                    if handle.state == constants.REPLICA_STATE_RETIRED:
                        continue
                    self._absorb_checkpoints_locked(handle.replica_id, cks)
                    self._note_success_locked(handle)
            with self._lock:
                return {
                    h.replica_id: h.health
                    for h in self.replica_set.handles
                    if h.state != constants.REPLICA_STATE_RETIRED
                }

    def health(self, replica_id: str) -> str:
        return self.replica_set.get(replica_id).health

    def _event_locked(self, event: str, **payload) -> None:
        self.events.append({"event": event, "t": self._clock(), **payload})

    def _note_failure_locked(
        self, handle: ReplicaHandle, exc: Exception
    ) -> None:
        st = self._health.setdefault(handle.replica_id, _Health())
        st.fail_streak += 1
        st.ok_streak = 0
        if (
            handle.health == constants.REPLICA_HEALTH_ACTIVE
            and st.fail_streak >= self.suspect_after
        ):
            handle.health = constants.REPLICA_HEALTH_SUSPECT
            self.replica_suspects += 1
            if self.metrics is not None:
                self.metrics.inc("nos_tpu_fleet_replica_suspects")
            self._event_locked(
                constants.FLEET_EV_SUSPECT,
                replica=handle.replica_id,
                streak=st.fail_streak,
                kind=classify_fault(exc),
            )
        if (
            handle.health == constants.REPLICA_HEALTH_SUSPECT
            and st.fail_streak >= self.dead_after
        ):
            # Mark dead FIRST: the router must refuse the replica before
            # any failover re-homing selects destinations.
            handle.health = constants.REPLICA_HEALTH_DEAD
            self.replica_deaths += 1
            if self.metrics is not None:
                self.metrics.inc("nos_tpu_fleet_replica_deaths")
            self._event_locked(
                constants.FLEET_EV_DEATH,
                replica=handle.replica_id,
                streak=st.fail_streak,
            )
            self._fail_over_locked(handle)

    def _note_success_locked(self, handle: ReplicaHandle) -> None:
        st = self._health.setdefault(handle.replica_id, _Health())
        st.ok_streak += 1
        st.fail_streak = 0
        if (
            handle.health == constants.REPLICA_HEALTH_SUSPECT
            and st.ok_streak >= self.recover_after
        ):
            # Re-admission requires the FULL healthy window — a suspect
            # that answers once is not yet a replica to route to.
            handle.health = constants.REPLICA_HEALTH_ACTIVE
            self._event_locked(
                constants.FLEET_EV_RECOVERED,
                replica=handle.replica_id,
                window=st.ok_streak,
            )

    # -- failover -------------------------------------------------------------
    def _fail_over_locked(self, handle: ReplicaHandle) -> FailoverReport:
        rid = handle.replica_id
        t0 = self._clock()
        report = FailoverReport(replica_id=rid)
        streams = self._streams.pop(rid, {})
        cks = self._checkpoints.pop(rid, {})
        for key, stream in streams.items():
            if stream.future.done():
                continue
            ck = cks.get(key)
            placed = (
                self._fail_over_stream_locked(handle, stream, ck, report)
                if ck is not None
                else None
            )
            if placed is None:
                exc = ReplicaLostError(
                    f"replica {rid} died"
                    + (
                        " before any checkpoint of this stream"
                        if ck is None
                        else " and no surviving replica accepted its checkpoint"
                    )
                    + "; resubmit the attached request",
                    replica=rid,
                    prompt=stream.prompt,
                    max_new=stream.max_new,
                    tenant=stream.tenant,
                    trace_id=stream.trace_id,
                )
                try:
                    stream.future.set_exception(exc)
                except InvalidStateError:
                    continue  # resolved while we were failing over
                report.errored += 1
                self.futures_errored += 1
                if self.metrics is not None:
                    self.metrics.inc("nos_tpu_fleet_futures_errored")
                if self.ledger is not None:
                    # Failure terminus for the accounting plane: the
                    # dead replica can no longer close this receipt.
                    self.ledger.close_request(
                        stream.trace_id,
                        stream.tenant,
                        status=constants.RECEIPT_STATUS_FAILED,
                        tokens=0,
                    )
        # Placement hygiene, exactly as on graceful drain: the dead
        # replica's shadow drops (its cache is gone with the host),
        # tenant pins dissolve, and retirement triggers the monitor's
        # per-replica series removal on its next sample.
        handle.shadow.clear()
        handle.shadow_tree = RadixTree()
        self.router.dissolve_pins(rid)
        try:
            forsake = getattr(handle.engine, "forsake", None)
            if forsake is not None:
                forsake()
        except Exception as exc:
            logger.warning(
                "failover(%s): forsake failed (%s); retiring anyway",
                rid,
                classify_fault(exc),
            )
        self.replica_set.retire(rid)
        report.latency_s = self._clock() - t0
        self.failover_latency_s.append(report.latency_s)
        if self.metrics is not None:
            self.metrics.observe("nos_tpu_fleet_failover_latency", report.latency_s)
        self._event_locked(
            constants.FLEET_EV_FAILOVER,
            replica=rid,
            failed_over=report.failed_over,
            errored=report.errored,
            replay_tokens=report.replay_tokens,
        )
        return report

    def _fail_over_stream_locked(
        self,
        src: ReplicaHandle,
        stream: _TrackedStream,
        ck: SlotCheckpoint,
        report: FailoverReport,
    ) -> Optional[ReplicaHandle]:
        """Re-home one checkpointed stream onto a surviving replica;
        walks candidates (a destination that fails mid-transfer is
        excluded and the next one tried — never a vanished stream).
        Returns the destination, or None when no survivor accepted."""
        tried: List[ReplicaHandle] = [src]
        while True:
            try:
                # A failed-over stream resumes DECODING (its prefill —
                # original or replayed — runs wherever it lands), so the
                # placement is a decode-phase decision: decode/unified
                # roles only, device-then-store hit scoring. On an
                # all-unified fleet this is byte-identical to the
                # pre-disaggregation select.
                dst = self.router.select(
                    ck.replay_prompt(),
                    tenant=ck.tenant,
                    exclude=tried,
                    phase=constants.ROUTER_PHASE_DECODE,
                )
            except RuntimeError:
                return None
            try:
                self.supervised_call(
                    dst,
                    SITE_TRANSFER_IN,
                    dst.engine.transfer_in_checkpoint,
                    ck,
                )
            except ReplicaUnreachableError:
                # The destination's own probe cadence will demote it;
                # here it simply stops being a candidate for THIS stream.
                tried.append(dst)
                continue
            self.failovers += 1
            self.futures_failed_over += 1
            self.failover_replay_tokens += len(ck.generated)
            report.failed_over += 1
            report.replay_tokens += len(ck.generated)
            report.placements.append((ck.serial, dst.replica_id))
            if self.metrics is not None:
                self.metrics.inc("nos_tpu_fleet_failovers")
                self.metrics.inc("nos_tpu_fleet_futures_failed_over")
                self.metrics.inc(
                    "nos_tpu_fleet_failover_replay_tokens", len(ck.generated)
                )
            if self.router.tracer is not None and ck.trace_id is not None:
                # One trace survives replica death like it survives
                # device-lost: the failover is an edge on the stream's
                # existing span chain.
                self.router.tracer.event(
                    ck.trace_id,
                    constants.TRACE_EV_FAILOVER,
                    src=src.replica_id,
                    dst=dst.replica_id,
                    replayed=len(ck.generated),
                )
            # The stream (and its last checkpoint) now live on dst.
            self._streams.setdefault(dst.replica_id, {})[
                id(stream.future)
            ] = stream
            self._checkpoints.setdefault(dst.replica_id, {})[
                id(stream.future)
            ] = ck
            return dst

    def mark_dead(self, replica_id: str) -> FailoverReport:
        """Operator/exterior kill switch: skip the probe streak and
        fail the replica over NOW (the monitor or an orchestrator saw
        something probes have not)."""
        with self._lock:
            handle = self.replica_set.get(replica_id)
            if handle.health == constants.REPLICA_HEALTH_DEAD:
                return FailoverReport(replica_id=replica_id)
            handle.health = constants.REPLICA_HEALTH_DEAD
            self.replica_deaths += 1
            if self.metrics is not None:
                self.metrics.inc("nos_tpu_fleet_replica_deaths")
            self._event_locked(constants.FLEET_EV_DEATH, replica=replica_id, streak=0)
            return self._fail_over_locked(handle)

    # -- stream tracking for out-of-band ingress ------------------------------
    def track_stream(
        self,
        handle: ReplicaHandle,
        prompt: Sequence[int],
        max_new: int,
        tenant: Optional[str],
        future: Future,
        trace_id: Optional[str] = None,
    ) -> None:
        """Track a stream submitted to `handle` OUTSIDE supervisor
        .submit (the disaggregation coordinator's prefill-phase
        ingress, serving/disagg.py): the failover walk covers it from
        admission — a replica dying with this stream pre-checkpoint
        resolves it classified-with-request, never a hang."""
        with self._lock:
            self._streams.setdefault(handle.replica_id, {})[id(future)] = (
                _TrackedStream(
                    prompt=list(prompt),
                    max_new=max_new,
                    tenant=tenant,
                    future=future,
                    trace_id=trace_id,
                )
            )

    def untrack_stream(self, replica_id: str, future: Future) -> None:
        """Withdraw a stream from `replica_id`'s tracking tables — the
        handoff coordinator owns it for the duration of the transfer
        window, so a concurrent failover of the source must not ALSO
        try to resolve it (the at-most-once ownership rule:
        docs/disaggregation.md, failure matrix)."""
        with self._lock:
            key = id(future)
            streams = self._streams.get(replica_id)
            if streams:
                streams.pop(key, None)
            cks = self._checkpoints.get(replica_id)
            if cks:
                cks.pop(key, None)

    def adopt_stream(
        self,
        dst: ReplicaHandle,
        ck: SlotCheckpoint,
        src: Optional[ReplicaHandle] = None,
    ) -> None:
        """Register a stream that arrived on `dst` OUTSIDE the
        supervised submit path (a phase handoff — the coordinator in
        serving/disagg.py placed the source's checkpoint here): tracked
        under the destination exactly like a submit-time stream, so a
        later `dst` death re-homes or classifies it through the same
        failover walk. The checkpoint rides along as the stream's
        newest capture — a death BEFORE dst's first burst-boundary
        checkpoint still re-homes from the handoff image instead of
        erroring as never-checkpointed. Passing `src` completes the
        ownership transfer: the stream leaves the source's tables in
        the same locked step it enters the destination's. A stream
        already resolved (or detached from any client future) has
        nothing to track."""
        if ck.future is None:
            return
        with self._lock:
            key = id(ck.future)
            if src is not None:
                streams = self._streams.get(src.replica_id)
                if streams:
                    streams.pop(key, None)
                cks = self._checkpoints.get(src.replica_id)
                if cks:
                    cks.pop(key, None)
            if ck.future.done():
                return
            self._streams.setdefault(dst.replica_id, {})[key] = _TrackedStream(
                prompt=list(ck.prompt),
                max_new=ck.max_new,
                tenant=ck.tenant,
                future=ck.future,
                trace_id=ck.trace_id,
            )
            self._checkpoints.setdefault(dst.replica_id, {})[key] = ck

    # -- background cadence ---------------------------------------------------
    def start(self) -> "FleetSupervisor":
        if self._thread is not None:
            return self
        self._stop_ev.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop_ev.wait(self.interval_s):
            try:
                self.probe()
            except Exception as exc:
                # The supervisor must never die silently with the fleet
                # it guards: classify and keep probing.
                logger.exception(
                    "fleet supervisor probe sweep failed (%s)",
                    classify_fault(exc),
                )

    def stop(self) -> None:
        self._stop_ev.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    # -- telemetry ------------------------------------------------------------
    def report(self) -> ServingReport:
        """The supervisor's counters as a poolable ServingReport
        (replicas=0: the supervisor is not a replica). Merge it with
        `ReplicaSet.fleet_report()` for the one-fleet view; percentiles
        re-derive from the pooled samples per the merge contract."""
        with self._lock:
            samples = list(self.failover_latency_s)
            return ServingReport(
                replicas=0,
                tp_devices=0,
                replica_suspects=self.replica_suspects,
                replica_deaths=self.replica_deaths,
                failovers=self.failovers,
                failover_replay_tokens=self.failover_replay_tokens,
                futures_failed_over=self.futures_failed_over,
                futures_errored=self.futures_errored,
                failover_latency_p50_s=percentile(samples, 50),
                failover_latency_p95_s=percentile(samples, 95),
                failover_latency_samples=samples,
            )

    def snapshot(self) -> Dict[str, object]:
        """Wire-format view: health map, counters, bounded events."""
        with self._lock:
            return {
                "health": {
                    h.replica_id: h.health for h in self.replica_set.handles
                },
                "replica_suspects": self.replica_suspects,
                "replica_deaths": self.replica_deaths,
                "failovers": self.failovers,
                "failover_replay_tokens": self.failover_replay_tokens,
                "futures_failed_over": self.futures_failed_over,
                "futures_errored": self.futures_errored,
                "supervised_calls": self.supervised_calls,
                "supervised_retries": self.supervised_retries,
                "tracked_streams": {
                    rid: len(v) for rid, v in self._streams.items()
                },
                "events": list(self.events),
            }
