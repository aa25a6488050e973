"""Port of `nos_tpu/serving/disagg.py`: phase-disaggregated serving,
copied near verbatim with the port's imports. `HandoffCoordinator` (:88)
routes each request's prefill to a prefill-role replica (`submit`, :166;
the router's phase-aware select), arms every engine's prefill-complete
handoff hook (`arm`/`detach`, :137-150) and re-homes each finished
prefill onto a decode placement through `transfer_in_checkpoint`
(`_on_prefill_complete`, :230).

The handoff: a prefill replica admits the request with `handoff=True`,
runs its prompt through the budgeted prefill and, in the wave of its
final chunk, captures the slot as a `SlotCheckpoint` (first token
materialized), publishes its prompt chain to the shared `FleetKVStore`
(`BlockManager.publish_slot_chain`), releases the slot and hands the
checkpoint to this coordinator on the engine's thread. The coordinator
places it on a decode replica, whose admission stages the published
chain as store revives (`handoff_revived_tokens`: the KV was shipped, not
recomputed) while the stream keeps its Future, serial and PRNG step. The
transfer is a checkpoint restore, so disaggregated serving equals
colocated serving bit for bit on one program shape, and a store miss at
the destination degrades to recompute of the missing blocks, the same
tokens. The transfer window is supervised: `SITE_HANDOFF_PUBLISH` (the
source dies mid-publish: marked dead, the checkpoint placed on a
survivor) and `SITE_HANDOFF_REVIVE` (the destination dies mid-revive:
excluded, the next candidate tried); exhaustion resolves the future with
a classified `ReplicaLostError` carrying the request (`_fail_handoff`,
:336), never a hang. `report` (:368) and `snapshot` (:389) give the
coordinator's counters; the `nos_tpu_fleet_handoff_*` series go to the
`metrics` registry.

The hook runs on the source engine's thread and calls into the
destination: the destination engine's queue is the cross-thread
boundary, so several engine threads on one card need no more than
`transfer_in_checkpoint`'s put.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Callable, Dict, List, Optional, Sequence

from nos_tpu_torch import constants
from nos_tpu_torch.runtime.checkpoint import SlotCheckpoint
from nos_tpu_torch.runtime.faults import (
    ReplicaLostError,
    ReplicaUnreachableError,
    classify_fault,
)
from nos_tpu_torch.serving.replica import ReplicaHandle, ReplicaSet
from nos_tpu_torch.serving.router import PrefixRouter
from nos_tpu_torch.serving.supervisor import (
    SITE_HANDOFF_PUBLISH,
    SITE_HANDOFF_REVIVE,
    SITE_SUBMIT,
    FleetSupervisor,
)
from nos_tpu_torch.telemetry import ServingReport, percentile

logger = logging.getLogger(__name__)


class HandoffCoordinator:
    """The fleet front end for phase-disaggregated serving: routes each
    request's PREFILL (phase-aware select), arms every engine's
    prefill-complete handoff hook, and re-homes each finished prefill
    onto a DECODE placement through `transfer_in_checkpoint`.

    Supervision is optional exactly as everywhere else in the fleet
    plane: with a `FleetSupervisor`, every cross-replica call routes
    through its guarded wrapper (timeout/retry/classification, fault
    injection at the two handoff sites), streams are tracked from
    admission, and ownership transfers source -> coordinator ->
    destination so a replica dying anywhere in the window resolves the
    stream on a survivor or classified — never a hang. Without one,
    calls are direct and a failed handoff resolves the future
    classified immediately.

    The hook fires on the SOURCE ENGINE'S THREAD, so everything in
    `_on_prefill_complete` must be queue-puts, lock-scoped counter
    bumps, and (worst case) a failover walk — no blocking on the
    source engine itself."""

    def __init__(
        self,
        replica_set: ReplicaSet,
        router: PrefixRouter,
        supervisor: Optional[FleetSupervisor] = None,
        metrics=None,
        max_events: int = 256,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.replica_set = replica_set
        self.router = router
        self.supervisor = supervisor
        self.metrics = metrics
        self._clock = clock
        self._lock = threading.Lock()
        # Coordinator-scope counters (engine-scope handoff counters —
        # exports/ingests/published blocks/revived tokens — live on the
        # engines and pool through collect_serving).
        self.handoffs = 0
        self.handoff_reroutes = 0
        self.handoffs_errored = 0
        self.handoff_wall_s = 0.0
        self.handoff_latency_s: List[float] = []
        self.events: deque = deque(maxlen=max_events)
        for handle in replica_set.handles:
            self.arm(handle)

    # -- wiring ---------------------------------------------------------------
    def arm(self, handle: ReplicaHandle) -> None:
        """Arm `handle`'s prefill-complete hook. Replicas added to the
        set after construction must be armed here too, or their
        handoff-marked slots decode in place (unified behavior — the
        marker is inert without a hook)."""
        handle.engine.set_handoff_hook(self._hook_for(handle))

    def detach(self) -> None:
        """Disarm every engine's hook (shutdown hygiene: a hook firing
        into a dismantled coordinator would re-home onto a retired
        fleet)."""
        for handle in self.replica_set.handles:
            handle.engine.set_handoff_hook(None)

    def _hook_for(self, src: ReplicaHandle):
        def hook(ck: SlotCheckpoint) -> None:
            self._on_prefill_complete(src, ck)

        return hook

    def _supervised(self, handle: ReplicaHandle, site: str, fn, *args, **kwargs):
        if self.supervisor is not None:
            return self.supervisor.supervised_call(handle, site, fn, *args, **kwargs)
        return fn(*args, **kwargs)

    def _event(self, event: str, **payload) -> None:
        self.events.append({"event": event, "t": self._clock(), **payload})

    # -- ingress --------------------------------------------------------------
    def submit(
        self,
        prompt: Sequence[int],
        max_new: int = 16,
        tenant: Optional[str] = None,
    ) -> Future:
        """Place the PREFILL: phase-aware select over prefill/unified
        roles, admission with the handoff marker. An unreachable
        submit excludes the candidate and tries the next — the client
        never sees a placement-time flake. The returned Future resolves
        on whatever replica ultimately finishes the decode."""
        tried: List[ReplicaHandle] = []
        last_exc: Optional[Exception] = None
        for _ in range(max(1, len(self.replica_set.handles))):
            try:
                src = self.router.select(
                    prompt,
                    tenant=tenant,
                    exclude=tried,
                    phase=constants.ROUTER_PHASE_PREFILL,
                )
            except RuntimeError as exc:
                if last_exc is not None:
                    raise last_exc from exc
                raise
            trace_id = None
            if self.router.tracer is not None:
                trace_id = self.router.tracer.new_trace()
                self.router.tracer.event(
                    trace_id,
                    constants.TRACE_EV_ROUTER_SELECT,
                    replica=src.replica_id,
                    phase=constants.ROUTER_PHASE_PREFILL,
                )
            fut: Future = Future()
            try:
                self._supervised(
                    src,
                    SITE_SUBMIT,
                    src.engine.transfer_in_request,
                    prompt,
                    max_new,
                    tenant=tenant,
                    future=fut,
                    trace_id=trace_id,
                    handoff=True,
                )
            except (ReplicaUnreachableError, RuntimeError) as exc:
                # RuntimeError: the engine closed admission between the
                # select and the put (drain/stop race) — same treatment
                # as unreachable: not a candidate for THIS request.
                last_exc = exc
                tried.append(src)
                continue
            if self.supervisor is not None:
                self.supervisor.track_stream(
                    src, prompt, max_new, tenant, fut, trace_id
                )
            return fut
        raise last_exc if last_exc is not None else RuntimeError(
            "no admitting prefill-capable replica: cannot submit"
        )

    # -- the transfer window --------------------------------------------------
    def _on_prefill_complete(self, src: ReplicaHandle, ck: SlotCheckpoint) -> None:
        """Own the stream across the transfer window. Entry state: the
        source captured `ck` (first token materialized), force-published
        its prompt chain to the store, released the slot, and dropped
        the future from its accepted set — from here the coordinator
        MUST place the checkpoint or resolve its future."""
        t0 = self._clock()
        if self.supervisor is not None and ck.future is not None:
            # Ownership leaves the source FIRST: a concurrent failover
            # of src must not race this placement to the same future.
            self.supervisor.untrack_stream(src.replica_id, ck.future)
        tried: List[ReplicaHandle] = [src]
        try:
            # The publish barrier: injection here models the source
            # host dying in the publish window. The checkpoint in hand
            # stays valid regardless of how much of the chain landed in
            # the store (missing blocks degrade to replay-by-recompute,
            # same tokens), so the response is mark-the-source-dead and
            # place on a survivor — not error-the-stream.
            self._supervised(src, SITE_HANDOFF_PUBLISH, lambda: None)
        except ReplicaUnreachableError as exc:
            logger.warning(
                "handoff(%s): source died mid-publish (%s); failing it "
                "over and placing the checkpoint on a survivor",
                src.replica_id,
                classify_fault(exc),
            )
            if self.supervisor is not None:
                try:
                    self.supervisor.mark_dead(src.replica_id)
                except Exception as exc:  # pragma: no cover - teardown races
                    logger.exception(
                        "handoff(%s): mark_dead failed (%s); continuing "
                        "placement anyway",
                        src.replica_id,
                        classify_fault(exc),
                    )
        reroutes = 0
        while True:
            try:
                dst = self.router.select(
                    ck.replay_prompt(),
                    tenant=ck.tenant,
                    exclude=tried,
                    phase=constants.ROUTER_PHASE_DECODE,
                )
            except RuntimeError:
                self._fail_handoff(src, ck, tried)
                return
            try:
                self._supervised(
                    dst,
                    SITE_HANDOFF_REVIVE,
                    dst.engine.transfer_in_checkpoint,
                    ck,
                    handoff=True,
                )
            except (ReplicaUnreachableError, RuntimeError) as exc:
                # Destination died (or closed admission) mid-revive: its
                # own probe cadence will demote it; here it simply stops
                # being a candidate for THIS stream.
                tried.append(dst)
                reroutes += 1
                with self._lock:
                    self.handoff_reroutes += 1
                if self.metrics is not None:
                    self.metrics.inc("nos_tpu_fleet_handoff_reroutes")
                self._event(
                    constants.FLEET_EV_HANDOFF_REROUTE,
                    src=src.replica_id,
                    dst=dst.replica_id,
                    kind=classify_fault(exc),
                )
                continue
            break
        dt = self._clock() - t0
        with self._lock:
            self.handoffs += 1
            self.handoff_wall_s += dt
            self.handoff_latency_s.append(dt)
        if self.metrics is not None:
            self.metrics.inc("nos_tpu_fleet_handoffs")
            self.metrics.observe("nos_tpu_fleet_handoff_latency", dt)
        if self.router.tracer is not None and ck.trace_id is not None:
            # The placement edge of the handoff span (the source's
            # export edge carried slot + published-block counts).
            self.router.tracer.event(
                ck.trace_id,
                constants.TRACE_EV_HANDOFF,
                src=src.replica_id,
                dst=dst.replica_id,
                reroutes=reroutes,
            )
        self._event(
            constants.FLEET_EV_HANDOFF,
            src=src.replica_id,
            dst=dst.replica_id,
            reroutes=reroutes,
            generated=len(ck.generated),
        )
        if self.supervisor is not None:
            # Ownership completes its transfer: tracked under dst (with
            # the handoff image as its newest checkpoint), so a LATER
            # dst death re-homes through the ordinary failover walk.
            self.supervisor.adopt_stream(dst, ck, src=src)

    def _fail_handoff(
        self, src: ReplicaHandle, ck: SlotCheckpoint, tried: List[ReplicaHandle]
    ) -> None:
        """No decode-capable survivor accepted the checkpoint: resolve
        the stream classified, CARRYING the request for resubmit (the
        failure terminus of the failure matrix — never a hang)."""
        exc = ReplicaLostError(
            f"handoff from {src.replica_id} found no decode-capable "
            f"survivor ({len(tried)} candidates tried); resubmit the "
            "attached request",
            replica=src.replica_id,
            prompt=list(ck.prompt),
            max_new=ck.max_new,
            tenant=ck.tenant,
            trace_id=ck.trace_id,
        )
        with self._lock:
            self.handoffs_errored += 1
        if self.metrics is not None:
            self.metrics.inc("nos_tpu_fleet_handoffs_errored")
        self._event(
            constants.FLEET_EV_HANDOFF_FAILED,
            src=src.replica_id,
            tried=len(tried),
        )
        if ck.future is not None:
            try:
                ck.future.set_exception(exc)
            except InvalidStateError:  # pragma: no cover - resolved first
                pass

    # -- telemetry ------------------------------------------------------------
    def report(self) -> ServingReport:
        """The coordinator's counters as a poolable ServingReport
        (replicas=0 — the coordinator is not a replica, exactly like
        the supervisor's report). Merge with `ReplicaSet.fleet_report()`
        for the one-fleet view; `handoff_latency` percentiles re-derive
        from the pooled samples per the merge contract and
        `handoff_wall_s` sums (`telemetry.MERGE_FLOAT_FIELDS`)."""
        with self._lock:
            samples = list(self.handoff_latency_s)
            return ServingReport(
                replicas=0,
                tp_devices=0,
                handoffs=self.handoffs,
                handoff_reroutes=self.handoff_reroutes,
                handoffs_errored=self.handoffs_errored,
                handoff_wall_s=self.handoff_wall_s,
                handoff_latency_p50_s=percentile(samples, 50),
                handoff_latency_p95_s=percentile(samples, 95),
                handoff_latency_samples=samples,
            )

    def snapshot(self) -> Dict[str, object]:
        """Wire-format view: counters + bounded handoff events."""
        with self._lock:
            return {
                "handoffs": self.handoffs,
                "handoff_reroutes": self.handoff_reroutes,
                "handoffs_errored": self.handoffs_errored,
                "handoff_wall_s": self.handoff_wall_s,
                "events": list(self.events),
            }
