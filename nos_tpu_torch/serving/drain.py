"""Port of `nos_tpu/serving/drain.py`: `DrainReport` (:52),
`drain_replica` (:111) and `migrate_replica` (:278), with the
destination-failure rollback, copied near verbatim (host-only code; only
the imports point at the port).

Replica drain/migrate: the planner's move protocol, ported to serving.

The partitioning planner moves a sub-slice with an ordered
create -> drain -> delete protocol (create the destination first, drain
the source's work onto it, only then delete the source). This module is
the same protocol one layer up, where the moved unit is a serving
replica's in-flight decode streams instead of a carved slice:

  CREATE   the destination capacity already exists — the fleet's other
           replicas (or a fresh one registered via `ReplicaSet.add`,
           the `migrate_replica` path, before anything drains);
  DRAIN    the source stops admitting (state -> `draining`, so the
           router masks it), then `DecodeServer.drain_extract()`
           checkpoints every admitted slot with the SAME capture fault
           recovery and quota preemption use (the checkpoint substrate:
           prompt + generated tokens + sampling serial + spec state)
           and hands back not-yet-admitted requests with their client
           Futures intact; each checkpoint is re-homed through the
           router (prefix-aware, so a re-homed stream usually lands
           where its prefix is already cached) and replayed through the
           destination's budgeted prefill — serial and PRNG step
           preserved, so greedy AND temperature streams finish
           bit-identically to an undrained run;
  DELETE   the source engine stops and the replica retires.

The moved unit is width-agnostic (docs/sharded-decode.md):
checkpoints are host tokens and spill payloads full-width bytes, so a
drain may re-home streams between replicas of DIFFERENT tensor-parallel
widths — e.g. consolidate a tp=1 fleet onto one tp=4 replica before a
re-carve, bit-identically.

This closes the planner <-> serving loop: a replanning pass that wants a
sub-slice back can drain its replica against live load and re-carve,
paying a replay instead of failed requests.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from nos_tpu_torch import constants
from nos_tpu_torch.runtime.faults import classify_fault
from nos_tpu_torch.serving.replica import ReplicaHandle, ReplicaSet
from nos_tpu_torch.serving.router import PrefixRouter

logger = logging.getLogger(__name__)


@dataclass
class DrainReport:
    """What one drain moved: counts plus the per-stream placements
    ((serial, destination replica id) for checkpointed slots).
    `rolled_back` counts streams/requests that could not be re-homed on
    ANY surviving destination and were restored onto the reopened
    SOURCE instead (destination-failure rollback) — when it is nonzero
    the source did NOT retire."""

    replica_id: str
    slots_migrated: int = 0
    requests_migrated: int = 0
    rolled_back: int = 0
    placements: List[Tuple[int, str]] = field(default_factory=list)
    destinations: Dict[str, int] = field(default_factory=dict)


def _transfer_with_fallback(
    router: PrefixRouter,
    src: ReplicaHandle,
    place_prompt,
    tenant,
    transfer,
    supervisor=None,
):
    """Place one moved unit through `router` and run `transfer(dst)`;
    a destination that FAILS mid-transfer is excluded and the next
    candidate tried (the moved checkpoint/request must never vanish
    between replicas). With a `supervisor`, the transfer routes through
    its guarded call wrapper (timeout/backoff/classification); without
    one, failures still classify through the taxonomy before falling
    through. Returns the destination handle, or None when NO surviving
    candidate accepted — the caller's rollback-to-source case."""
    tried = [src]
    while True:
        try:
            dst = router.select(place_prompt, tenant=tenant, exclude=tried)
        except RuntimeError:
            return None
        try:
            if supervisor is not None:
                from nos_tpu_torch.serving.supervisor import SITE_TRANSFER_IN

                supervisor.supervised_call(
                    dst, SITE_TRANSFER_IN, transfer, dst
                )
            else:
                transfer(dst)
        except Exception as exc:
            logger.warning(
                "drain: transfer to %s failed (%s); trying next candidate",
                dst.replica_id,
                classify_fault(exc),
            )
            tried.append(dst)
            continue
        return dst


def drain_replica(
    replica_set: ReplicaSet,
    router: PrefixRouter,
    replica_id: str,
    supervisor=None,
) -> DrainReport:
    """Drain `replica_id`, re-homing every stream through `router`, and
    retire it. Checkpoints move in serial order (oldest admission first —
    the same head-of-line ordering the intra-engine restore queue
    keeps); pending requests follow FIFO. Raises if the fleet has no
    other admitting replica — a drain that would strand work refuses up
    front instead of failing futures.

    Destination-failure rollback: a destination that fails
    mid-transfer does NOT strand the moved stream between replicas —
    the next candidate is tried, and when no surviving candidate
    accepts, the stream is restored onto the REOPENED source
    (`DecodeServer.reopen`), which then stays ACTIVE instead of
    retiring (`DrainReport.rolled_back` counts these). `supervisor`
    (optional, serving/supervisor.py) routes `drain_extract` and every
    transfer through the guarded call wrapper."""
    handle = replica_set.get(replica_id)
    if handle.state != constants.REPLICA_STATE_ACTIVE:
        raise RuntimeError(
            f"{replica_id} is {handle.state}: only an active replica drains"
        )
    # Refuse before touching the source: re-homing needs a destination.
    router._candidates(exclude=handle)  # raises when none admit
    handle.state = constants.REPLICA_STATE_DRAINING
    report = DrainReport(replica_id=replica_id)
    # drain_extract joins and clears a running loop thread; remember
    # whether one was attached so a destination-failure rollback can
    # restart it (reopen() only clears the stop/closed latches).
    thread_driven = getattr(handle.engine, "_thread", None) is not None
    try:
        if supervisor is not None:
            from nos_tpu_torch.serving.supervisor import SITE_DRAIN_EXTRACT

            checkpoints, pending = supervisor.supervised_call(
                handle, SITE_DRAIN_EXTRACT, handle.engine.drain_extract
            )
        else:
            checkpoints, pending = handle.engine.drain_extract()
    except Exception:
        # Extraction itself failed: the source is in an unknown state
        # and must not look routable — retire it; whatever was not
        # extracted fails loudly with the raised error rather than
        # silently queueing forever.
        handle.state = constants.REPLICA_STATE_RETIRED
        raise
    # Destinations place against engine truth, not optimistic residue:
    # reconcile the survivors' shadows first (host-side reads only).
    router.reconcile()
    t_restore = time.monotonic()
    reopened = False

    def _rollback(transfer_to_source) -> None:
        # No surviving destination accepted: restore onto the SOURCE.
        # drain_extract left it stopped, empty, and conserved, so
        # reopening it is a valid cold destination — the stream is
        # never stranded between replicas.
        nonlocal reopened
        if not reopened:
            reopen = getattr(handle.engine, "reopen", None)
            if reopen is not None:
                reopen()
            reopened = True
        transfer_to_source()
        report.rolled_back += 1

    for ck in checkpoints:
        dst = _transfer_with_fallback(
            router,
            handle,
            ck.replay_prompt(),
            ck.tenant,
            lambda d, ck=ck: d.engine.transfer_in_checkpoint(
                ck, t_restore=t_restore
            ),
            supervisor=supervisor,
        )
        if dst is None:
            _rollback(
                lambda ck=ck: handle.engine.transfer_in_checkpoint(
                    ck, t_restore=t_restore
                )
            )
            continue
        if router.tracer is not None:
            # The re-homed stream keeps ONE trace: the migration is
            # an edge on the request's existing span chain, not a
            # new trace on the destination.
            router.tracer.event(
                ck.trace_id,
                constants.TRACE_EV_DRAIN_MIGRATE,
                src=replica_id,
                dst=dst.replica_id,
                generated=len(ck.generated),
            )
        report.slots_migrated += 1
        report.placements.append((ck.serial, dst.replica_id))
        report.destinations[dst.replica_id] = (
            report.destinations.get(dst.replica_id, 0) + 1
        )
    for req in pending:
        dst = _transfer_with_fallback(
            router,
            handle,
            req.prompt,
            req.tenant,
            lambda d, req=req: d.engine.transfer_in_request(
                req.prompt,
                req.max_new,
                tenant=req.tenant,
                future=req.future,
                t_submit=req.t_submit,
                trace_id=req.trace_id,
            ),
            supervisor=supervisor,
        )
        if dst is None:
            _rollback(
                lambda req=req: handle.engine.transfer_in_request(
                    req.prompt,
                    req.max_new,
                    tenant=req.tenant,
                    future=req.future,
                    t_submit=req.t_submit,
                    trace_id=req.trace_id,
                )
            )
            continue
        if router.tracer is not None:
            router.tracer.event(
                req.trace_id,
                constants.TRACE_EV_DRAIN_MIGRATE,
                src=replica_id,
                dst=dst.replica_id,
                generated=0,
            )
        report.requests_migrated += 1
        report.destinations[dst.replica_id] = (
            report.destinations.get(dst.replica_id, 0) + 1
        )
    if reopened:
        # The source holds rolled-back work again: it stays ACTIVE (the
        # move failed; the report says so) instead of retiring with
        # streams aboard. A thread-driven engine gets its loop BACK
        # before re-admitting — reopen() alone leaves the rolled-back
        # streams queued on a dead-quiet engine that the router would
        # keep placing new work on.
        if thread_driven:
            handle.engine.start()
        handle.state = constants.REPLICA_STATE_ACTIVE
        logger.warning(
            "drain of %s rolled back %d stream(s) onto the reopened "
            "source: no surviving destination accepted them",
            replica_id,
            report.rolled_back,
        )
        return report
    # DELETE: the source is empty — stop it and retire.
    handle.engine.stop()
    handle.state = constants.REPLICA_STATE_RETIRED
    return report


def migrate_replica(
    replica_set: ReplicaSet,
    router: PrefixRouter,
    replica_id: str,
    new_engine,
    start: bool = True,
    supervisor=None,
) -> Tuple[ReplicaHandle, DrainReport]:
    """The full move: CREATE `new_engine` as a fresh replica, then drain
    `replica_id` (its streams re-home prefix-aware across the whole
    fleet, the fresh replica included — typically absorbing most of
    them, since it is the least loaded), then retire the source. Returns
    (new handle, drain report). A destination that fails mid-transfer
    falls back per `drain_replica`'s rollback contract — the
    checkpointed stream lands on the next candidate or back on the
    reopened source, never between replicas."""
    new_handle = replica_set.add(new_engine, start=start)
    report = drain_replica(replica_set, router, replica_id, supervisor=supervisor)
    return new_handle, report
