"""Port of `nos_tpu/util/predicates.py` (:1-105): `matching_name` (:24),
`exclude_delete` (:33), `annotations_changed` (:38),
`node_resources_changed` (:46), `spec_annotations_changed` (:68),
`phase_changed` (:76), `all_of` (:84), `any_of` (:91), `filtered` (:98).
Copied verbatim; only the imports point at the port, which imports nothing
of the JAX package.

Reusable watch-event predicates (pkg/util/predicate/predicates.go analog).

Controllers filter their watch streams through these instead of re-rolling
inline compare logic per handler. A predicate is `Event -> bool`; compose
with `all_of` / `any_of`, wrap a handler with `filtered`.

The reference implements the same four as controller-runtime predicate
structs: MatchingName (predicates.go MatchingName), NodeResourcesChanged,
AnnotationsChangedPredicate, ExcludeDelete — plus the domain-specific ones
its handlers inlined (spec-annotation and phase transitions), promoted here
to named predicates.
"""

from __future__ import annotations

from typing import Callable, Optional

from nos_tpu_torch import constants
from nos_tpu_torch.cluster.client import Event, EventType

Predicate = Callable[[Event], bool]


def matching_name(name: str) -> Predicate:
    """Only events for the named object (predicates.go MatchingName)."""

    def pred(ev: Event) -> bool:
        return ev.obj.metadata.name == name

    return pred


def exclude_delete(ev: Event) -> bool:
    """Drop DELETED events (predicates.go ExcludeDelete)."""
    return ev.type != EventType.DELETED


def annotations_changed(ev: Event) -> bool:
    """MODIFIED with a different annotation map; ADDED/DELETED pass through
    (predicates.go AnnotationsChangedPredicate)."""
    if ev.type != EventType.MODIFIED or ev.old_obj is None:
        return True
    return ev.old_obj.metadata.annotations != ev.obj.metadata.annotations


def node_resources_changed(ev: Event) -> bool:
    """MODIFIED with different capacity/allocatable (predicates.go
    NodeResourcesChanged); ADDED/DELETED pass through."""
    if ev.type != EventType.MODIFIED or ev.old_obj is None:
        return True
    return (
        ev.old_obj.status.allocatable != ev.obj.status.allocatable
        or ev.old_obj.status.capacity != ev.obj.status.capacity
    )


def _spec_annotations(obj) -> Optional[dict]:
    if obj is None:
        return None
    return {
        k: v
        for k, v in obj.metadata.annotations.items()
        if constants.ANNOTATION_SPEC_REGEX.match(k)
        or k == constants.ANNOTATION_SPEC_PLAN
    }


def spec_annotations_changed(ev: Event) -> bool:
    """The agents' reconcile trigger: the node's partitioning SPEC (spec-dev-*
    + plan id) differs from the previous view. ADDED passes (initial sync)."""
    if ev.type != EventType.MODIFIED or ev.old_obj is None:
        return True
    return _spec_annotations(ev.old_obj) != _spec_annotations(ev.obj)


def phase_changed(ev: Event) -> bool:
    """Pod phase transitions only (the quota reconciler's watch predicate,
    elasticquota_controller.go:144-163); ADDED/DELETED pass through."""
    if ev.type != EventType.MODIFIED or ev.old_obj is None:
        return True
    return ev.old_obj.status.phase != ev.obj.status.phase


def all_of(*preds: Predicate) -> Predicate:
    def pred(ev: Event) -> bool:
        return all(p(ev) for p in preds)

    return pred


def any_of(*preds: Predicate) -> Predicate:
    def pred(ev: Event) -> bool:
        return any(p(ev) for p in preds)

    return pred


def filtered(predicate: Predicate, handler: Callable[[Event], None]) -> Callable[[Event], None]:
    """Wrap `handler` so it only fires for events passing `predicate`."""

    def wrapped(ev: Event) -> None:
        if predicate(ev):
            handler(ev)

    return wrapped
