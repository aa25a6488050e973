"""Port of `nos_tpu/cluster/client.py` (:1-263): `EventType` (:30), `Event`
(:37), `ConflictError` (:43), `NotFoundError` (:47), `AlreadyExistsError`
(:51), `AdmissionError` (:55), `Cluster` (:73). Copied verbatim; only the
imports point at the port, which imports nothing of the JAX package.

An in-memory cluster API server.

The reference's "distributed communication backend" is the k8s control plane:
API-server watch streams, annotation patches, field indexes (SURVEY.md §5).
This module provides that bus in-process: typed object store with value
semantics (deep-copy on write/read), optimistic-concurrency updates, watch
subscriptions with synchronous in-order delivery (tests stay deterministic),
label/field filtered lists, and admission webhooks. It is simultaneously the
runtime substrate and the envtest-analog test seam (reference test strategy,
SURVEY §4).

Concurrency model: one reentrant lock guards the store; watch events are
delivered synchronously under that lock, in commit order, on the writer's
thread. Handlers may re-enter the cluster (reconciler pattern) but must not
block on other threads.
"""

from __future__ import annotations

import copy
import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


class EventType:
    ADDED = "ADDED"
    MODIFIED = "MODIFIED"
    DELETED = "DELETED"


@dataclass
class Event:
    type: str
    obj: Any
    old_obj: Any = None


class ConflictError(Exception):
    pass


class NotFoundError(KeyError):
    pass


class AlreadyExistsError(Exception):
    pass


class AdmissionError(Exception):
    """Raised when a registered admission webhook rejects a write."""


Key = Tuple[str, str, str]  # (kind, namespace, name)


def _copy(obj: Any) -> Any:
    """Value-semantics copy. Stored object classes provide a hand-rolled
    deepcopy (generic copy.deepcopy dominated control-round profiles);
    anything else falls back to the generic path."""
    dc = getattr(obj, "deepcopy", None)
    return dc() if dc is not None else copy.deepcopy(obj)

def _kind_of(obj: Any) -> str:
    return getattr(obj, "KIND", type(obj).__name__)


class Cluster:
    def __init__(self, now: Callable[[], float] = time.time):
        self._now = now
        self._lock = threading.RLock()
        self._store: Dict[Key, Any] = {}
        self._rv = 0
        self._watchers: Dict[str, List[Callable[[Event], None]]] = {}
        self._webhooks: Dict[str, List[Callable[[str, Any, Optional[Any]], None]]] = {}

    # -- helpers -----------------------------------------------------------
    def _key(self, obj: Any) -> Key:
        return (_kind_of(obj), obj.metadata.namespace, obj.metadata.name)

    def _admit(self, op: str, obj: Any, old: Optional[Any]) -> None:
        """Run admission webhooks. `obj` is the to-be-stored copy (hooks may
        mutate it — mutating-webhook semantics); `old` is a defensive copy."""
        for hook in self._webhooks.get(_kind_of(obj), []):
            hook(op, obj, _copy(old) if old is not None else None)

    def _dispatch_locked(self, ev: Event) -> None:
        # Delivered under the lock so per-object event order matches commit
        # order. A failing watcher must never break the writer whose mutation
        # produced the event (watch streams are isolated in a real API server).
        for handler in list(self._watchers.get(_kind_of(ev.obj), [])):
            try:
                handler(ev)
            except Exception:  # noqa: BLE001
                logger.exception("watch handler failed for %s %s", ev.type, _kind_of(ev.obj))

    # -- write path --------------------------------------------------------
    def create(self, obj: Any) -> Any:
        with self._lock:
            key = self._key(obj)
            if key in self._store:
                raise AlreadyExistsError(f"{key} already exists")
            stored = _copy(obj)
            self._admit("CREATE", stored, None)
            self._rv += 1
            stored.metadata.resource_version = self._rv
            if not stored.metadata.creation_timestamp:
                stored.metadata.creation_timestamp = self._now()
            self._store[key] = stored
            self._dispatch_locked(Event(EventType.ADDED, _copy(stored)))
            return _copy(stored)

    def update(self, obj: Any) -> Any:
        with self._lock:
            key = self._key(obj)
            old = self._store.get(key)
            if old is None:
                raise NotFoundError(key)
            if (
                obj.metadata.resource_version
                and obj.metadata.resource_version != old.metadata.resource_version
            ):
                raise ConflictError(
                    f"{key}: resource_version {obj.metadata.resource_version} "
                    f"!= {old.metadata.resource_version}"
                )
            stored = _copy(obj)
            self._admit("UPDATE", stored, old)
            self._rv += 1
            stored.metadata.resource_version = self._rv
            # Identity fields survive an update built from a fresh object.
            stored.metadata.creation_timestamp = old.metadata.creation_timestamp
            stored.metadata.uid = old.metadata.uid
            self._store[key] = stored
            self._dispatch_locked(
                Event(EventType.MODIFIED, _copy(stored), _copy(old))
            )
            return _copy(stored)

    def patch(self, kind: str, namespace: str, name: str, fn: Callable[[Any], None]) -> Any:
        """Read-modify-write under the lock; `fn` mutates the object in place.
        This is how controllers patch annotations/labels/status (the reference's
        client.Patch / Status().Patch calls)."""
        with self._lock:
            key = (kind, namespace, name)
            old = self._store.get(key)
            if old is None:
                raise NotFoundError(key)
            obj = _copy(old)
            fn(obj)
            if self._key(obj) != key:
                raise ValueError(f"patch must not change object identity {key}")
            self._admit("UPDATE", obj, old)
            self._rv += 1
            obj.metadata.resource_version = self._rv
            obj.metadata.uid = old.metadata.uid
            self._store[key] = obj
            self._dispatch_locked(
                Event(EventType.MODIFIED, _copy(obj), _copy(old))
            )
            return _copy(obj)

    def delete(self, kind: str, namespace: str, name: str) -> None:
        with self._lock:
            key = (kind, namespace, name)
            old = self._store.pop(key, None)
            if old is None:
                raise NotFoundError(key)
            # A deletion is a committed write: version-gated pollers must see
            # it (freed capacity, dropped quotas) or their fast paths starve.
            self._rv += 1
            self._dispatch_locked(Event(EventType.DELETED, _copy(old)))

    # -- read path ---------------------------------------------------------
    @property
    def version(self) -> int:
        """Monotonic store version: bumps on every committed write. Cheap
        change detection for pollers (scheduler no-op passes, sim ticks) —
        the in-process analog of a LIST resourceVersion."""
        with self._lock:
            return self._rv

    def peek(self, kind: str, namespace: str, name: str, fn: Callable[[Any], Any]) -> Any:
        """Apply a READ-ONLY extractor to the stored object under the lock,
        without the value-semantics copy; returns fn(obj), or None when the
        object does not exist. For hot paths that need a scalar (a phase, a
        node name) where a full deepcopy per probe dominates. `fn` MUST NOT
        mutate or retain the object."""
        with self._lock:
            obj = self._store.get((kind, namespace, name))
            return None if obj is None else fn(obj)

    def get(self, kind: str, namespace: str, name: str) -> Any:
        with self._lock:
            obj = self._store.get((kind, namespace, name))
            if obj is None:
                raise NotFoundError((kind, namespace, name))
            return _copy(obj)

    def try_get(self, kind: str, namespace: str, name: str) -> Optional[Any]:
        with self._lock:
            obj = self._store.get((kind, namespace, name))
            return _copy(obj) if obj is not None else None

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
        predicate: Optional[Callable[[Any], bool]] = None,
    ) -> List[Any]:
        with self._lock:
            out = []
            for (k, ns, _), obj in self._store.items():
                if k != kind:
                    continue
                if namespace is not None and ns != namespace:
                    continue
                if label_selector and any(
                    obj.metadata.labels.get(lk) != lv for lk, lv in label_selector.items()
                ):
                    continue
                if predicate is not None and not predicate(obj):
                    continue
                out.append(_copy(obj))
            out.sort(key=lambda o: (o.metadata.namespace, o.metadata.name))
            return out

    # -- watch / admission -------------------------------------------------
    def watch(self, kind: str, handler: Callable[[Event], None], replay: bool = True) -> Callable[[], None]:
        """Subscribe to events for `kind`. With replay=True existing objects are
        delivered as ADDED before any live event (informer cache-sync
        semantics); registration + replay are atomic with respect to writers.
        Returns an unsubscribe function."""
        with self._lock:
            if replay:
                for (k, _, _), obj in list(self._store.items()):
                    if k == kind:
                        try:
                            handler(Event(EventType.ADDED, _copy(obj)))
                        except Exception:  # noqa: BLE001
                            logger.exception("watch replay handler failed for %s", kind)
            self._watchers.setdefault(kind, []).append(handler)

        def unsubscribe() -> None:
            with self._lock:
                try:
                    self._watchers.get(kind, []).remove(handler)
                except ValueError:
                    pass

        return unsubscribe

    def register_webhook(self, kind: str, hook: Callable[[str, Any, Optional[Any]], None]) -> None:
        """Admission webhook: hook(op, new_obj, old_obj) raises AdmissionError to
        reject (reference elasticquota_webhook.go:48-87 seam)."""
        with self._lock:
            self._webhooks.setdefault(kind, []).append(hook)
