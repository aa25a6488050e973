"""Port of `nos_tpu/util/batcher.py` (:1-98): `Batcher` (:19). Copied verbatim;
only the imports point at the port, which imports nothing of the JAX
package.

Time-window batcher.

Analog of the reference's generic Batcher[T] (pkg/util/batcher.go:25-130): items
accumulate until either (a) `timeout` has elapsed since the first item of the
batch, or (b) `idle` has elapsed with no new item. The core is deterministic —
time is injected — so controller tests never sleep; a blocking `wait_ready`
wrapper serves the threaded runtime.
"""

from __future__ import annotations

import threading
import time as _time
from typing import Callable, Generic, List, Optional, TypeVar

T = TypeVar("T")


class Batcher(Generic[T]):
    def __init__(
        self,
        timeout_s: float,
        idle_s: Optional[float] = None,
        now: Callable[[], float] = _time.monotonic,
    ):
        if idle_s is None or idle_s <= 0 or idle_s > timeout_s:
            idle_s = timeout_s
        self._timeout = timeout_s
        self._idle = idle_s
        self._now = now
        self._items: List[T] = []
        self._first_at: Optional[float] = None
        self._last_at: Optional[float] = None
        self._cond = threading.Condition()

    def add(self, item: T) -> None:
        with self._cond:
            t = self._now()
            if not self._items:
                self._first_at = t
            self._items.append(item)
            self._last_at = t
            self._cond.notify_all()

    def __len__(self) -> int:
        with self._cond:
            return len(self._items)

    def _ready_locked(self) -> bool:
        if not self._items:
            return False
        t = self._now()
        assert self._first_at is not None and self._last_at is not None
        return (t - self._first_at) >= self._timeout or (t - self._last_at) >= self._idle

    def ready(self) -> bool:
        """True when a non-empty batch has closed (timeout or idle window hit)."""
        with self._cond:
            return self._ready_locked()

    def drain(self) -> List[T]:
        """Return and clear the current batch (regardless of readiness)."""
        with self._cond:
            items, self._items = self._items, []
            self._first_at = self._last_at = None
            return items

    def drain_if_ready(self) -> List[T]:
        with self._cond:
            if not self._ready_locked():
                return []
            items, self._items = self._items, []
            self._first_at = self._last_at = None
            return items

    def seconds_until_ready(self) -> Optional[float]:
        """Time until the batch closes, or None if empty."""
        with self._cond:
            if not self._items:
                return None
            t = self._now()
            assert self._first_at is not None and self._last_at is not None
            return max(
                0.0,
                min(self._timeout - (t - self._first_at), self._idle - (t - self._last_at)),
            )

    def wait_ready(self, poll_s: float = 0.05, stop: Optional[threading.Event] = None) -> List[T]:
        """Block until a batch closes, then drain it (threaded-runtime path)."""
        while True:
            if stop is not None and stop.is_set():
                return self.drain()
            batch = self.drain_if_ready()
            if batch:
                return batch
            with self._cond:
                wait = self.seconds_until_ready()
                self._cond.wait(timeout=poll_s if wait is None else min(wait + 1e-3, poll_s))
