"""Port of `nos_tpu/util/leader.py` (:1-241): `LeaderElector` (:31). Copied
verbatim; only the imports point at the port, which imports nothing of the
JAX package.

Lease-based leader election (controller-runtime's leaderelection analog).

Every reference binary runs its reconcilers behind a coordination.k8s.io
Lease lock so only one replica acts (SURVEY §5 config system: leader
election, e.g. cmd/operator/operator.go manager options). Same semantics
here, over any cluster backend (in-memory bus, emulator, real k8s):

  - acquire: create the Lease, or take it over when the holder's renewTime
    is older than leaseDurationSeconds (optimistic-concurrency patch — two
    racers collapse to one winner);
  - renew every renew_period while leading;
  - loss (failed renew / someone else took the lease) invokes
    on_stopped_leading — the CLI binaries exit so the pod restarts and
    re-campaigns, exactly controller-runtime's default.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from typing import Callable, Optional

from nos_tpu_torch.api.objects import Lease, LeaseSpec, ObjectMeta
from nos_tpu_torch.cluster.client import AlreadyExistsError, ConflictError, NotFoundError

logger = logging.getLogger(__name__)


class LeaderElector:
    def __init__(
        self,
        cluster,
        lease_name: str,
        namespace: str = "nos-system",
        identity: Optional[str] = None,
        lease_duration_s: float = 15.0,
        renew_period_s: float = 5.0,
        retry_period_s: float = 2.0,
        now: Callable[[], float] = time.time,
        on_stopped_leading: Optional[Callable[[], None]] = None,
    ):
        self.cluster = cluster
        self.lease_name = lease_name
        self.namespace = namespace
        self.identity = identity or f"elector-{uuid.uuid4().hex[:8]}"
        self.lease_duration_s = float(lease_duration_s)
        self.renew_period_s = float(renew_period_s)
        self.retry_period_s = float(retry_period_s)
        self._now = now
        self.on_stopped_leading = on_stopped_leading
        self._leading = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Expiry is judged against LOCALLY observed renew progress, never the
        # remote timestamp (client-go leaderelection does the same): trusting
        # the holder's clock means >duration of skew takes over a live lease.
        self._observed: Optional[tuple] = None
        self._last_renew_ok: float = 0.0

    # -- observers -----------------------------------------------------------
    @property
    def is_leader(self) -> bool:
        return self._leading.is_set()

    def wait_for_leadership(self, timeout: Optional[float] = None) -> bool:
        return self._leading.wait(timeout)

    # -- one-shot primitives (directly testable) -----------------------------
    def _lease_expired(self, held: Lease) -> bool:
        """True once WE have watched the lease make no renew progress for a
        full lease duration (local observation, skew-immune)."""
        key = (held.spec.holder_identity, held.spec.renew_time)
        if self._observed is None or self._observed[0] != key:
            self._observed = (key, self._now())
            return False
        return self._now() - self._observed[1] > self.lease_duration_s

    def try_acquire(self) -> bool:
        """One acquisition attempt; True iff we hold the lease afterwards.
        Never raises: backend failures just mean 'not acquired this round'
        (a dead campaign thread would silently end the election forever)."""
        now = self._now()
        try:
            held = self.cluster.try_get("Lease", self.namespace, self.lease_name)
        except Exception:  # noqa: BLE001 — backend hiccup: not acquired
            logger.exception("leader election: lease read failed")
            return False
        if held is None:
            lease = Lease(
                metadata=ObjectMeta(name=self.lease_name, namespace=self.namespace),
                spec=LeaseSpec(
                    holder_identity=self.identity,
                    lease_duration_seconds=int(self.lease_duration_s),
                    acquire_time=now,
                    renew_time=now,
                    lease_transitions=0,
                ),
            )
            try:
                self.cluster.create(lease)
                self._last_renew_ok = now
                return True
            except AlreadyExistsError:
                return False
            except Exception:  # noqa: BLE001
                logger.exception("leader election: lease create failed")
                return False
        if held.spec.holder_identity == self.identity:
            return self._renew() == "ok"
        # An empty holder means the previous leader released voluntarily:
        # take over immediately, no observation period needed.
        if held.spec.holder_identity and not self._lease_expired(held):
            return False

        observed_renew = held.spec.renew_time

        def take_over(lease: Lease) -> None:
            if (
                lease.spec.holder_identity != held.spec.holder_identity
                or lease.spec.renew_time != observed_renew
            ):
                raise ConflictError("lease renewed while taking over")
            lease.spec.holder_identity = self.identity
            lease.spec.acquire_time = self._now()
            lease.spec.renew_time = self._now()
            lease.spec.lease_transitions += 1

        try:
            self.cluster.patch("Lease", self.namespace, self.lease_name, take_over)
            logger.info(
                "leader election: %s took over lease %s/%s",
                self.identity,
                self.namespace,
                self.lease_name,
            )
            self._last_renew_ok = self._now()
            return True
        except Exception:  # noqa: BLE001 — Conflict, NotFound, or transport
            logger.debug(
                "leader election: takeover of %s/%s failed",
                self.namespace,
                self.lease_name,
                exc_info=True,
            )
            return False

    def _renew(self) -> str:
        """'ok' | 'lost' (someone else holds it — definitive) | 'error'
        (transient; leadership holds until the renew deadline passes)."""

        def renew(lease: Lease) -> None:
            if lease.spec.holder_identity != self.identity:
                raise ConflictError("lease stolen")
            lease.spec.renew_time = self._now()

        try:
            self.cluster.patch("Lease", self.namespace, self.lease_name, renew)
            self._last_renew_ok = self._now()
            return "ok"
        except (ConflictError, NotFoundError):
            return "lost"
        except Exception:  # noqa: BLE001 — transient backend failure
            logger.exception("leader election: renew failed")
            return "error"

    def release(self) -> None:
        """Voluntarily drop the lease (graceful shutdown) so a peer can take
        over without waiting out the duration."""

        def clear(lease: Lease) -> None:
            if lease.spec.holder_identity != self.identity:
                raise ConflictError("not the holder")
            lease.spec.holder_identity = ""
            lease.spec.renew_time = 0.0

        try:
            self.cluster.patch("Lease", self.namespace, self.lease_name, clear)
        except (ConflictError, NotFoundError):
            # Someone already took (or deleted) the lease: nothing to release,
            # but worth a trace when debugging a contested shutdown.
            logger.debug(
                "leader election: release of %s/%s skipped (lease gone or stolen)",
                self.namespace,
                self.lease_name,
            )
        self._leading.clear()

    # -- campaign loop -------------------------------------------------------
    def start(self) -> "LeaderElector":
        self._thread = threading.Thread(
            target=self._run, name=f"leader-elector-{self.lease_name}", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, release: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        if release and self.is_leader:
            self.release()

    def _run(self) -> None:
        while not self._stop.is_set():
            if self._leading.is_set():
                status = self._renew()
                if status == "ok":
                    self._stop.wait(self.renew_period_s)
                elif status == "lost" or (
                    self._now() - self._last_renew_ok > self.lease_duration_s
                ):
                    # Definitive loss, or transient errors outlasted the
                    # renew deadline (controller-runtime retries until then).
                    self._lose()
                    self._stop.wait(self.retry_period_s)
                else:
                    self._stop.wait(min(self.retry_period_s, 1.0))
            elif self.try_acquire():
                logger.info(
                    "leader election: %s acquired %s/%s",
                    self.identity,
                    self.namespace,
                    self.lease_name,
                )
                self._leading.set()
                self._stop.wait(self.renew_period_s)
            else:
                self._stop.wait(self.retry_period_s)

    def _lose(self) -> None:
        self._leading.clear()
        logger.warning(
            "leader election: %s lost %s/%s",
            self.identity,
            self.namespace,
            self.lease_name,
        )
        if self.on_stopped_leading is not None:
            self.on_stopped_leading()
