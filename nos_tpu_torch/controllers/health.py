"""Port of `nos_tpu/controllers/health.py:1` (:1-89): `DeviceHealthMonitor`
(:28), `is_node_device_healthy` (:88). Copied verbatim; only the imports
point at the port, which imports nothing of the JAX package.

Device health monitoring + failure detection.

The reference's resilience is protocol-level idempotency (SURVEY.md §5);
here we add the explicit failure-detection piece the TPU north star needs:
agents probe the device layer, stamp a health label on their node, and the
planner stops carving unhealthy nodes (while the scheduler keeps placing
nothing new on them via the same label). Recovery is automatic — a healthy
probe clears the label.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from nos_tpu_torch import constants
from nos_tpu_torch.cluster.client import Cluster, NotFoundError
from nos_tpu_torch.observability import metrics

logger = logging.getLogger(__name__)

LABEL_DEVICE_HEALTH = f"{constants.DOMAIN}/device-health"
HEALTHY = "healthy"
UNHEALTHY = "unhealthy"


class DeviceHealthMonitor:
    """Periodically probes a device client's health() and reconciles the
    node's health label."""

    def __init__(self, cluster: Cluster, node_name: str, client, interval_s: float = 10.0):
        self.cluster = cluster
        self.node_name = node_name
        self.client = client
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def check_once(self) -> Optional[str]:
        """Probe once, patch the node label on transitions. Returns the
        unhealthy reason or None."""
        try:
            reason = self.client.health()
        except Exception as e:  # noqa: BLE001
            reason = f"health probe raised: {e}"
        desired = UNHEALTHY if reason else HEALTHY
        metrics.set_gauge(
            "nos_tpu_device_healthy", 0.0 if reason else 1.0, node=self.node_name
        )
        try:
            node = self.cluster.try_get("Node", "", self.node_name)
            if node is None:
                return reason
            if node.metadata.labels.get(LABEL_DEVICE_HEALTH) != desired:
                if reason:
                    logger.warning(
                        "node %s device unhealthy: %s", self.node_name, reason
                    )
                else:
                    logger.info("node %s device recovered", self.node_name)
                self.cluster.patch(
                    "Node",
                    "",
                    self.node_name,
                    lambda n: n.metadata.labels.__setitem__(LABEL_DEVICE_HEALTH, desired),
                )
        except NotFoundError:
            pass
        return reason

    def start(self) -> "DeviceHealthMonitor":
        def loop():
            while not self._stop.is_set():
                self.check_once()
                self._stop.wait(self.interval_s)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


def is_node_device_healthy(node) -> bool:
    return node.metadata.labels.get(LABEL_DEVICE_HEALTH) != UNHEALTHY
