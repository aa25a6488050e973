"""Port of `nos_tpu/gpu/device_plugin.py:1` (:1-191): `RestartTimeoutError`
(:23), `DevicePluginClient` (:27), `FakeDevicePluginDaemonSet` (:121),
`ensure_fake_daemonset` (:183). Copied verbatim; only the imports point at
the port, which imports nothing of the JAX package.

Device-plugin restart channel.

After a geometry change the accelerator device plugin must re-register its
devices with the kubelet; the reference forces this by deleting the plugin's
DaemonSet pod on the node and polling until the replacement is Running
(pkg/gpu/client.go:37-132 `DevicePluginClient.Restart`, invoked by the MIG
actuator at internal/controllers/migagent/actuator.go:205-209).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List

from nos_tpu_torch import constants
from nos_tpu_torch.api.objects import Pod, PodPhase
from nos_tpu_torch.cluster.client import Cluster, NotFoundError

logger = logging.getLogger(__name__)


class RestartTimeoutError(TimeoutError):
    pass


class DevicePluginClient:
    """Deletes the device-plugin pod on a node and waits for its replacement
    (the DaemonSet controller recreates it) to reach Running."""

    def __init__(
        self,
        cluster: Cluster,
        namespace: str = constants.DEFAULT_DEVICE_PLUGIN_CM_NAMESPACE,
        label: str = constants.DEVICE_PLUGIN_POD_LABEL,
        label_value: str = constants.DEVICE_PLUGIN_POD_LABEL_VALUE,
        timeout_s: float = constants.DEFAULT_DEVICE_PLUGIN_RESTART_TIMEOUT_S,
        poll_interval_s: float = 0.05,
        now: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.cluster = cluster
        self.namespace = namespace
        self.label = label
        self.label_value = label_value
        self.timeout_s = timeout_s
        self.poll_interval_s = poll_interval_s
        self._now = now
        self._sleep = sleep

    def _plugin_pods(self, node_name: str) -> List[Pod]:
        return self.cluster.list(
            "Pod",
            namespace=self.namespace,
            label_selector={self.label: self.label_value},
            predicate=lambda p: p.spec.node_name == node_name,
        )

    def restart(self, node_name: str, wait: str = "block") -> None:
        """Delete the plugin pod(s) on `node_name`, then wait until a *new*
        pod (different uid) is Running there.

        wait="block": poll on the calling thread; raises RestartTimeoutError.
        wait="background": if the replacement is not already Running (the
        in-process DaemonSet simulator recreates it synchronously during the
        delete), hand the poll to a daemon thread that logs the outcome.
        Callers running inside a cluster watch dispatch — which holds the bus
        lock — MUST use background, or no other thread could ever commit the
        replacement pod."""
        old_uids = set()
        for pod in self._plugin_pods(node_name):
            old_uids.add(pod.metadata.uid)
            try:
                self.cluster.delete("Pod", pod.metadata.namespace, pod.metadata.name)
            except NotFoundError:
                pass
            logger.info(
                "deleted device-plugin pod %s on %s; waiting for replacement",
                pod.metadata.namespaced_name,
                node_name,
            )
        if not old_uids:
            # Nothing to restart (no plugin pod on this node); waiting for a
            # "replacement" would just burn the timeout.
            logger.info("no device-plugin pod on %s; skipping restart", node_name)
            return
        if self._replacement_running(node_name, old_uids):
            return
        if wait == "background":
            import threading

            threading.Thread(
                target=self._wait_running,
                args=(node_name, old_uids, False),
                daemon=True,
            ).start()
            return
        self._wait_running(node_name, old_uids, True)

    def _replacement_running(self, node_name: str, old_uids: set) -> bool:
        return any(
            pod.metadata.uid not in old_uids and pod.status.phase == PodPhase.RUNNING
            for pod in self._plugin_pods(node_name)
        )

    def _wait_running(self, node_name: str, old_uids: set, raise_on_timeout: bool) -> None:
        deadline = self._now() + self.timeout_s
        while self._now() < deadline:
            if self._replacement_running(node_name, old_uids):
                return
            self._sleep(self.poll_interval_s)
        if raise_on_timeout:
            raise RestartTimeoutError(
                f"device plugin on {node_name} not Running within {self.timeout_s}s"
            )
        logger.error(
            "device plugin on %s not Running within %.0fs", node_name, self.timeout_s
        )


class FakeDevicePluginDaemonSet:
    """Recreates device-plugin pods on deletion — what the DaemonSet
    controller does in a real cluster, and what the reference's migagent
    integration suite simulates with fake nvidia-device-plugin pods
    (suite_int_test.go:59-62)."""

    def __init__(
        self,
        cluster: Cluster,
        namespace: str = constants.DEFAULT_DEVICE_PLUGIN_CM_NAMESPACE,
        label: str = constants.DEVICE_PLUGIN_POD_LABEL,
        label_value: str = constants.DEVICE_PLUGIN_POD_LABEL_VALUE,
    ):
        self.cluster = cluster
        self.namespace = namespace
        self.label = label
        self.label_value = label_value
        self._unsub = None

    def _make_pod(self, node_name: str) -> Pod:
        from nos_tpu_torch.api.objects import Container, ObjectMeta, OwnerReference, PodSpec

        pod = Pod(
            metadata=ObjectMeta(
                name=f"device-plugin-{node_name}",
                namespace=self.namespace,
                labels={self.label: self.label_value},
            ),
            spec=PodSpec(containers=[Container()], node_name=node_name),
            owner_references=[OwnerReference(kind="DaemonSet", name="device-plugin")],
        )
        pod.status.phase = PodPhase.RUNNING
        return pod

    def ensure_pod(self, node_name: str) -> None:
        if not self.cluster.list(
            "Pod",
            namespace=self.namespace,
            label_selector={self.label: self.label_value},
            predicate=lambda p: p.spec.node_name == node_name,
        ):
            self.cluster.create(self._make_pod(node_name))

    def start(self) -> "FakeDevicePluginDaemonSet":
        def on_pod(ev) -> None:
            pod = ev.obj
            if (
                ev.type == "DELETED"
                and pod.metadata.namespace == self.namespace
                and pod.metadata.labels.get(self.label) == self.label_value
                and pod.spec.node_name
            ):
                self.ensure_pod(pod.spec.node_name)

        self._unsub = self.cluster.watch("Pod", on_pod, replay=False)
        return self

    def stop(self) -> None:
        if self._unsub:
            self._unsub()


def ensure_fake_daemonset(cluster: Cluster) -> FakeDevicePluginDaemonSet:
    """One started FakeDevicePluginDaemonSet per cluster bus — repeated agent
    builds must not stack duplicate Pod watchers. The instance rides on the
    cluster object so its lifetime matches the bus."""
    ds = getattr(cluster, "_fake_device_plugin_daemonset", None)
    if ds is None:
        ds = FakeDevicePluginDaemonSet(cluster).start()
        cluster._fake_device_plugin_daemonset = ds
    return ds
