"""Port of `nos_tpu/cluster/__init__.py` (:1-23). Copied verbatim; only the
imports point at the port, which imports nothing of the JAX package.

Cluster control bus: the in-memory API server, the k8s wire codec, the
HTTP API-server emulator, and the real-Kubernetes backend speaking the same
protocol."""

from nos_tpu_torch.cluster.client import Cluster, Event, EventType  # noqa: F401


def __getattr__(name):
    # Lazy: the HTTP/kube layers pull in ssl/http.server; most callers only
    # need the in-memory bus.
    if name == "ClusterAPIServer":
        from nos_tpu_torch.cluster.apiserver import ClusterAPIServer

        return ClusterAPIServer
    if name in ("KubeCluster", "KubeConfig"):
        from nos_tpu_torch.cluster import kube

        return getattr(kube, name)
    if name == "AdmissionWebhookServer":
        from nos_tpu_torch.cluster.webhook_server import AdmissionWebhookServer

        return AdmissionWebhookServer
    raise AttributeError(name)
