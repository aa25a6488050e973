"""Port of `nos_tpu/controllers/quota.py:1` (:1-166): `QuotaReconciler` (:44).
Copied verbatim; only the imports point at the port, which imports nothing
of the JAX package.

ElasticQuota / CompositeElasticQuota reconcilers (the operator).

Analog of internal/controllers/elasticquota/{elasticquota_controller.go:66-166,
compositeelasticquota_controller.go:70-137} and the shared labeling logic in
elasticquota.go:38-149: on quota changes or pod phase transitions, list the
quota's running pods, sort them deterministically (creation time, priority,
request size, name), label each `in-quota` while cumulative usage stays within
min and `over-quota` beyond it, and patch status.used. The over-quota labels
are what preemption keys on (capacity_scheduling.go:550,574).

The composite reconciler additionally deletes per-namespace ElasticQuotas that
overlap its namespace list (compositeelasticquota_controller.go:112-137).
"""

from __future__ import annotations

import logging
from typing import Iterable, List, Optional

from nos_tpu_torch import constants
from nos_tpu_torch.api.objects import Pod
from nos_tpu_torch.api.quota_types import CompositeElasticQuota, ElasticQuota
from nos_tpu_torch.api.resources import ResourceList
from nos_tpu_torch.cluster.client import Cluster, Event, EventType, NotFoundError
from nos_tpu_torch.scheduler.resource_calculator import ResourceCalculator
from nos_tpu_torch.util import pod as podutil

logger = logging.getLogger(__name__)


def _sort_key(calculator: ResourceCalculator):
    def key(pod: Pod):
        request = calculator.compute_pod_request(pod)
        return (
            pod.metadata.creation_timestamp,
            -pod.spec.priority,
            request.get(constants.RESOURCE_ACCELERATOR_MEMORY, 0.0),
            pod.metadata.namespaced_name,
        )

    return key


class QuotaReconciler:
    def __init__(self, cluster: Cluster, calculator: Optional[ResourceCalculator] = None):
        self.cluster = cluster
        self.calculator = calculator or ResourceCalculator()
        self._unsubs = []

    # -- watch wiring --------------------------------------------------------
    def start_watching(self) -> None:
        def on_quota(ev: Event) -> None:
            if ev.type != EventType.DELETED:
                self.reconcile_all()

        def on_pod(ev: Event) -> None:
            # Only phase transitions matter (elasticquota_controller.go watch
            # predicate :144-163, promoted to util.predicates.phase_changed).
            from nos_tpu_torch.util import predicates as pred

            if not pred.phase_changed(ev):
                return
            self.reconcile_namespace(ev.obj.metadata.namespace)

        self._unsubs = [
            self.cluster.watch("ElasticQuota", on_quota),
            self.cluster.watch("CompositeElasticQuota", on_quota),
            self.cluster.watch("Pod", on_pod, replay=False),
        ]

    def stop(self) -> None:
        for unsub in self._unsubs:
            unsub()
        self._unsubs = []

    # -- reconciliation ------------------------------------------------------
    def reconcile_all(self) -> None:
        for ceq in self.cluster.list("CompositeElasticQuota"):
            self.reconcile_composite(ceq)
        for eq in self.cluster.list("ElasticQuota"):
            self.reconcile_eq(eq)

    def reconcile_namespace(self, namespace: str) -> None:
        for ceq in self.cluster.list("CompositeElasticQuota"):
            if namespace in ceq.spec.namespaces:
                self.reconcile_composite(ceq)
                return
        for eq in self.cluster.list("ElasticQuota", namespace=namespace):
            self.reconcile_eq(eq)

    def reconcile_eq(self, eq: ElasticQuota) -> None:
        # A CEQ claiming this namespace shadows (and will delete) the EQ.
        for ceq in self.cluster.list("CompositeElasticQuota"):
            if eq.metadata.namespace in ceq.spec.namespaces:
                return
        used = self._label_pods_and_compute_used(
            namespaces=[eq.metadata.namespace], min_rl=eq.spec.min
        )
        self._patch_used("ElasticQuota", eq, used)

    def reconcile_composite(self, ceq: CompositeElasticQuota) -> None:
        # Delete overlapping per-namespace quotas first.
        for ns in ceq.spec.namespaces:
            for eq in self.cluster.list("ElasticQuota", namespace=ns):
                logger.info(
                    "deleting ElasticQuota %s/%s overlapped by CompositeElasticQuota %s",
                    ns,
                    eq.metadata.name,
                    ceq.metadata.name,
                )
                try:
                    self.cluster.delete("ElasticQuota", ns, eq.metadata.name)
                except NotFoundError:
                    pass
        used = self._label_pods_and_compute_used(
            namespaces=ceq.spec.namespaces, min_rl=ceq.spec.min
        )
        self._patch_used("CompositeElasticQuota", ceq, used)

    # -- core labeling (elasticquota.go PatchPodsAndComputeUsedQuota) --------
    def _label_pods_and_compute_used(
        self, namespaces: Iterable[str], min_rl: ResourceList
    ) -> ResourceList:
        pods: List[Pod] = []
        for ns in namespaces:
            pods.extend(
                p
                for p in self.cluster.list("Pod", namespace=ns)
                if podutil.is_active(p)
            )
        pods.sort(key=_sort_key(self.calculator))
        metered_names = set(min_rl)
        cumulative = ResourceList()
        used = ResourceList()
        for pod in pods:
            request = self.calculator.compute_pod_request(pod)
            metered = ResourceList({k: v for k, v in request.items() if k in metered_names})
            cumulative = cumulative.add(metered)
            in_quota = cumulative.fits_in(min_rl)
            label = constants.CAPACITY_IN_QUOTA if in_quota else constants.CAPACITY_OVER_QUOTA
            used = used.add(metered)
            if pod.metadata.labels.get(constants.LABEL_CAPACITY) != label:
                try:
                    self.cluster.patch(
                        "Pod",
                        pod.metadata.namespace,
                        pod.metadata.name,
                        lambda p, label=label: p.metadata.labels.__setitem__(
                            constants.LABEL_CAPACITY, label
                        ),
                    )
                except NotFoundError:
                    pass
        return used

    def _patch_used(self, kind: str, quota, used: ResourceList) -> None:
        if ResourceList(quota.status.used) == used:
            return

        def mutate(q):
            q.status.used = used

        try:
            self.cluster.patch(kind, quota.metadata.namespace, quota.metadata.name, mutate)
        except NotFoundError:
            pass
