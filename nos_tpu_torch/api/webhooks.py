"""Port of `nos_tpu/api/webhooks.py` (:1-66): `install_quota_webhooks` (:27).
Copied verbatim; only the imports point at the port, which imports nothing
of the JAX package.

Validating webhooks for ElasticQuota / CompositeElasticQuota.

Analog of pkg/api/nos.nebuly.com/v1alpha1/{elasticquota_webhook.go:48-87,
compositeelasticquota_webhook.go}: at most one ElasticQuota per namespace; an
ElasticQuota's namespace must not be claimed by any CompositeElasticQuota and
vice versa; max (when set) must dominate min.
"""

from __future__ import annotations

from typing import Optional

from nos_tpu_torch.api.quota_types import CompositeElasticQuota, ElasticQuota
from nos_tpu_torch.cluster.client import AdmissionError, Cluster


def _validate_min_max(min_rl, max_rl, what: str) -> None:
    if max_rl is None:
        return
    for resource, min_q in min_rl.items():
        if min_q > max_rl.get(resource, float("inf")) + 1e-9:
            raise AdmissionError(
                f"{what}: min {resource}={min_q:g} exceeds max={max_rl.get(resource, 0):g}"
            )


def install_quota_webhooks(cluster: Cluster) -> None:
    def validate_eq(op: str, eq: ElasticQuota, old: Optional[ElasticQuota]) -> None:
        _validate_min_max(eq.spec.min, eq.spec.max, f"ElasticQuota {eq.metadata.name}")
        ns = eq.metadata.namespace
        for other in cluster.list("ElasticQuota", namespace=ns):
            if other.metadata.name != eq.metadata.name:
                raise AdmissionError(
                    f"namespace {ns} already has ElasticQuota {other.metadata.name}"
                )
        for ceq in cluster.list("CompositeElasticQuota"):
            if ns in ceq.spec.namespaces:
                raise AdmissionError(
                    f"namespace {ns} is claimed by CompositeElasticQuota "
                    f"{ceq.metadata.name}"
                )

    def validate_ceq(
        op: str, ceq: CompositeElasticQuota, old: Optional[CompositeElasticQuota]
    ) -> None:
        if not ceq.spec.namespaces:
            raise AdmissionError(
                f"CompositeElasticQuota {ceq.metadata.name}: namespaces must be non-empty"
            )
        _validate_min_max(
            ceq.spec.min, ceq.spec.max, f"CompositeElasticQuota {ceq.metadata.name}"
        )
        for other in cluster.list("CompositeElasticQuota"):
            if other.metadata.name == ceq.metadata.name and (
                other.metadata.namespace == ceq.metadata.namespace
            ):
                continue
            overlap = set(ceq.spec.namespaces) & set(other.spec.namespaces)
            if overlap:
                raise AdmissionError(
                    f"namespaces {sorted(overlap)} already claimed by "
                    f"CompositeElasticQuota {other.metadata.name}"
                )

    cluster.register_webhook("ElasticQuota", validate_eq)
    cluster.register_webhook("CompositeElasticQuota", validate_ceq)
