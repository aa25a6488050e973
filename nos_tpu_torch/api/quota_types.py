"""Port of `nos_tpu/api/quota_types.py` (:1-94): `ElasticQuotaSpec` (:19),
`ElasticQuotaStatus` (:25), `ElasticQuota` (:30),
`CompositeElasticQuotaSpec` (:49), `CompositeElasticQuota` (:56), `build_eq`
(:76), `build_composite_eq` (:86). Copied verbatim; only the imports point
at the port, which imports nothing of the JAX package.

ElasticQuota / CompositeElasticQuota CRD types.

Analog of pkg/api/nos.nebuly.com/v1alpha1/{elasticquota_types.go:30-71,
compositeelasticquota_types.go:29-66}: `min` is guaranteed capacity, `max` the
borrowing ceiling (optional), `used` the reconciled status. A
CompositeElasticQuota spans a *list* of namespaces sharing one budget.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from nos_tpu_torch.api.objects import ObjectMeta
from nos_tpu_torch.api.resources import ResourceList


@dataclass
class ElasticQuotaSpec:
    min: ResourceList = field(default_factory=ResourceList)
    max: Optional[ResourceList] = None


@dataclass
class ElasticQuotaStatus:
    used: ResourceList = field(default_factory=ResourceList)


@dataclass
class ElasticQuota:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ElasticQuotaSpec = field(default_factory=ElasticQuotaSpec)
    status: ElasticQuotaStatus = field(default_factory=ElasticQuotaStatus)

    KIND = "ElasticQuota"

    def deepcopy(self) -> "ElasticQuota":
        return ElasticQuota(
            metadata=self.metadata.deepcopy(),
            spec=ElasticQuotaSpec(
                min=ResourceList(self.spec.min),
                max=ResourceList(self.spec.max) if self.spec.max is not None else None,
            ),
            status=ElasticQuotaStatus(used=ResourceList(self.status.used)),
        )


@dataclass
class CompositeElasticQuotaSpec:
    namespaces: List[str] = field(default_factory=list)
    min: ResourceList = field(default_factory=ResourceList)
    max: Optional[ResourceList] = None


@dataclass
class CompositeElasticQuota:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: CompositeElasticQuotaSpec = field(default_factory=CompositeElasticQuotaSpec)
    status: ElasticQuotaStatus = field(default_factory=ElasticQuotaStatus)

    KIND = "CompositeElasticQuota"

    def deepcopy(self) -> "CompositeElasticQuota":
        return CompositeElasticQuota(
            metadata=self.metadata.deepcopy(),
            spec=CompositeElasticQuotaSpec(
                namespaces=list(self.spec.namespaces),
                min=ResourceList(self.spec.min),
                max=ResourceList(self.spec.max) if self.spec.max is not None else None,
            ),
            status=ElasticQuotaStatus(used=ResourceList(self.status.used)),
        )


# -- test factories (reference *_factory.go) ---------------------------------
def build_eq(namespace: str, name: str, min=None, max=None) -> ElasticQuota:
    return ElasticQuota(
        metadata=ObjectMeta(name=name, namespace=namespace),
        spec=ElasticQuotaSpec(
            min=ResourceList.of(min or {}),
            max=ResourceList.of(max) if max is not None else None,
        ),
    )


def build_composite_eq(name: str, namespaces, min=None, max=None) -> CompositeElasticQuota:
    return CompositeElasticQuota(
        metadata=ObjectMeta(name=name, namespace="default"),
        spec=CompositeElasticQuotaSpec(
            namespaces=list(namespaces),
            min=ResourceList.of(min or {}),
            max=ResourceList.of(max) if max is not None else None,
        ),
    )
