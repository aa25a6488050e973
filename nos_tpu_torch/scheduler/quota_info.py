"""Port of `nos_tpu/scheduler/quota_info.py:1` (:1-168): `ElasticQuotaInfo`
(:25), `ElasticQuotaInfos` (:69). Copied verbatim; only the imports point at
the port, which imports nothing of the JAX package.

ElasticQuotaInfo: the quota arithmetic behind CapacityScheduling.

Analog of pkg/scheduler/plugins/capacityscheduling/elasticquotainfo.go:81-361
and the EQ/CEQ informer (informer.go:57-300): both CRDs are presented as one
ElasticQuotaInfo covering a set of namespaces; a CompositeElasticQuota shadows
any per-namespace ElasticQuota in its namespaces.

The fair-sharing core is `guaranteed_overquotas`: the unused guaranteed
capacity of the whole cluster (Σ over quotas of (min − used)₊) is divided
among borrowing quotas proportionally to their min — a quota may exceed its
min by its *guaranteed over-quota share* before becoming preemptible.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set

from nos_tpu_torch.api.quota_types import CompositeElasticQuota, ElasticQuota
from nos_tpu_torch.api.resources import ResourceList


@dataclass
class ElasticQuotaInfo:
    name: str
    namespaces: Set[str] = field(default_factory=set)
    min: ResourceList = field(default_factory=ResourceList)
    max: Optional[ResourceList] = None
    used: ResourceList = field(default_factory=ResourceList)
    composite: bool = False

    # -- basic arithmetic (elasticquotainfo.go:177-239) ----------------------
    def covers(self, namespace: str) -> bool:
        return namespace in self.namespaces

    def metered(self, request: ResourceList) -> ResourceList:
        """A quota constrains only the resources its spec names (k8s quota
        semantics); everything else passes through unmetered."""
        names = set(self.min) | set(self.max or ())
        return ResourceList({k: v for k, v in request.items() if k in names})

    def used_over_min(self) -> ResourceList:
        return self.used.subtract_non_negative(self.min)

    def is_over_min_with(self, request: ResourceList) -> bool:
        """Would `used + request` exceed min in any metered resource?"""
        total = self.used.add(self.metered(request))
        return any(total.get(k, 0.0) > self.min.get(k, 0.0) + 1e-9 for k in total)

    def fits_max(self, request: ResourceList) -> bool:
        if self.max is None:
            return True
        return self.used.add(self.metered(request)).fits_in(self.max)

    def add_used(self, request: ResourceList) -> None:
        self.used = self.used.add(self.metered(request))

    def subtract_used(self, request: ResourceList) -> None:
        self.used = self.used.subtract(self.metered(request))
        for k in list(self.used):
            if self.used[k] <= 0:
                del self.used[k]

    def clone(self) -> "ElasticQuotaInfo":
        return copy.deepcopy(self)


class ElasticQuotaInfos:
    """The set of quota infos with aggregate fair-sharing math."""

    def __init__(self, infos: Iterable[ElasticQuotaInfo] = ()):
        self.infos: Dict[str, ElasticQuotaInfo] = {i.name: i for i in infos}

    # -- building from CRDs (informer.go:225-241 shadowing rule) -------------
    @classmethod
    def from_objects(
        cls,
        eqs: Iterable[ElasticQuota] = (),
        ceqs: Iterable[CompositeElasticQuota] = (),
    ) -> "ElasticQuotaInfos":
        infos: List[ElasticQuotaInfo] = []
        composite_namespaces: Set[str] = set()
        for ceq in ceqs:
            infos.append(
                ElasticQuotaInfo(
                    name=f"ceq/{ceq.metadata.name}",
                    namespaces=set(ceq.spec.namespaces),
                    min=ResourceList(ceq.spec.min),
                    max=ResourceList(ceq.spec.max) if ceq.spec.max is not None else None,
                    used=ResourceList(ceq.status.used),
                    composite=True,
                )
            )
            composite_namespaces |= set(ceq.spec.namespaces)
        for eq in eqs:
            if eq.metadata.namespace in composite_namespaces:
                continue  # CEQ shadows per-namespace EQs
            infos.append(
                ElasticQuotaInfo(
                    name=f"eq/{eq.metadata.namespace}/{eq.metadata.name}",
                    namespaces={eq.metadata.namespace},
                    min=ResourceList(eq.spec.min),
                    max=ResourceList(eq.spec.max) if eq.spec.max is not None else None,
                    used=ResourceList(eq.status.used),
                )
            )
        return cls(infos)

    def clone(self) -> "ElasticQuotaInfos":
        return ElasticQuotaInfos(i.clone() for i in self.infos.values())

    def get(self, name: str) -> Optional[ElasticQuotaInfo]:
        return self.infos.get(name)

    def for_namespace(self, namespace: str) -> Optional[ElasticQuotaInfo]:
        for info in self.infos.values():
            if info.covers(namespace):
                return info
        return None

    def __iter__(self):
        return iter(self.infos.values())

    def __len__(self) -> int:
        return len(self.infos)

    # -- aggregates ----------------------------------------------------------
    def total_min(self) -> ResourceList:
        out = ResourceList()
        for info in self.infos.values():
            out = out.add(info.min)
        return out

    def total_used(self) -> ResourceList:
        out = ResourceList()
        for info in self.infos.values():
            out = out.add(info.used)
        return out

    def aggregated_used_fits_total_min(self, request: ResourceList) -> bool:
        """Cluster-level guard (capacity_scheduling.go:257-275): borrowing is
        allowed only while Σ used + request ≤ Σ min — guaranteed capacity is
        never overcommitted by over-quota pods."""
        return self.total_used().add(request).fits_in(self.total_min())

    def total_unused_guaranteed(self) -> ResourceList:
        """Σ over quotas of (min − used)₊ — the borrowable pool."""
        out = ResourceList()
        for info in self.infos.values():
            out = out.add(info.min.subtract_non_negative(info.used))
        return out

    def guaranteed_overquotas(self, name: str) -> ResourceList:
        """This quota's fair share of the borrowable pool, proportional to its
        min (elasticquotainfo.go GetGuaranteedOverquotas:81-152)."""
        info = self.infos.get(name)
        if info is None:
            return ResourceList()
        pool = self.total_unused_guaranteed()
        total_min = self.total_min()
        out = ResourceList()
        for resource, pool_qty in pool.items():
            denom = total_min.get(resource, 0.0)
            if denom <= 0:
                continue
            out[resource] = pool_qty * info.min.get(resource, 0.0) / denom
        return out
