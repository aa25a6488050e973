"""Port of `nos_tpu/api/resources.py` (:1-127): `parse_quantity` (:22),
`ResourceList` (:37), `sum_resources` (:107), `compute_pod_request` (:114).
Copied verbatim; only the imports point at the port, which imports nothing
of the JAX package.

Resource quantity parsing and arithmetic.

Analog of the reference's pkg/resource/resource.go:35-127 (Sum / Subtract /
SubtractNonNegative / Abs / ComputePodRequest). Quantities are plain floats keyed
by resource name; cpu is measured in cores, memory in bytes, extended resources
(TPU slices, MIG profiles, ...) in counts.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Union

Number = Union[int, float]

_SUFFIXES = {
    "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15, "E": 1e18,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60,
}
_SUFFIXES_BY_LEN = tuple(sorted(_SUFFIXES, key=len, reverse=True))


def parse_quantity(value: Union[str, Number]) -> float:
    """Parse a k8s-style quantity: '500m' -> 0.5, '10Gi' -> 10*2**30, 4 -> 4.0."""
    if isinstance(value, (int, float)):
        return float(value)
    s = value.strip()
    if not s:
        raise ValueError("empty quantity")
    if s.endswith("m") and s[:-1].lstrip("-").replace(".", "", 1).isdigit():
        return float(s[:-1]) / 1000.0
    for suffix in _SUFFIXES_BY_LEN:
        if s.endswith(suffix):
            return float(s[: -len(suffix)]) * _SUFFIXES[suffix]
    return float(s)


class ResourceList(Dict[str, float]):
    """A resource-name -> quantity mapping with set arithmetic.

    Mirrors pkg/resource/resource.go semantics: missing keys are zero, and
    arithmetic never mutates operands.
    """

    @classmethod
    def of(cls, mapping: Mapping[str, Union[str, Number]] | None = None, **kw) -> "ResourceList":
        rl = cls()
        for src in (mapping or {}), kw:
            for k, v in src.items():
                rl[k] = rl.get(k, 0.0) + parse_quantity(v)
        return rl

    def get_q(self, name: str) -> float:
        return self.get(name, 0.0)

    def add(self, other: Mapping[str, float]) -> "ResourceList":
        out = ResourceList(self)
        for k, v in other.items():
            out[k] = out.get(k, 0.0) + v
        return out

    def subtract(self, other: Mapping[str, float]) -> "ResourceList":
        out = ResourceList(self)
        for k, v in other.items():
            out[k] = out.get(k, 0.0) - v
        return out

    def subtract_non_negative(self, other: Mapping[str, float]) -> "ResourceList":
        """Subtract, clamping every entry at zero (resource.go SubtractNonNegative)."""
        out = self.subtract(other)
        for k in list(out):
            if out[k] < 0:
                out[k] = 0.0
        return out

    def abs(self) -> "ResourceList":
        return ResourceList({k: abs(v) for k, v in self.items()})

    def non_zero(self) -> "ResourceList":
        return ResourceList({k: v for k, v in self.items() if v != 0})

    def negatives(self) -> "ResourceList":
        """Entries strictly below zero (used by GetLackingSlices, snapshot.go:132-165)."""
        return ResourceList({k: v for k, v in self.items() if v < 0})

    def max_with(self, other: Mapping[str, float]) -> "ResourceList":
        out = ResourceList(self)
        for k, v in other.items():
            out[k] = max(out.get(k, 0.0), v)
        return out

    def fits_in(self, capacity: Mapping[str, float]) -> bool:
        return all(v <= capacity.get(k, 0.0) + 1e-9 for k, v in self.items() if v > 0)

    def __eq__(self, other) -> bool:  # order-insensitive, zero-insensitive
        if not isinstance(other, Mapping):
            return NotImplemented
        keys = set(self) | set(other)
        return all(abs(self.get(k, 0.0) - other.get(k, 0.0)) < 1e-9 for k in keys)

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    __hash__ = None  # type: ignore[assignment]


def sum_resources(items: Iterable[Mapping[str, float]]) -> ResourceList:
    out = ResourceList()
    for it in items:
        out = out.add(it)
    return out


def compute_pod_request(pod) -> ResourceList:
    """Effective pod resource request.

    max(any single init container, sum of app containers) + pod overhead —
    the k8s rule, mirroring pkg/resource/resource.go ComputePodRequest:35-127.
    """
    containers = sum_resources(c.resources for c in pod.spec.containers)
    init = ResourceList()
    for c in pod.spec.init_containers:
        init = init.max_with(c.resources)
    out = containers.max_with(init)
    if pod.spec.overhead:
        out = out.add(pod.spec.overhead)
    return out
