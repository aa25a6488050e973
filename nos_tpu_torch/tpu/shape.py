"""Port of `nos_tpu/tpu/shape.py` (:1-67): `Shape` (:13). Copied verbatim; only
the imports point at the port, which imports nothing of the JAX package.

Mesh shapes: small integer-tuple geometry with parsing and divisibility."""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from functools import cached_property
from typing import Iterator, Tuple


@dataclass(frozen=True)
class Shape:
    """An N-dimensional chip-mesh shape, e.g. Shape((4, 4)) == '4x4'."""

    dims: Tuple[int, ...]

    def __post_init__(self):
        if not self.dims or any(d < 1 for d in self.dims):
            raise ValueError(f"invalid shape dims {self.dims}")

    @classmethod
    def parse(cls, s: str) -> "Shape":
        try:
            dims = tuple(int(p) for p in s.strip().split("x"))
        except ValueError as e:
            raise ValueError(f"invalid shape {s!r}") from e
        return cls(dims)

    @property
    def name(self) -> str:
        return "x".join(str(d) for d in self.dims)

    @cached_property
    def chips(self) -> int:
        return math.prod(self.dims)

    @property
    def rank(self) -> int:
        return len(self.dims)

    def divides(self, other: "Shape") -> bool:
        """Elementwise divisibility: self tiles `other` with aligned origins."""
        return self.rank == other.rank and all(
            o % s == 0 for s, o in zip(self.dims, other.dims)
        )

    def fits_in(self, other: "Shape") -> bool:
        return self.rank == other.rank and all(
            s <= o for s, o in zip(self.dims, other.dims)
        )

    def orientations(self) -> Iterator["Shape"]:
        """All distinct axis permutations (a 2x4 slice may be laid along either
        mesh axis; ICI links are symmetric per axis within a slice)."""
        seen = set()
        for perm in itertools.permutations(self.dims):
            if perm not in seen:
                seen.add(perm)
                yield Shape(perm)

    def canonical(self) -> "Shape":
        """Dims sorted ascending — the canonical orientation used for naming."""
        return Shape(tuple(sorted(self.dims)))

    def __str__(self) -> str:
        return self.name
