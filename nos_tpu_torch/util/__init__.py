"""Port of `nos_tpu/util/__init__.py` (:1-35): `distinct_permutations` (:8).
Copied verbatim; only the imports point at the port, which imports nothing
of the JAX package.

Generic utilities: batching, pod predicates, small generics."""

from typing import Iterator, List, Sequence, TypeVar

T = TypeVar("T")


def distinct_permutations(items: Sequence[T], reverse: bool = False) -> Iterator[List[T]]:
    """Lazily yield the distinct permutations of a multiset in lexicographic
    order — descending-first with reverse=True — (pkg/util IterPermutations
    analog; same next-permutation walk as the native tpuslice shim).
    Duplicates collapse, so ['a','a','b'] yields 3 orders, not 6."""
    seq = sorted(items, reverse=reverse)
    n = len(seq)
    if n == 0:
        yield []
        return
    while True:
        yield list(seq)
        # Standard next_permutation (prev_permutation when reverse): find the
        # rightmost ascent (descent), pivot-swap, reverse the suffix; stop
        # once fully descending (ascending).
        def ahead(a: T, b: T) -> bool:
            return a <= b if reverse else a >= b

        i = n - 2
        while i >= 0 and ahead(seq[i], seq[i + 1]):
            i -= 1
        if i < 0:
            return
        j = n - 1
        while ahead(seq[i], seq[j]):
            j -= 1
        seq[i], seq[j] = seq[j], seq[i]
        seq[i + 1 :] = reversed(seq[i + 1 :])
