"""Collectives over the shards of one mesh axis.

Port of `nos_tpu/parallel/collectives.py`: `ring_perm` (:31), `ring_pass`
(:37), `all_reduce_sum` (:42), `all_reduce_mean` (:46), `all_gather` (:50),
`reduce_scatter` (:54), `all_to_all` (:58) and `axis_index` (:65). Inside
JAX's `shard_map` each of them runs once per device on that device's block.
The port keeps one controller (`parallel/mesh.py`): a collective takes the
list of per-shard tensors along one axis, in shard order (a group of
`Mesh.groups(axis)`), and returns the list of results, result i on shard
i's device. Each is plain torch (`.to()` across devices, `cat`, sums), so
autograd carries gradients through it as JAX's transposes do. Permutes,
gathers and all-to-all move values exactly; sums add in shard order, so
every shard gets the same bits.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

Shards = Sequence[torch.Tensor]


def ring_perm(n: int, shift: int = 1) -> List[Tuple[int, int]]:
    """The (src, dst) permutation of a unidirectional ring of `n` shards."""
    return [(i, (i + shift) % n) for i in range(n)]


def ring_pass(xs: Shards, shift: int = 1) -> List[torch.Tensor]:
    """Each shard's tensor one step around the ring: shard i's lands on
    shard (i + shift) % n."""
    n = len(xs)
    out: List[torch.Tensor] = [None] * n  # type: ignore[list-item]
    for src, dst in ring_perm(n, shift):
        out[dst] = xs[src].to(xs[dst].device)
    return out


def _sum(xs: Shards) -> torch.Tensor:
    """The sum of every shard's tensor, added in shard order on shard 0's
    device."""
    total = xs[0]
    for x in xs[1:]:
        total = total + x.to(total.device)
    return total


def all_reduce_sum(xs: Shards) -> List[torch.Tensor]:
    total = _sum(xs)
    return [total.to(x.device) for x in xs]


def all_reduce_mean(xs: Shards) -> List[torch.Tensor]:
    total = _sum(xs) / len(xs)
    return [total.to(x.device) for x in xs]


def all_gather(xs: Shards, axis: int = 0, tiled: bool = True) -> List[torch.Tensor]:
    """Every shard's tensor joined along `axis` (tiled) or stacked on a new
    `axis`, on every shard."""
    join = torch.cat if tiled else torch.stack
    return [join([y.to(x.device) for y in xs], axis) for x in xs]


def reduce_scatter(xs: Shards, axis: int = 0) -> List[torch.Tensor]:
    """The sum of every shard's tensor, cut along `axis` into n blocks:
    block i on shard i (tiled, as `psum_scatter(tiled=True)`)."""
    total = _sum(xs)
    return [b.to(x.device) for b, x in zip(torch.chunk(total, len(xs), axis), xs)]


def all_to_all(xs: Shards, split_axis: int, concat_axis: int,
               tiled: bool = True) -> List[torch.Tensor]:
    """Shard j receives block j of every shard's tensor (cut along
    `split_axis`) and joins them in shard order along `concat_axis`. Tiled:
    the blocks keep `split_axis` and the shapes keep their rank; untiled:
    `split_axis` has size n and goes, and the received blocks stack on a
    new `concat_axis` (`lax.all_to_all(tiled=False)`). The Ulysses
    sequence <-> head exchange and the MoE dispatch."""
    n = len(xs)
    if tiled:
        blocks = [torch.chunk(x, n, split_axis) for x in xs]
        if any(len(b) != n or b[0].shape != b[-1].shape for b in blocks):
            raise ValueError(f"split axis {split_axis} does not divide by {n}")
        return [torch.cat([blocks[i][j].to(xs[j].device) for i in range(n)], concat_axis)
                for j in range(n)]
    for x in xs:
        if x.shape[split_axis] != n:
            raise ValueError(f"untiled all_to_all needs split axis size {n}, got {x.shape}")
    blocks = [x.unbind(split_axis) for x in xs]
    return [torch.stack([blocks[i][j].to(xs[j].device) for i in range(n)], concat_axis)
            for j in range(n)]


def axis_index(xs: Shards) -> List[torch.Tensor]:
    """Each shard's index along the axis, an int32 scalar on its device."""
    return [torch.tensor(i, dtype=torch.int32, device=x.device) for i, x in enumerate(xs)]
