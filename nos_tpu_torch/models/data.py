"""Input pipeline: host-side batching with device prefetch.

Port of `nos_tpu/models/data.py`: `_prefetch` (:31), `prefetch_to_device`
(:49), `prefetch_to_mesh` (:58) and `synthetic_token_stream` (:72, numpy,
bit-identical batches for a seed). While step k runs, batch k+1 is already
on its way to the device: each batch is copied from pinned host memory with
a non-blocking copy on the current stream, so the copy overlaps the step
queued before it. `prefetch_to_mesh` slices each batch by a spec on the
host and copies each position's block to its device the same way.
"""

from __future__ import annotations

import collections
import itertools
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from nos_tpu_torch.device import resolve
from nos_tpu_torch.parallel.sharding import shard_slices


def _prefetch(iterator: Iterable, put, size: int) -> Iterator:
    """The double-buffer core: keep up to `size` already-transferred batches
    queued ahead of the consumer."""
    queue: collections.deque = collections.deque()
    it = iter(iterator)

    def enqueue(n: int) -> None:
        for item in itertools.islice(it, n):
            queue.append(put(item))

    enqueue(size)
    while queue:
        yield queue.popleft()
        enqueue(1)


def map_arrays(fn, item):
    """`item` (an array, or dicts/lists/tuples of them) with fn applied to
    every array."""
    if isinstance(item, dict):
        return {k: map_arrays(fn, v) for k, v in item.items()}
    if isinstance(item, (list, tuple)):
        return type(item)(map_arrays(fn, v) for v in item)
    return fn(item)


def _put(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on `device`: pinned and copied without blocking to a
    CUDA device."""
    t = t.contiguous()
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def prefetch_to_device(iterator: Iterable, size: int = 2, device=None) -> Iterator:
    """Yield the items of `iterator` (numpy arrays, or dicts/lists/tuples of
    them) as tensors on `device` (None: CUDA), with up to `size` batches
    transferred ahead of the consumer."""
    device = resolve(device, "prefetch_to_device")

    def put_array(x):
        return _put(torch.from_numpy(np.ascontiguousarray(x)), device)

    return _prefetch(iterator, lambda item: map_arrays(put_array, item), size)


def prefetch_to_mesh(iterator: Iterable, mesh, spec, size: int = 2) -> Iterator:
    """Sharded prefetch: every array of each batch becomes the list of its
    blocks under `spec` (e.g. `batch_sharding(mesh, "dp", "sp")`), block p
    on `mesh.devices[p]` (`parallel/sharding.py::shard_tensor`'s layout),
    ready for the sharded train step, with up to `size` batches
    transferred ahead of the consumer."""

    def put_array(x):
        host = torch.from_numpy(np.ascontiguousarray(x))
        return [_put(b, d) for b, d in zip(shard_slices(host, mesh, spec), mesh.devices)]

    return _prefetch(iterator, lambda item: map_arrays(put_array, item), size)


def synthetic_token_stream(
    vocab: int,
    batch: int,
    seq: int,
    seed: int = 0,
    steps: Optional[int] = None,
) -> Iterator[np.ndarray]:
    """Deterministic [batch, seq] int32 token batches (numpy on the host;
    the transfer to the device is the prefetcher's job)."""
    rng = np.random.default_rng(seed)
    count = itertools.count() if steps is None else range(steps)
    for _ in count:
        yield rng.integers(0, vocab, size=(batch, seq), dtype=np.int32)
