"""Input pipeline: host-side batching with device prefetch.

Port of `nos_tpu/models/data.py`: `_prefetch` (:31), `prefetch_to_device`
(:49) and `synthetic_token_stream` (:72, numpy, bit-identical batches for
a seed). While step k runs, batch k+1 is already on its way to the device:
each batch is copied from pinned host memory with a non-blocking copy on
the current stream, so the copy overlaps the step queued before it. The
sharded `prefetch_to_mesh` (:58) waits for sharded training (ROADMAP A9).
"""

from __future__ import annotations

import collections
import itertools
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from nos_tpu_torch.device import resolve


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


def _tree_map(fn, item):
    if isinstance(item, dict):
        return {k: _tree_map(fn, v) for k, v in item.items()}
    if isinstance(item, (list, tuple)):
        return type(item)(_tree_map(fn, v) for v in item)
    return fn(item)


def prefetch_to_device(iterator: Iterable, size: int = 2, device=None) -> Iterator:
    """Yield the items of `iterator` (numpy arrays, or dicts/lists/tuples of
    them) as tensors on `device` (None: CUDA), with up to `size` batches
    transferred ahead of the consumer."""
    device = resolve(device, "prefetch_to_device")

    def put_array(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    return _prefetch(iterator, lambda item: _tree_map(put_array, item), size)


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
