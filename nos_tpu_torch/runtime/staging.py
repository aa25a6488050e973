"""Host<->device staging discipline for the serving engine's tick path.

Port of `nos_tpu/runtime/staging.py`: `SyncLedger` (:53), `HostStage` (:68)
and `TickState` (:87, with `mesh` :99-142).

  - ``HostStage`` is the one host->device funnel of the tick path: every
    upload goes through :meth:`HostStage.to_device` (or, into a buffer
    allocated once, :meth:`HostStage.upload`), which counts it
    (``h2d_uploads``). On CUDA the value is staged in pinned host memory
    and copied with ``non_blocking=True``, so an upload never stalls the
    host behind the stream.
  - ``TickState`` holds the per-slot tick metadata on the device: the block
    table plus pos / mask / serial / step / steps_left, in buffers
    allocated once (a captured CUDA graph holds their addresses). The
    macro program advances pos / step / steps_left in place; host events
    mark the state dirty and the next dispatch re-syncs it with ONE packed
    [n_slots, max_pages + 5] int32 upload, copied into the buffers.
  - ``SyncLedger`` counts blocking device->host reads on the tick path
    (every `.item()`, `.cpu()`, `.tolist()`, host materialization or
    synchronize): the ``blocking_syncs`` budget.

Both carry the engine's TickProfiler (a disabled one without tracing):
an upload is a `stage` span, a token ref's wait a `read_wait` span.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from nos_tpu_torch.tracing import TickProfiler


class SyncLedger:
    """Counts blocking device->host reads on the tick path (and the fleet
    supervisor's passive reads of the engine's token refs, from its own
    thread: the count takes a lock). `profiler` is the engine's
    TickProfiler: a reader wraps its wait in `profiler.read_wait()`."""

    __slots__ = ("syncs", "_lock", "profiler")

    def __init__(self, profiler: Optional[TickProfiler] = None) -> None:
        self.syncs = 0
        self._lock = threading.Lock()
        self.profiler = profiler if profiler is not None else TickProfiler(enabled=False)

    def note(self) -> None:
        with self._lock:
            self.syncs += 1


class HostStage:
    """The counted host->device staging funnel; each upload runs inside
    `profiler.stage()` (the engine's TickProfiler)."""

    __slots__ = ("uploads", "device", "profiler")

    def __init__(self, device: torch.device, profiler: Optional[TickProfiler] = None) -> None:
        self.uploads = 0
        self.device = torch.device(device)
        self.profiler = profiler if profiler is not None else TickProfiler(enabled=False)

    def to_device(self, value, dtype: torch.dtype = None) -> torch.Tensor:
        """One counted host->device transfer of a numpy array, a list or a
        CPU tensor (a spill payload). The result never aliases `value`:
        later host edits do not reach it."""
        self.uploads += 1
        with self.profiler.stage():
            host = value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
            if dtype is not None:
                host = host.to(dtype)
            if self.device.type == "cuda":
                return host.pin_memory().to(self.device, non_blocking=True)
            return host.clone()

    def upload(self, dst: torch.Tensor, value: np.ndarray) -> None:
        """One counted host->device transfer of a 1-D numpy array into the
        leading elements of `dst`, a buffer allocated once (a captured
        graph's input): pinned and non-blocking on CUDA, as `to_device`."""
        self.uploads += 1
        with self.profiler.stage():
            host = torch.from_numpy(np.ascontiguousarray(value))
            if self.device.type == "cuda":
                host = host.pin_memory()
            dst[: host.numel()].copy_(host, non_blocking=True)


class TickState:
    """Device-resident per-slot tick metadata behind the staging API.

    Columns of the packed buffer ([n_slots, max_pages + 5] int32): the
    block-table row, then pos, mask (0/1), serial, step, steps_left.
    Every field is a contiguous buffer on the stage's device, allocated
    once (zeros: no lane active) and only ever written in place, so a
    CUDA graph that reads them stays valid. `sync` performs the single
    counted upload and copies it into the fields on the device; the
    engine's window advances pos / step / steps_left in place.

    With a tensor-parallel `mesh` the upload stays ONE counted transfer to
    the stage's device, whatever the width; `tables` then holds the table
    once per shard of `tp_axis`: `table` itself where a shard shares the
    stage's device, else a buffer on the shard's device that `sync` copies
    into device to device (the copies are not uploads). Only the table is
    read per shard: pos, mask, serial, step and steps_left feed the
    macro's arithmetic, which runs once on the stage's device."""

    def __init__(self, stage: HostStage, n_slots: int, max_pages: int, mesh=None,
                 tp_axis: str = "tp"):
        self._stage = stage
        self.n_slots = int(n_slots)
        self.max_pages = int(max_pages)
        self.dirty = True
        #: The table changes only on admit/release/reset; the prefill
        #: programs read only the table and sync against this flag.
        self.table_dirty = True
        #: Packed-sync count.
        self.syncs = 0

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=stage.device)

        self.table = zeros(self.n_slots, self.max_pages)
        #: The table on every shard's device, in shard order.
        self.tables = ([self.table] if mesh is None
                       else [self.table.to(d) for d in mesh.axis_devices(tp_axis)])
        self.pos = zeros(self.n_slots)
        self.mask = zeros(self.n_slots, dtype=torch.bool)
        self.serial = zeros(self.n_slots)
        self.step = zeros(self.n_slots)
        self.steps_left = zeros(self.n_slots)

    def mark_dirty(self) -> None:
        """Slot scheduling metadata changed on the host."""
        self.dirty = True

    def mark_table_dirty(self) -> None:
        """The block table itself changed (admit, release, reset)."""
        self.dirty = True
        self.table_dirty = True

    def sync(self, packed: Optional[np.ndarray]) -> None:
        """One packed staging upload, copied into the fields on the device.
        No-op unless dirty, or when there is nothing packed (None)."""
        if packed is None or (not self.dirty and not self.table_dirty):
            return
        dev = self._stage.to_device(packed, dtype=torch.int32)
        P = self.max_pages
        self.table.copy_(dev[:, :P])
        for t in self.tables:
            if t is not self.table:
                t.copy_(self.table)
        self.pos.copy_(dev[:, P])
        self.mask.copy_(dev[:, P + 1] > 0)
        self.serial.copy_(dev[:, P + 2])
        self.step.copy_(dev[:, P + 3])
        self.steps_left.copy_(dev[:, P + 4])
        self.syncs += 1
        self.dirty = False
        self.table_dirty = False
