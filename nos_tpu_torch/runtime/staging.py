"""Host<->device staging discipline for the serving engine's tick path.

Port of `nos_tpu/runtime/staging.py`: `SyncLedger` (:53), `HostStage` (:68)
and `TickState` (:87, with `mesh` :99-142).

  - ``HostStage`` is the one host->device funnel of the tick path: every
    upload goes through :meth:`HostStage.to_device`, which counts it
    (``h2d_uploads``). On CUDA the value is staged in pinned host memory
    and copied with ``non_blocking=True``, so an upload never stalls the
    host behind the stream.
  - ``TickState`` holds the per-slot tick metadata on the device: the block
    table plus pos / mask / serial / step / steps_left. The macro program
    advances pos / step / steps_left itself; host events mark the state
    dirty and the next dispatch re-syncs it with ONE packed
    [n_slots, max_pages + 5] int32 upload.
  - ``SyncLedger`` counts blocking device->host reads on the tick path
    (every `.item()`, `.cpu()`, `.tolist()`, host materialization or
    synchronize): the ``blocking_syncs`` budget.
"""

from __future__ import annotations

import numpy as np
import torch


class SyncLedger:
    """Counts blocking device->host reads on the tick path."""

    __slots__ = ("syncs",)

    def __init__(self) -> None:
        self.syncs = 0

    def note(self) -> None:
        self.syncs += 1


class HostStage:
    """The counted host->device staging funnel."""

    __slots__ = ("uploads", "device")

    def __init__(self, device: torch.device) -> None:
        self.uploads = 0
        self.device = torch.device(device)

    def to_device(self, value, dtype: torch.dtype = None) -> torch.Tensor:
        """One counted host->device transfer of a numpy array or list. The
        result never aliases `value`: later host edits do not reach it."""
        self.uploads += 1
        host = torch.as_tensor(np.asarray(value))
        if dtype is not None:
            host = host.to(dtype)
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host.clone()


class TickState:
    """Device-resident per-slot tick metadata behind the staging API.

    Columns of the packed buffer ([n_slots, max_pages + 5] int32): the
    block-table row, then pos, mask (0/1), serial, step, steps_left.
    `sync` performs the single counted upload and unpacks it on the
    device (each field contiguous, as the kernels require); `advance`
    swaps in the program-advanced pos/step/steps_left.

    With a tensor-parallel `mesh` the upload stays ONE counted transfer to
    the stage's device, whatever the width; `tables` then holds the table
    once per shard of `tp_axis`, copied device to device to each distinct
    shard device (no copy where a shard shares the stage's device, and the
    copies are not uploads). Only the table is read per shard: pos, mask,
    serial, step and steps_left feed the macro's arithmetic, which runs
    once on the stage's device."""

    def __init__(self, stage: HostStage, n_slots: int, max_pages: int, mesh=None,
                 tp_axis: str = "tp"):
        self._stage = stage
        self._devices = mesh.axis_devices(tp_axis) if mesh is not None else None
        self.n_slots = int(n_slots)
        self.max_pages = int(max_pages)
        self.dirty = True
        #: The table changes only on admit/release/reset; the prefill
        #: programs read only the table and sync against this flag.
        self.table_dirty = True
        #: Packed-sync count.
        self.syncs = 0
        self.table = None
        #: The table on every shard's device, in shard order.
        self.tables = None
        self.pos = None
        self.mask = None
        self.serial = None
        self.step = None
        self.steps_left = None

    def mark_dirty(self) -> None:
        """Slot scheduling metadata changed on the host."""
        self.dirty = True

    def mark_table_dirty(self) -> None:
        """The block table itself changed (admit, release, reset)."""
        self.dirty = True
        self.table_dirty = True

    def sync(self, packed: np.ndarray) -> None:
        """One packed staging upload + the device-side unpack. No-op
        unless dirty."""
        if not self.dirty and not self.table_dirty:
            return
        dev = self._stage.to_device(packed, dtype=torch.int32)
        P = self.max_pages
        self.table = dev[:, :P].contiguous()
        self.tables = ([self.table] if self._devices is None
                       else [self.table.to(d) for d in self._devices])
        self.pos = dev[:, P].contiguous()
        self.mask = dev[:, P + 1] > 0
        self.serial = dev[:, P + 2].contiguous()
        self.step = dev[:, P + 3].contiguous()
        self.steps_left = dev[:, P + 4].contiguous()
        self.syncs += 1
        self.dirty = False
        self.table_dirty = False

    def advance(self, pos, step, steps_left) -> None:
        """Swap in the post-dispatch metadata the program computed: no
        host->device traffic."""
        self.pos = pos
        self.step = step
        self.steps_left = steps_left
