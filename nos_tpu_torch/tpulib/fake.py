"""Port of `nos_tpu/tpulib/fake.py` (:1-102): `FakeTpuClient` (:13). Copied
verbatim; only the imports point at the port, which imports nothing of the
JAX package.

In-memory TpuClient (the mockery-mock analog, pkg/test/mocks/mig)."""

from __future__ import annotations

import itertools
import threading
from typing import Dict, List, Optional, Tuple

from nos_tpu_torch.tpu import Profile, Topology
from nos_tpu_torch.tpulib.interface import SliceHandle, TpuLibError


class FakeTpuClient:
    def __init__(self, topology: Topology, fail_next: int = 0):
        self._topology = topology
        self._slices: Dict[str, SliceHandle] = {}
        self._ids = itertools.count(1)
        self._lock = threading.RLock()
        # Fault injection: fail the next N mutating calls (tests only).
        self.fail_next = fail_next
        self._healthy = True

    def _maybe_fail(self, op: str) -> None:
        if self.fail_next > 0:
            self.fail_next -= 1
            raise TpuLibError(f"injected failure: {op}")

    # -- TpuClient ----------------------------------------------------------
    def get_topology(self) -> Topology:
        return self._topology

    def list_slices(self) -> List[SliceHandle]:
        with self._lock:
            return sorted(self._slices.values(), key=lambda s: s.slice_id)

    def create_slice(
        self, profile: Profile, origin: Tuple[int, ...], dims: Tuple[int, ...]
    ) -> SliceHandle:
        with self._lock:
            self._maybe_fail("create_slice")
            # Overlap guard: the canonical packer should never produce overlaps;
            # the device layer still refuses them (defense in depth).
            new_cells = _cells(origin, dims)
            for s in self._slices.values():
                if new_cells & _cells(s.origin, s.dims):
                    raise TpuLibError(
                        f"slice {profile} at {origin} overlaps existing {s.slice_id}"
                    )
            for coord in new_cells:
                if any(
                    c < 0 or c >= m for c, m in zip(coord, self._topology.shape.dims)
                ):
                    raise TpuLibError(f"slice {profile} at {origin} out of mesh bounds")
            handle = SliceHandle(
                slice_id=f"slice-{next(self._ids)}",
                profile=profile,
                origin=tuple(origin),
                dims=tuple(dims),
            )
            self._slices[handle.slice_id] = handle
            return handle

    def delete_slice(self, slice_id: str) -> None:
        with self._lock:
            self._maybe_fail("delete_slice")
            s = self._slices.get(slice_id)
            if s is None:
                raise TpuLibError(f"no such slice {slice_id}")
            if s.in_use:
                raise TpuLibError(f"slice {slice_id} is in use")
            del self._slices[slice_id]

    def delete_all_except(self, keep_ids: List[str]) -> List[str]:
        with self._lock:
            deleted = []
            for sid in list(self._slices):
                if sid not in keep_ids and not self._slices[sid].in_use:
                    del self._slices[sid]
                    deleted.append(sid)
            return deleted

    def set_slice_in_use(self, slice_id: str, in_use: bool) -> None:
        with self._lock:
            s = self._slices.get(slice_id)
            if s is None:
                raise TpuLibError(f"no such slice {slice_id}")
            self._slices[slice_id] = SliceHandle(
                s.slice_id, s.profile, s.origin, s.dims, in_use
            )

    def set_healthy(self, healthy: bool) -> None:
        self._healthy = healthy

    def health(self) -> Optional[str]:
        return None if self._healthy else "unhealthy (injected)"


def _cells(origin: Tuple[int, ...], dims: Tuple[int, ...]) -> set:
    out = {()}
    for o, d in zip(origin, dims):
        out = {c + (v,) for c in out for v in range(o, o + d)}
    return out
