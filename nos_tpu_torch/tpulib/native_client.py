"""Port of `nos_tpu/tpulib/native_client.py` (:1-248): `ensure_built` (:29),
`load_library` (:47), `native_pack` (:100), `NativeTpuClient` (:148). The
bindings, `native_pack` and `NativeTpuClient` are copied verbatim; the
build differs. The reference runs `make` in its own source directory
(:29-44); the port compiles its own copy of the shim,
`native/tpuslice.cpp`, with one g++ command at first use:

    g++ -O2 -Wall -Wextra -fPIC -std=c++17 -shared \
        -o native/_build/libtpuslice_torch-<digest>.so native/tpuslice.cpp

into `native/_build/` (listed in .gitignore), named by a digest of the
source and the flags so an edited source never loads a stale library. The
name is the port's own: the JAX package's `libtpuslice.so` may be loaded in
the same process, and neither package opens the other's file. Importing
this module builds nothing.

ctypes bindings for the native tpuslice shim.

The build-tag seam of the reference (nvml build tag keeping cgo out of CI,
SURVEY.md §4): `load_library()` returns None when the shared object cannot
be built and callers fall back to the pure-Python FakeTpuClient;
`ensure_built()` compiles it on demand with the in-image toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Tuple

from nos_tpu_torch.tpu import Profile, Topology
from nos_tpu_torch.tpulib.interface import SliceHandle, TpuLibError

logger = logging.getLogger(__name__)

_NATIVE_DIR = Path(__file__).resolve().parent / "native"
_SOURCE = _NATIVE_DIR / "tpuslice.cpp"
BUILD_DIR = _NATIVE_DIR / "_build"
CXX_FLAGS = ("-O2", "-Wall", "-Wextra", "-fPIC", "-std=c++17", "-shared")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(_SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libtpuslice_torch-{digest.hexdigest()[:16]}.so"


def ensure_built(force: bool = False) -> bool:
    """Build the shim if needed. Returns True when available. The compiler
    writes a temporary file that is renamed into place, so processes that
    build at once never load a half-written library."""
    with _lock:
        out = library_path()
        if out.exists() and not force:
            return True
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(
                [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, str(_SOURCE)],
                check=True,
                capture_output=True,
                text=True,
            )
            os.replace(tmp, out)
            return True
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            logger.warning("tpuslice native build failed: %s %s", e, getattr(e, "stderr", ""))
            return False
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)


def load_library() -> Optional[ctypes.CDLL]:
    """The shim, built on first use and loaded once; None when it cannot be
    built (the caller then uses FakeTpuClient)."""
    global _lib
    if _lib is not None:
        return _lib
    if not ensure_built():
        return None
    lib = ctypes.CDLL(str(library_path()))
    lib.tpuslice_init.restype = ctypes.c_void_p
    lib.tpuslice_init.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.tpuslice_destroy.argtypes = [ctypes.c_void_p]
    lib.tpuslice_create.restype = ctypes.c_int
    lib.tpuslice_create.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.tpuslice_delete.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tpuslice_set_in_use.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.tpuslice_delete_all_except.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
    ]
    lib.tpuslice_count.argtypes = [ctypes.c_void_p]
    lib.tpuslice_get.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.tpuslice_health.argtypes = [ctypes.c_void_p]
    lib.tpuslice_set_health.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tpuslice_pack.restype = ctypes.c_int
    lib.tpuslice_pack.argtypes = [
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    _lib = lib
    return _lib


def _int_array(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


def native_pack(
    mesh_dims: Tuple[int, ...],
    occupied: List[Tuple[Tuple[int, ...], Tuple[int, ...]]],
    geometry,
) -> Optional[List[Tuple[Tuple[int, ...], Tuple[int, ...]]]]:
    """Run the native packer. Profiles are sorted here in the same canonical
    order as packing.py so both produce identical placements. Returns
    [(origin, dims), ...] in placement order, or None if unpackable."""
    lib = load_library()
    if lib is None:
        raise TpuLibError("native tpuslice library unavailable")
    rank = len(mesh_dims)
    profiles = sorted(geometry, key=lambda p: (-p.chips, p.name))
    prof_dims: List[int] = []
    counts: List[int] = []
    total = 0
    for p in profiles:
        if p.shape.rank != rank:
            return None
        prof_dims.extend(p.shape.dims)
        counts.append(int(geometry[p]))
        total += int(geometry[p])
    occ_flat: List[int] = []
    for origin, dims in occupied:
        occ_flat.extend(origin)
        occ_flat.extend(dims)
    out = (ctypes.c_int * max(1, total * 2 * rank))()
    n = lib.tpuslice_pack(
        _int_array(list(mesh_dims)),
        rank,
        _int_array(occ_flat) if occ_flat else _int_array([0]),
        len(occupied),
        _int_array(prof_dims) if prof_dims else _int_array([0]),
        _int_array(counts) if counts else _int_array([0]),
        len(profiles),
        out,
    )
    if n < 0:
        return None
    placements = []
    for i in range(n):
        base = i * 2 * rank
        origin = tuple(out[base + j] for j in range(rank))
        dims = tuple(out[base + rank + j] for j in range(rank))
        placements.append((origin, dims))
    return placements


class NativeTpuClient:
    """TpuClient backed by the native shim — the production analog of the
    cgo NVML client (slice lifecycle lives in C++, Python orchestrates)."""

    def __init__(self, topology: Topology):
        lib = load_library()
        if lib is None:
            raise TpuLibError("native tpuslice library unavailable")
        self._lib = lib
        self._topology = topology
        dims = _int_array(list(topology.shape.dims))
        self._ctx = lib.tpuslice_init(dims, topology.shape.rank)
        if not self._ctx:
            raise TpuLibError("tpuslice_init failed")
        self._profiles: dict = {}  # slice_id -> Profile

    def __del__(self):
        try:
            if getattr(self, "_ctx", None):
                self._lib.tpuslice_destroy(self._ctx)
                self._ctx = None
        except Exception:  # nos-lint: ignore[NOS003] — __del__ must never
            # raise, and logging during interpreter teardown can itself fail.
            pass

    # -- TpuClient ----------------------------------------------------------
    def get_topology(self) -> Topology:
        return self._topology

    def list_slices(self) -> List[SliceHandle]:
        rank = self._topology.shape.rank
        out = []
        count = self._lib.tpuslice_count(self._ctx)
        for idx in range(count):
            sid = ctypes.c_int()
            in_use = ctypes.c_int()
            origin = (ctypes.c_int * rank)()
            dims = (ctypes.c_int * rank)()
            if (
                self._lib.tpuslice_get(
                    self._ctx, idx, ctypes.byref(sid), origin, dims, ctypes.byref(in_use)
                )
                != 0
            ):
                continue
            profile = self._profiles.get(sid.value) or Profile(
                type(self._topology.shape)(tuple(sorted(dims)))
            )
            out.append(
                SliceHandle(
                    slice_id=f"slice-{sid.value}",
                    profile=profile,
                    origin=tuple(origin),
                    dims=tuple(dims),
                    in_use=bool(in_use.value),
                )
            )
        return sorted(out, key=lambda s: s.slice_id)

    def _raw_id(self, slice_id: str) -> int:
        return int(slice_id.rsplit("-", 1)[-1])

    def create_slice(self, profile: Profile, origin, dims) -> SliceHandle:
        ret = self._lib.tpuslice_create(
            self._ctx, _int_array(list(origin)), _int_array(list(dims))
        )
        if ret == -1:
            raise TpuLibError(f"slice {profile} at {origin} out of mesh bounds")
        if ret == -2:
            raise TpuLibError(f"slice {profile} at {origin} overlaps existing slice")
        if ret < 0:
            raise TpuLibError(f"tpuslice_create failed ({ret})")
        self._profiles[ret] = profile
        return SliceHandle(f"slice-{ret}", profile, tuple(origin), tuple(dims))

    def delete_slice(self, slice_id: str) -> None:
        ret = self._lib.tpuslice_delete(self._ctx, self._raw_id(slice_id))
        if ret == -2:
            raise TpuLibError(f"slice {slice_id} is in use")
        if ret != 0:
            raise TpuLibError(f"no such slice {slice_id}")
        self._profiles.pop(self._raw_id(slice_id), None)

    def delete_all_except(self, keep_ids: List[str]) -> List[str]:
        before = {s.slice_id for s in self.list_slices()}
        raw = [self._raw_id(k) for k in keep_ids]
        self._lib.tpuslice_delete_all_except(
            self._ctx, _int_array(raw) if raw else _int_array([0]), len(raw)
        )
        after = {s.slice_id for s in self.list_slices()}
        return sorted(before - after)

    def set_slice_in_use(self, slice_id: str, in_use: bool) -> None:
        ret = self._lib.tpuslice_set_in_use(
            self._ctx, self._raw_id(slice_id), 1 if in_use else 0
        )
        if ret != 0:
            raise TpuLibError(f"no such slice {slice_id}")

    def health(self) -> Optional[str]:
        return None if self._lib.tpuslice_health(self._ctx) else "unhealthy"
