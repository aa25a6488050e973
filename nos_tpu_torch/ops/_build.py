"""Build the port's CUDA kernels with `nvcc` and bind them with ctypes.

Each source under `csrc/` compiles on first use into its own shared
library with a plain `extern "C"` interface (no PyTorch headers, so a
build takes seconds, not minutes), for `sm_90a`:

    nvcc -O3 -gencode=arch=compute_90a,code=sm_90a -std=c++17 -shared \
         -Xcompiler -fPIC -o <build dir>/lib<name>-<digest>.so csrc/<name>.cu

The library lands in `_build/` beside this file (listed in .gitignore),
named by a digest of the source, the shared headers (`csrc/*.cuh`) and the
flags, so an edited source or header never loads a stale library. A failed
build raises with nvcc's output: nothing falls back to a plain version.

`load` also binds the launchers' ctypes signatures and the error string
every library exports (`nos_cuda_error_string`, from `csrc/common.cuh`);
`raise_on`, `require`, `stream` and `count_launch` are the wrappers' shared
launch glue, and
`split_keys`/`split_scratch` size the split decode kernels' scratch
(`csrc/split_decode.cuh`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-O3",
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)

VP = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
LL = ctypes.c_longlong

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Kernel sources, by name (the file stem under csrc/)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless its library exists. Returns nvcc's
    output (ptxas' register, shared-memory and spill report; "" when the
    library existed); raises with that output when nvcc fails."""
    out = library_path(name)
    if out.exists():
        return ""
    nvcc = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not nvcc.is_file():
        nvcc = shutil.which("nvcc")
        if nvcc is None:
            raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run(
        [str(nvcc), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{res.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return res.stdout


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu's library, built on first use,
    with each launcher in `signatures` (function name -> argtypes) bound to
    return an int cudaError_t code."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = I
            lib.nos_cuda_error_string.argtypes = [I]
            lib.nos_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


#: Engines on one card may each run a thread (a replica set), and each
#: wrapper counts its launch from the thread that makes it: the counts are a
#: read-modify-write on shared dicts, so they take this lock.
_COUNT_LOCK = threading.Lock()


def count_launch(launches: dict, routes: dict, name: str, route: str, n: int = 1) -> None:
    """Add `n` launches of entry point `name` on `route` to a wrapper
    module's `LAUNCHES` and `ROUTE_LAUNCHES`."""
    with _COUNT_LOCK:
        launches[name] += n
        routes[name][route] += n


def raise_on(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if rc != 0:
        msg = lib.nos_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {rc})")


def require(cond: bool, msg: str, *args) -> None:
    """Raise ValueError(msg) unless cond; with args, msg is a str.format
    template filled only then (a launch's checks format nothing)."""
    if not cond:
        raise ValueError(msg.format(*args) if args else msg)


def stream(x) -> VP:
    """The current CUDA stream of tensor x's device, for a launcher."""
    return VP(torch.cuda.current_stream(x.device).cuda_stream)


@functools.lru_cache(maxsize=None)
def split_keys() -> int:
    """kSplitKeys, the keys of one split of the decode kernels, as
    csrc/split_decode.cuh defines it (its launcher checks the scratch sized
    from it)."""
    text = (CSRC / "split_decode.cuh").read_text()
    return int(re.search(r"constexpr int kSplitKeys = (\d+);", text).group(1))


_counters: Dict[torch.device, torch.Tensor] = {}
# Counter buffers outgrown by a larger launch: kept alive, since a captured
# CUDA graph (the engine's decode window) may still address one.
_retired: List[torch.Tensor] = []


def split_scratch(q, groups: int, rep: int, head_dim: int, keys: int):
    """The split decode kernels' scratch on q's device: the f32 partials
    (acc, m, l of every split of every (b, g) head; allocated per call) and
    the per-(b, g, row tile) arrival counters, zeroed once and kept: each
    launch leaves them at 0 again, so one stream may reuse them (two
    streams must not run the decode kernels on one device at once), and a
    CUDA graph may capture them (its replays leave them at 0 too)."""
    n_split = -(-keys // split_keys())
    part = torch.empty(groups * n_split * rep * (head_dim + 2), dtype=torch.float32,
                       device=q.device)
    need = max(groups * rep, 1)  # at least one counter per (b, g, row tile)
    with _lock:
        cnt = _counters.get(q.device)
        if cnt is None or cnt.numel() < need:
            if cnt is not None:
                _retired.append(cnt)
            cnt = torch.zeros(need, dtype=torch.int32, device=q.device)
            _counters[q.device] = cnt
    return part, cnt
