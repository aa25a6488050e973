"""Build the port's CUDA kernels with `nvcc` and bind them with ctypes.

Each source under `csrc/` compiles on first use into its own shared
library with a plain `extern "C"` interface (no PyTorch headers, so a
build takes seconds, not minutes), for `sm_90a`:

    nvcc -O3 -gencode=arch=compute_90a,code=sm_90a -std=c++17 -shared \
         -Xcompiler -fPIC -o <build dir>/lib<name>-<digest>.so csrc/<name>.cu

The library lands in `_build/` beside this file (listed in .gitignore),
named by a digest of the source and the flags, so an edited source never
loads a stale library. A failed build raises with nvcc's output: nothing
falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

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

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Kernel sources, by name (the file stem under csrc/)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
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


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu's library, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib
