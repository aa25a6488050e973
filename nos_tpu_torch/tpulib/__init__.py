"""Port of `nos_tpu/tpulib/__init__.py` (:1-22). Copied verbatim; only the
imports point at the port, which imports nothing of the JAX package.

tpulib: the device-control seam.

Where the reference drives NVML through cgo (pkg/gpu/nvml, build-tagged so CI
never needs a GPU — SURVEY.md §4 "hardware-boundary mocking"), this package
drives TPU sub-slice carving. Five backends satisfy one interface:

  - FakeTpuClient (pure Python) — tests and the in-memory runtime;
  - NativeTpuClient (ctypes over the C++ shim in native/) — the production
    analog of the cgo layer, modeling slice lifecycle natively;
  - CloudTpuClient (tpulib/cloud.py) — the real-infrastructure backend: a
    from-scratch REST client over the Cloud-TPU-v2-shaped queuedResources
    provisioning surface (long-running operations, async quota denial,
    retries), fixture-tested against tpulib/cloud_server.py;
  - LocalChipClient (tpulib/local.py) — discovery and health on the REAL
    local chips via the XLA runtime's device enumeration; slice
    bookkeeping stays logical (no carve syscall exists on a single chip).
"""

from nos_tpu_torch.tpulib.interface import SliceHandle, TpuClient, TpuLibError  # noqa: F401
from nos_tpu_torch.tpulib.fake import FakeTpuClient  # noqa: F401
from nos_tpu_torch.tpulib.cloud import CloudTpuClient, QuotaExhaustedError  # noqa: F401
from nos_tpu_torch.tpulib.local import LocalChipClient, discover_local_topology  # noqa: F401
