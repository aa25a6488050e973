"""Port of `nos_tpu/tpulib/local.py` (:1-337): `generation_for_device_kind`
(:74), `discover_local_topology` (:99), `LocalChipClient` (:150),
`verify_topology` (:303), `local_chips_visible` (:326). The discovery math
(`_discover`, :109-147), `_DEVICE_KIND_GENERATIONS` (:63), the TPU filter,
`verify_topology` and the watchdog (`_call_with_deadline`, the "wedged"
bookkeeping) are copied verbatim. Two seams differ, since the port's
runtime is torch's CUDA runtime, not XLA's:

  - **Enumeration** (:81-96, `jax.local_devices()` at :87). `_local_devices`
    lists every CUDA device as a `CudaDevice` record: `platform` "gpu",
    `device_kind` from `torch.cuda.get_device_name`, `id`, `coords` None
    (CUDA reports no chip coordinates), `torch_device`, and
    `memory_stats()` with the reference's keys from torch's allocator.
    `_local_tpu_devices` keeps the TPU filter, so on a GPU host
    `discover_local_topology()` raises the typed `TpuLibError`, its
    message naming the device kinds it found, and `local_chips_visible()`
    is False. No GPU generation is added to the table.
  - **The probe** (`_probe_chip`, :251-273: a `device_put` and an add at
    :263-264). The port does the one-element add with torch on the
    record's `torch_device` and synchronizes a CUDA device before it
    reads the value.

LocalChipClient: TpuClient whose discovery and health run on REAL silicon.

The reference's device layer talks to hardware through NVML
(pkg/gpu/nvml/client.go:148-223 — device enumeration, memory info, health).
This backend is that layer's TPU analog for the machine the agent runs on:

  - **Discovery is real.** Generation and mesh shape are read from the XLA
    runtime's device enumeration — `device_kind` strings ("TPU v5 lite",
    "TPU v4", ...) map to the generation table, and the chip-coordinate
    bounding box of the local devices yields the node's mesh shape. No
    labels, no environment variables: the same source of truth libtpu gives
    every JAX program on the host.
  - **Health is real.** `health()` dispatches a one-element computation to
    every local chip and blocks on the result; a chip that cannot complete
    an add is reported with the runtime's error string (the
    XID-error-watch analog of the reference's nvml health surface).
  - **Carve lifecycle is logical, by design.** A single in-service chip has
    no NVML-like "create compute instance" syscall — sub-chip sharing on
    TPU is runtime multiplexing (runtime/slice_server.py), and MULTI-chip
    carving is a provisioning-plane operation (tpulib/cloud.py drives the
    queued-resources surface). So slice bookkeeping here reuses the
    canonical state machine (overlap/bounds/in-use guards) seeded with the
    REAL discovered topology; docs/tpulib.md states the real-vs-modeled
    boundary.

The agent composes this with the node-label topology as a cross-check:
labels are operator intent, the device runtime is ground truth, and a
mismatch is surfaced loudly (`verify_topology`) — on which the agent
declines the local backend rather than actuate a geometry the control
plane didn't plan for.

**Chip-ownership contract.** libtpu grants the chips to ONE process at a
time, so this backend activates only on the operator's EXPLICIT grant:
the `NOS_TPU_LOCAL_CHIPS=1` environment variable, which the chart's
`tpuAgent.localChips` value sets together with the `google.com/tpu`
resource request. Mere visibility never activates it — even probing
initializes the single-process runtime, which on a shared TPU VM would
seize the chips out from under colocated workloads. Do not grant chips
to both the agent and workload pods on the same node — the second
process to initialize fails with the runtime's "device already in use"
error. The intended colocations are (a) health/discovery daemonsets on
nodes whose workloads run elsewhere, and (b) this framework's own
fractional-sharing runtime, where workloads share the agent process's
runtime through `runtime/slice_server.py` rather than opening the chips
themselves.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import torch

from nos_tpu_torch.tpu import Topology
from nos_tpu_torch.tpu.shape import Shape
from nos_tpu_torch.tpulib.fake import FakeTpuClient
from nos_tpu_torch.tpulib.interface import TpuLibError

logger = logging.getLogger(__name__)

# device_kind prefix -> generation (topology.py _ACCELERATOR_GENERATIONS is
# keyed by GKE label values; this table is keyed by what the PJRT runtime
# reports). Longest prefix wins so "TPU v5 lite" resolves before "TPU v5".
_DEVICE_KIND_GENERATIONS: Tuple[Tuple[str, str], ...] = (
    ("TPU v5 lite", "v5e"),
    ("TPU v5e", "v5e"),
    ("TPU v6 lite", "v6e"),
    ("TPU v6e", "v6e"),
    ("TPU v5p", "v5p"),
    ("TPU v5", "v5p"),
    ("TPU v4", "v4"),
)


def generation_for_device_kind(kind: str) -> Optional[str]:
    for prefix, gen in _DEVICE_KIND_GENERATIONS:
        if kind.startswith(prefix):
            return gen
    return None


class CudaDevice:
    """One CUDA device as the discovery and the probe see it: the fields of
    the reference's PJRT device that this module reads."""

    platform = "gpu"
    coords = None

    def __init__(self, index: int):
        self.id = index
        self.device_kind = torch.cuda.get_device_name(index)
        self.torch_device = torch.device("cuda", index)

    def memory_stats(self) -> dict:
        """The reference's allocator keys from torch's caching allocator;
        `bytes_limit` is the device's total memory."""
        return {
            "bytes_in_use": torch.cuda.memory_allocated(self.torch_device),
            "bytes_limit": torch.cuda.mem_get_info(self.torch_device)[1],
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(self.torch_device),
        }

    def __repr__(self) -> str:
        return f"CudaDevice(id={self.id}, kind={self.device_kind!r})"


def _local_devices() -> List[CudaDevice]:
    """Every device of this host's CUDA runtime, by index."""
    try:
        return [CudaDevice(i) for i in range(torch.cuda.device_count())]
    except Exception as e:  # noqa: BLE001 — runtime init failure = no device
        raise TpuLibError(f"device runtime unavailable: {e}") from e


def _local_tpu_devices():
    devices = _local_devices()
    tpus = [d for d in devices if d.platform == "tpu"]
    if not tpus:
        raise TpuLibError(
            f"no local TPU devices (platforms: "
            f"{sorted({d.platform for d in devices})}, kinds: "
            f"{sorted({d.device_kind for d in devices})})"
        )
    return tpus


def discover_local_topology() -> Topology:
    """Topology of THIS host's chips, from the device runtime.

    Generation comes from `device_kind`; the mesh shape is the bounding box
    of the local chips' coordinates (2D generations report coords (x, y, 0),
    3D generations use all three axes). A lone chip is a 1x1 (or 1x1x1)
    mesh — the fractional-sharing host shape."""
    return _discover(_local_tpu_devices())


def _discover(tpus) -> Topology:
    kinds = sorted({d.device_kind for d in tpus})
    if len(kinds) != 1:
        raise TpuLibError(f"mixed device kinds on one host: {kinds}")
    gen = generation_for_device_kind(kinds[0])
    if gen is None:
        raise TpuLibError(f"unknown TPU device kind {kinds[0]!r}")
    coords = []
    rank = 3 if gen in ("v4", "v5p") else 2
    for d in tpus:
        c = getattr(d, "coords", None)
        if c is None:
            raise TpuLibError(f"device {d} exposes no chip coordinates")
        try:
            parsed = tuple(int(v) for v in c)
        except (TypeError, ValueError) as e:
            raise TpuLibError(f"malformed chip coordinates {c!r}: {e}") from e
        if len(parsed) < rank:
            # Must be TpuLibError, not a bare IndexError downstream: the
            # agent builder's fall-through contract catches only the
            # typed device-layer error.
            raise TpuLibError(
                f"device coordinates {parsed} shorter than the "
                f"{gen} mesh rank {rank}"
            )
        coords.append(parsed)
    lo = [min(c[i] for c in coords) for i in range(rank)]
    hi = [max(c[i] for c in coords) for i in range(rank)]
    dims = tuple(h - l + 1 for l, h in zip(lo, hi))
    topo = Topology(gen, Shape(dims))
    if topo.chips != len(tpus):
        # A holey enumeration (dead chip inside the bounding box) must not
        # be reported as a full mesh — the agent would plan slices over a
        # chip that does not exist and health() would never probe it.
        raise TpuLibError(
            f"incomplete chip enumeration: bounding box {topo.shape.name} "
            f"implies {topo.chips} chips but the runtime reports {len(tpus)}"
        )
    return topo


class LocalChipClient(FakeTpuClient):
    """TpuClient over the host's real chips.

    Inherits the canonical slice state machine (overlap, bounds, in-use,
    crash-recovery cleanup — the part with no hardware syscall on TPU) and
    replaces its two hardware-facing surfaces with the real thing:
    construction discovers the topology from the device runtime, and
    `health()` probes every chip with a live computation."""

    def __init__(self, expected: Optional[Topology] = None):
        # ONE enumeration feeds both the topology and the probe list — a
        # second call could see a chip drop out in between, leaving a
        # state machine sized for N chips but a health probe covering N-1.
        devices = _local_tpu_devices()
        topology = _discover(devices)
        self.topology_mismatch: Optional[str] = None
        if expected is not None:
            self.topology_mismatch = verify_topology(topology, expected)
            if self.topology_mismatch is None:
                # Same physical mesh, possibly transposed in the runtime's
                # coordinate order: seed the slice state machine with the
                # LABEL orientation — plans, annotations, and packer output
                # are all written in control-plane (label) coordinates.
                topology = expected
        super().__init__(topology)
        self._devices = devices
        # device -> timeout reason, sticky. A wedged libtpu call never
        # unwedges without a process restart, and re-probing it would leak
        # one abandoned watchdog thread per poll (10s cadence = thousands
        # of pinned stacks per day on a long-lived agent).
        self._wedged: dict = {}

    #: Per-chip probe deadline. TPU runtime failures often manifest as
    #: HANGS, not exceptions — without a watchdog a wedged chip would
    #: stall the health monitor thread forever with the node still
    #: labeled healthy (the worst possible failure mode for a health
    #: probe). The probe thread is daemonic: if it never returns, it is
    #: abandoned, and the chip is reported unhealthy.
    probe_timeout_s: float = 30.0

    def health(self) -> Optional[str]:
        """None when every local chip completes a probe computation within
        the deadline, else the first failure, formatted as
        'chip <coords>: <reason>'. A chip whose probe TIMED OUT (the
        watchdog fired — distinct from a probe that returned an error) is
        remembered as wedged and never re-probed: its watchdog thread is
        already abandoned, and only a process restart can recover the
        runtime. Erroring probes are retried every cycle (a tunnel blip
        must not permanently condemn the chip)."""
        for d in self._devices:
            key = id(d)
            reason = self._wedged.get(key)
            if reason is None:
                reason, timed_out = _probe_chip(d, self.probe_timeout_s)
                if timed_out:
                    self._wedged[key] = reason
            if reason is not None:
                coords = getattr(d, "coords", None)
                ident = tuple(coords) if coords is not None else f"id={d.id}"
                return f"chip {ident}: {reason}"
        return None


    def device_stats(self) -> List[dict]:
        """Per-chip runtime statistics for the metrics surface: coords,
        kind, and — where the PJRT runtime exposes allocator stats — HBM
        bytes in use / limit. Entries omit what the runtime doesn't
        report (e.g. memory_stats() is None over a remote-dispatch
        tunnel); the agent exports whatever is present as gauges. The
        same hang discipline as health(): a chip already marked wedged is
        skipped, and the stats call itself runs under the watchdog so a
        wedged runtime cannot block the agent's report loop."""
        out = []
        for d in self._devices:
            entry: dict = {
                "coords": tuple(getattr(d, "coords", ()) or ()),
                "device_kind": getattr(d, "device_kind", ""),
            }
            if id(d) in self._wedged:
                out.append(entry)
                continue
            try:
                stats = _call_with_deadline(d.memory_stats, self.probe_timeout_s)
            except TimeoutError as e:
                self._wedged[id(d)] = f"memory_stats: {e}"
                stats = None
            except Exception:  # noqa: BLE001 — optional surface
                logger.debug("memory_stats probe failed", exc_info=True)
                stats = None
            if stats:
                for src, dst in (
                    ("bytes_in_use", "hbm_bytes_in_use"),
                    ("bytes_limit", "hbm_bytes_limit"),
                    ("peak_bytes_in_use", "hbm_peak_bytes_in_use"),
                ):
                    if src in stats:
                        entry[dst] = int(stats[src])
            out.append(entry)
        return out


def _probe_chip(device, timeout_s: float) -> Tuple[Optional[str], bool]:
    """One chip's live probe under the watchdog: (None, False) when a
    one-element computation completes correctly within `timeout_s`, else
    (reason, timed_out). `timed_out` is True ONLY when the watchdog fired
    and the probe thread was abandoned — an error whose message merely
    mentions a timeout (e.g. an RPC deadline from a tunnel blip) is a
    completed probe and must stay retryable."""

    def probe() -> Optional[str]:
        target = device.torch_device
        x = torch.ones((), dtype=torch.float32, device=target)
        y = x + x
        if target.type == "cuda":
            torch.cuda.synchronize(target)
        val = float(y)
        # 1.0 + 1.0 is IEEE-exact; anything else means a broken device.
        return None if val == 2.0 else f"probe returned {val}"  # nos-lint: ignore[NOS008]

    try:
        return _call_with_deadline(probe, timeout_s), False
    except TimeoutError:
        return f"probe timed out after {timeout_s:.0f}s", True
    except Exception as e:  # noqa: BLE001 — the reason IS the result
        return f"{type(e).__name__}: {e}", False


def _call_with_deadline(fn, timeout_s: float):
    """Run fn() on a watchdog thread; returns its result or raises
    TimeoutError. The same hang discipline as the probe: a wedged libtpu
    call must never block the caller's loop."""
    import threading

    out: list = []

    def run() -> None:
        try:
            out.append(("ok", fn()))
        except Exception as e:  # noqa: BLE001 — re-raised below
            out.append(("err", e))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise TimeoutError(f"call exceeded {timeout_s:.0f}s")
    if not out:
        raise RuntimeError("watchdog thread died without a result")
    kind, value = out[0]
    if kind == "err":
        raise value
    return value


def verify_topology(discovered: Topology, expected: Topology) -> Optional[str]:
    """Cross-check device truth against operator intent (node labels).

    Agreement is up to axis permutation: the runtime may enumerate a 2x4
    mesh as coords spanning 4x2 — same chips, same links, transposed
    order — so orientation differences corroborate (the caller then keeps
    the LABEL orientation, the control plane's coordinate convention).

    Returns None on agreement, else a human-readable mismatch description.
    Policy is the caller's: the agent builder declines to actuate on a
    geometry the control plane didn't plan for (it falls back to the
    label-shaped modeled backend and logs this), because the planner,
    annotations, and scheduler all derive from the labels."""
    if discovered.generation == expected.generation and any(
        o == expected.shape for o in discovered.shape.orientations()
    ):
        return None
    return (
        f"device runtime reports {discovered} but node labels declare "
        f"{expected}"
    )


def local_chips_visible() -> bool:
    """True when this host's device runtime can see TPU chips. Never raises.

    NB: answering the question initializes the (single-process) TPU
    runtime — call only where the process is entitled to the chips. The
    agent builder therefore gates on the NOS_TPU_LOCAL_CHIPS grant BEFORE
    any enumeration; this helper is for code already past that gate."""
    try:
        _local_tpu_devices()
        return True
    except TpuLibError:
        return False
