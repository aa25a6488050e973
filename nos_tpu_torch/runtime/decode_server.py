"""DecodeServer: continuous batching for autoregressive LLM serving.

Port of the engine core of `nos_tpu/runtime/decode_server.py` (:324). The
engine keeps a fixed set of batch lanes ("slots"), admits a waiting request
into a free slot by reserving its KV blocks, prefills prompts in bounded
chunks under a per-tick token budget, and steps every decoding slot together
through a K-step macro program, one token per sequence per step, each at its
own position in a block-paged KV pool. Sequences finish and free their slot
independently.

What this port carries over: the native pool and the int8 pool
(`kv_dtype="int8"`: codes with per-block scales, written through the
`ops/quantized_kv.py` funnel and read by the paged kernels' int8 routes;
its spill payloads are tagged 5-tuples and its chain keys salted), greedy
and temperature
sampling (the threefry keys of `nos_tpu_torch/prng.py`, bit for bit JAX's),
one device or a tensor-parallel mesh, the budgeted chunked prefill
(including the multi-slot `paged_prefill_window` wave), the K-step macro
decode, fused bursts of N macro windows in one dispatch (`burst_windows`,
4 by default as in the reference), the prefix cache as the radix tree
(`radix_cache=True`, the default: mid-block copy-on-write and multi-turn
registration of finished outputs) or as the flat chain index, the
host-RAM spill tier under it (`spill_blocks=None`, the default, sizes it
at one pool), speculative decoding (`spec_k > 0`: tree and prompt-lookup
drafts verified through `paged_verify_window`), eos handling, and the
reference's failure model (decode_server.py:3261-3497, its default):
`surgical_recovery=True` classifies a tick-path exception through the
fault taxonomy (`runtime/faults.py`): a transient fault retries the tick
after a capped exponential backoff and escalates past
`max_transient_retries`; a poison fault fails only the culpable slot and
checkpoints and restores the rest; a device-lost fault (and anything
unclassifiable) checkpoints every slot (`runtime/checkpoint.py`), resets
the pool and re-admits the checkpoints at the head of the line, where a
replay of prompt + generated tokens through the budgeted prefill
re-derives their KV (a sampled stream keeps its serial and continues its
threefry draws at the replayed step). A recovery that itself raises falls
back to failing every request, and so does `surgical_recovery=False`. A
seeded `FaultInjector` fires at the reference's sites, in the
reference's tick order: `admit`, `block_admit`, `revive`, `cow`,
`spill`, `dispatch_prefill_wave`, `dispatch_verify`, `resolve_verifies`,
`dispatch_burst`, `dispatch_macro` and `preempt`. `checkpoint_hook`
receives `checkpoint_snapshot()` at every burst boundary.

The fleet layer (decode_server.py:540-553, :582-599, :630-645): elastic
tenant quotas (`quota=QuotaPolicy(...)`, `runtime/quota.py`; requests
carry `submit(..., tenant=)`): admission skips a tenant at its ceiling,
or a borrower while a starved guaranteed tenant waits, in place, and
when a starved tenant's request cannot be hosted, `_enforce_quota`
preempts borrower slots lowest-priority-first (`_preempt_slot`: the
checkpoint recovery takes, the slot's blocks released to the host tier
through `_extract_block`, the checkpoint re-queued in the restore
region, usually revived from the tier on its replay). Tracing
(`tracing=EngineTracing()`, `nos_tpu_torch/tracing.py`): request spans,
the flight recorder's postmortem at every recovery, and the tick-phase
profiler behind `tick_phase_s` and the other tick read-throughs (all
zeros without it, as in the reference). `metrics=Metrics()`
(`observability.py`) publishes the engine's `nos_tpu_decode_*` series;
`cost_ledger=CostLedger()` (`serving/accounting.py`) bills each
request's tenant. All of it is host bookkeeping, the same with a mesh
or without; the one device piece is the burst's per-window token
counts, which the captured window writes into a fixed buffer
(`_win_counts`) and a quota-armed burst reads once.

The serving plane (`nos_tpu_torch/serving/`, decode_server.py:781-819,
:1378-1890, :2521-2640): `kv_store=FleetKVStore(...)` mounts the fleet
KV store as the host tier through a `StoreTier`, so replicas share one
content-addressed copy of each block; busy ticks publish a bounded
number of indexed blocks into it (`_publish_per_tick`) and idle ticks
the rest, read off the card in one pass (`_extract_blocks`), and
`prewarm_from_store` queues
a cold replica's copy-ins from it, drained under the prefill budget.
`probe`, `transfer_in_request`, `transfer_in_checkpoint`,
`drain_extract`, `forsake` and `reopen` are the hooks the router, the
drain controller and the fleet supervisor drive. Phase disaggregation
(decode_server.py:1433-1551, :1825, :2784-2868): a request admitted with
`transfer_in_request(handoff=True)` on an engine whose handoff hook is
armed (`set_handoff_hook`, `serving/disagg.py`'s HandoffCoordinator)
runs its prefill here and, in the wave that dispatches its final chunk,
is checkpointed, its prompt chain published to the store
(`publish_slot_chain`), its slot released and the checkpoint handed to
the hook, before any decode dispatch of that tick sees the slot; a
destination takes it through `transfer_in_checkpoint(handoff=True)` and
counts the revives of its replay as `handoff_revived_tokens`. The
constructor keeps the reference's signature. Several engines may share one card,
each with its own thread: their ticks share `_DEVICE_GATE` and a window
capture holds it alone, so a replica added under load captures while
no other engine launches.

Recovery on the card. The captured window replays over fixed buffers, so
recovery never reallocates a tensor the graph reads: `_reset_device_state`
zeroes the pool (and an int8 pool's scales) and the token vectors in
place, the TickState buffers stay, and the page table goes up again
through the dirty flag with the next packed sync. An injected fault
raises before its site does any work, so no capture, replay or copy is
ever cut in half, and the window needs no new capture after a recovery.
The model covers faults that leave the CUDA context usable: a real
`cudaError` that poisons the context (an illegal address, a device
assert) fails every later call on it, recovery itself raises, and the
engine falls back to failing every request; it cannot be recovered
in-process.

PyTorch in place of JAX: the programs write the pool in place on one CUDA
stream, whose ordering replaces JAX's donation chain. The reference jits
its K-step window (`_macro`); here, on CUDA, the constructor captures the
window once as a CUDA graph (`_WindowGraph`) over fixed device state (the
pool, the TickState buffers, the last-token and eos-carry vectors), and
every macro dispatch and every window of a burst replays it. It captures
the batch-1 prompt chunk too, one graph per prompt bucket and body (a mid
chunk; a final chunk with its head on the last row and its first token's
draw), over one packed input buffer that each chunk's single upload fills
(`_chunk_in`: start, length, slot, serial, step0 and the tokens) and the
tick state's table, in one memory pool. The multi-slot prefill wave runs
eagerly over its own lanes only (their table rows gathered on the device,
so it computes its chunks' rows and no others), and so do verify rounds and the spill tier's copies, which write
the pool in place: a verify round moves a drafting slot's `pos` on the
host, and the next packed sync carries it into the TickState buffers the
graph reads. On the CPU the same `_macro` and chunk bodies run eagerly.
Tensor parallelism (`mesh` with a `tp_axis` wider than 1,
docs/sharded-decode.md) keeps one controller: params are placed per shard by
`decode_param_rules`, the pool is partitioned on KV heads, and the programs
loop over the shards (`models/decode.py::TPLocal`) with exact gathers only.
Sampling runs once, on the gathered logits on the first shard's device,
where the token vectors, the tick state and the host uploads live, so every
counter is the same at any width.
Token vectors stay on the device; a `_TokRef` starts an asynchronous copy
into pinned host memory when it is created and materializes on first host
need, so neither admission nor steady decode blocks on a host round trip.
"""

from __future__ import annotations

import contextlib
import gc
import logging
import queue
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nos_tpu_torch import constants, prng
from nos_tpu_torch.device import resolve
from nos_tpu_torch.models.decode import (
    greedy,
    init_paged_cache,
    paged_decode_step,
    paged_prefill_chunk,
    paged_prefill_last,
    paged_prefill_window,
    paged_verify_window,
    place_tp,
)
from nos_tpu_torch.models.gpt import GPTConfig
from nos_tpu_torch.models.speculative import (
    SOURCE_HISTORY,
    SOURCE_TREE,
    AdaptiveSpec,
    _LookupIndex,
    accept_prefix,
)
from nos_tpu_torch.ops import _build, decode_attention, flash_attention, moe, paged_attention
from nos_tpu_torch.ops import quantized_kv as qkv
from nos_tpu_torch.parallel.mesh import canonical_device
from nos_tpu_torch.runtime.block_manager import BlockManager
from nos_tpu_torch.runtime.checkpoint import SlotCheckpoint
from nos_tpu_torch.runtime.faults import (
    FAULT_DEVICE_LOST,
    FAULT_POISON,
    FAULT_TRANSIENT,
    classify_fault,
    poison_slot_of,
)
from nos_tpu_torch.runtime.spill import SpillTier
from nos_tpu_torch.runtime.staging import HostStage, SyncLedger, TickState
from nos_tpu_torch.serving.kv_store import StoreTier
from nos_tpu_torch.tracing import (
    DISPATCH_BURST,
    DISPATCH_COW,
    DISPATCH_MACRO,
    DISPATCH_PREFILL_CHUNK,
    DISPATCH_PREFILL_LAST,
    DISPATCH_PREFILL_WINDOW,
    DISPATCH_REVIVE,
    DISPATCH_SCATTER,
    DISPATCH_VERIFY,
    TickProfiler,
)

logger = logging.getLogger(__name__)

class _TokRef:
    """One dispatched step's token vector (or a wave's first-token vector);
    materializes to numpy once, on first host need. A CUDA tensor is copied
    into pinned host memory asynchronously at construction, behind a
    recorded event that `is_ready` queries; `np()` waits on that event.
    The copy is ordered on the stream before any later write, so a CUDA
    graph's output buffer may be handed over and rewritten by the next
    replay. A CPU ref holds the tensor itself: the engine never writes a
    CPU tensor it has handed to a ref. Tensor-backed refs count into the
    engine's `blocking_syncs` ledger when they materialize, once: the fleet
    supervisor's probe thread reads refs too, so materializing takes the
    ref's lock. The wait is a `read_wait` span of the ledger's profiler."""

    __slots__ = ("_arr", "_event", "_np", "_ledger", "_lock")

    def __init__(self, arr: torch.Tensor, ledger: Optional[SyncLedger] = None):
        self._np = None
        self._event = None
        self._ledger = ledger
        # Another thread may read a ref too (the fleet supervisor's
        # checkpoint_snapshot): one materialization, counted once.
        self._lock = threading.Lock()
        if arr.device.type == "cuda":
            host = torch.empty(arr.shape, dtype=arr.dtype, pin_memory=True)
            host.copy_(arr, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
            arr = host
        self._arr = arr

    def np(self) -> np.ndarray:
        if self._np is None:
            with self._lock:
                if self._np is None:
                    if self._ledger is not None:
                        self._ledger.note()
                    # THE sanctioned materialization point: every tick-path
                    # host read funnels through here, deliberately deferred
                    # until the value is needed (or ready — see
                    # _resolve_verifies' pipelined reads): the wait on the
                    # copy's event, then the view of the pinned host copy.
                    if self._event is not None:
                        with (self._ledger.profiler.read_wait() if self._ledger is not None
                              else contextlib.nullcontext()):
                            self._event.synchronize()  # nos-lint: ignore[NOS010]
                    self._np = self._arr.numpy()  # nos-lint: ignore[NOS010]
                    self._arr = None
                    self._event = None
        return self._np

    def is_ready(self) -> bool:
        event = self._event  # read once: np() on another thread clears it
        return self._np is not None or event is None or event.query()


def _launch_counts() -> Dict[tuple, int]:
    """Every kernel wrapper's launch count, keyed (ops module, entry
    point, route); LAUNCHES[name] is the sum over its routes."""
    counts = {}
    for mod in (decode_attention, flash_attention, paged_attention, moe):
        for entry, routes in mod.ROUTE_LAUNCHES.items():
            for route, n in routes.items():
                counts[(mod, entry, route)] = n
    return counts


def _add_launches(delta: Dict[tuple, int]) -> None:
    for (mod, entry, route), n in delta.items():
        _build.count_launch(mod.LAUNCHES, mod.ROUTE_LAUNCHES, entry, route, n)


class _DeviceGate:
    """Engine ticks share it, a window capture holds it alone. Engines on
    one card (a replica set with a thread each) tick concurrently; a
    capture waits for the ticks in flight to end and holds new ones back
    until it is done (a waiting capture goes first). Reentrant per thread
    on the shared side. One gate serves the process (`_DEVICE_GATE`): what
    it protects, the capture's launch delta and the CUDA context a capture
    runs in, is the process's, not an engine's."""

    def __init__(self):
        self._cond = threading.Condition()
        self._shared = 0
        self._exclusive = False
        self._depth = threading.local()

    @contextlib.contextmanager
    def shared(self):
        depth = getattr(self._depth, "n", 0)
        if depth == 0:
            with self._cond:
                while self._exclusive:
                    self._cond.wait()
                self._shared += 1
        self._depth.n = depth + 1
        try:
            yield
        finally:
            self._depth.n = depth
            if depth == 0:
                with self._cond:
                    self._shared -= 1
                    if not self._shared:
                        self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        if getattr(self._depth, "n", 0):
            raise RuntimeError("a window capture inside an engine tick would deadlock")
        with self._cond:
            while self._exclusive:
                self._cond.wait()
            self._exclusive = True
            while self._shared:
                self._cond.wait()
        try:
            yield
        finally:
            with self._cond:
                self._exclusive = False
                self._cond.notify_all()


_DEVICE_GATE = _DeviceGate()

#: The batch-1 prompt chunk's scalar inputs ahead of its tokens in the
#: packed buffer: start, length, slot, serial, step0.
_CHUNK_META = 5


@contextlib.contextmanager
def _collector_off():
    """The cyclic collector run once, then off while the block lasts: a
    dead engine in a reference cycle still holds its own graphs, pools and
    pinned buffers, and freeing those inside a capture invalidates it
    (torch's capture no longer collects first). Inside an enclosing block
    (the collector already off) it does nothing, so an engine's captures
    share one collection."""
    if not gc.isenabled():
        yield
        return
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


class _WindowGraph:
    """One of the engine's window programs as a CUDA graph: the K-step
    decode window (the reference's `jax.jit` of `_macro`,
    decode_server.py:1067) and the batch-1 prompt chunk of each bucket and
    body (the window core at one lane, `_prefill_body`), on the H100.

    `body()` runs the program over the engine's fixed device state and
    returns its output buffer (the decode window's [K, n_slots] tokens; a
    prompt chunk's is None: it writes fixed buffers). At construction it
    runs once eagerly on the current stream, with every lane masked or
    every row past its length (the caller's state), which builds and loads
    the kernels, allocates the split decode kernels' counters and the kept
    constants (rope frequencies, sampler floats), and writes only the
    scratch page; then it is captured on a side stream in "thread_local"
    mode, so client threads may submit meanwhile. `pool` (a
    `torch.cuda.graph_pool_handle()`) shares one memory pool among graphs
    that never run at once and keep their outputs in buffers allocated
    before capture. A capture or replay failure raises.

    Before the capture the cyclic collector runs, and it stays off while
    the capture lasts (`_collector_off`).

    A kernel wrapper counts its launch when its Python runs, so the
    capture's counts are taken back and kept as the graph's `delta`, and
    each replay adds the delta: launch counts stay true under replay.

    Warm-up and capture hold `_DEVICE_GATE` alone: several engines may
    share the card (a replica set, one engine thread each), and a
    replica added under load captures while the others serve. Their
    ticks wait at the gate meanwhile, so no other thread launches,
    replays or reads back while this engine captures, and the delta
    holds this window's launches only."""

    def __init__(self, body, device: torch.device, pool=None):
        t0 = time.perf_counter()
        with _DEVICE_GATE.exclusive(), torch.cuda.device(device):
            #: Seconds this capture waited at the gate for other engines'
            #: ticks; `capture_s`: its warm-up and capture after that.
            self.gate_wait_s = time.perf_counter() - t0
            body()  # warm-up
            before = _launch_counts()
            self._graph = torch.cuda.CUDAGraph()
            # A side stream of this card (torch's shared capture stream
            # lives on whichever card first made it).
            side = torch.cuda.Stream(device)
            with _collector_off(), torch.cuda.graph(self._graph, pool=pool, stream=side,
                                                    capture_error_mode="thread_local"):
                self._out = body()
            after = _launch_counts()
        self.capture_s = time.perf_counter() - t0 - self.gate_wait_s
        self.delta = {k: n - before[k] for k, n in after.items() if n != before[k]}
        _add_launches({k: -n for k, n in self.delta.items()})

    def replay(self) -> Optional[torch.Tensor]:
        """Replay on the current stream; returns the graph's output buffer,
        which the next replay rewrites."""
        self._graph.replay()
        _add_launches(self.delta)
        return self._out


@dataclass
class _Request:
    """One queued/waiting request (decode_server.py:180). `replay` is
    non-empty only for checkpoint restores: tokens the request had already
    produced before a fault, replayed through prefill and prepended to the
    final result. A restore also carries the original sampling `serial`,
    the recovery timestamp (`t_restore`, feeding the restore-latency
    samples instead of TTFT) and the speculative controller's snapshot."""

    prompt: list
    max_new: int
    future: Future
    t_submit: float
    replay: List[int] = field(default_factory=list)
    serial: Optional[int] = None
    t_restore: float = 0.0
    spec: Optional[dict] = None
    # The quota tenant the request's tokens bill under (None: the default
    # best-effort tenant) and its trace id; both survive restores and
    # preemptions.
    tenant: Optional[str] = None
    trace_id: Optional[str] = None
    # Phase disaggregation (serving/disagg.py): `handoff_export`, this
    # engine is the request's prefill replica, and at prefill-complete the
    # slot is checkpointed, its prompt chain published to the shared store
    # and the checkpoint handed to the handoff hook instead of decoding
    # here; `handoff_ingest`, the request arrived by a handoff, so its
    # staged revives count as handoff traffic, not failover traffic.
    handoff_export: bool = False
    handoff_ingest: bool = False


@dataclass
class _Slot:
    active: bool = False
    # Budgeted-prefill state machine: "idle" -> (admission reserves slot,
    # serial, KV blocks and a prefill cursor) "reserved" -> (first chunk
    # dispatched) "prefilling" -> (final chunk dispatched, first token
    # sampled) "decoding". Only "decoding" slots join the macro mask.
    phase: str = "idle"
    # The full prompt until its final chunk dispatches; prefill_cursor is
    # the next prompt offset the budget scheduler will dispatch.
    pending_prompt: Optional[list] = None
    prefill_cursor: int = 0
    t_submit: float = 0.0  # monotonic clock at submit(), for TTFT/queue-wait
    pos: int = 0  # next cache write index (dispatched, not materialized)
    remaining: int = 0  # generated tokens still to dispatch
    # Token sources in generation order: (ref, lane, row) — row None = the
    # admission wave's first-token vector (indexed by lane); otherwise the
    # step's row of its macro window [K, n_slots] (or a verify round's
    # host-side accepted-token column [m, 1], lane 0).
    refs: List[Tuple[_TokRef, int, Optional[int]]] = field(default_factory=list)
    eos_scanned: int = 0
    future: Optional[Future] = None
    # The client's prompt (what a finished request registers its output
    # blocks under, and a checkpoint's identity with `max_new`), the
    # replayed tokens prepended to the result, the PRNG step offset they
    # occupy, and the recovery timestamp (0.0 = never restored).
    request_prompt: Optional[list] = None
    max_new: int = 0
    replay: List[int] = field(default_factory=list)
    step_base: int = 0
    t_restore: float = 0.0
    # Host-tier prefix blocks still to copy in, (token offset, block, chain
    # key) in prefix order, and the staged copy-on-write, (token offset,
    # destination block, pinned source block or None for a host source,
    # source chain key, tokens to copy): both consumed by the prefill pump
    # ahead of recompute chunks.
    pending_revives: List[Tuple[int, int, str]] = field(default_factory=list)
    pending_cow: Optional[Tuple[int, int, Optional[int], str, int]] = None
    # Speculation (spec_k > 0): the prompt, the host-side history (prompt +
    # generated, synced from refs) and its lookup index; `verifying` keeps
    # the slot out of every dispatch while its verify round is unresolved;
    # `adapt` is the per-source acceptance controller.
    prompt: Optional[list] = None
    history: Optional[list] = None
    lookup: Optional[_LookupIndex] = None
    verifying: bool = False
    adapt: Optional[AdaptiveSpec] = None
    # Fleet identity: the quota tenant, the trace id and whether the
    # slot's `req.decode` event was recorded (once, on its first decode
    # dispatch), and when its reservation began (the start of the
    # slot-seconds a cost ledger charges at release; 0.0 = no ledger).
    tenant: Optional[str] = None
    trace_id: Optional[str] = None
    trace_decoding: bool = False
    t_reserved: float = 0.0
    # Phase-disaggregation markers (see _Request).
    handoff_export: bool = False
    handoff_ingest: bool = False


@dataclass
class _PendingVerify:
    """One in-flight verify dispatch: the device-held argmax predictions
    [n_slots, spec_k + 1], each drafting slot's dispatched window, and the
    source that drafted it."""

    preds: _TokRef
    windows: Dict[int, list]
    sources: Dict[int, str]


#: Draft source -> its metric series (rounds, accepted tokens, demotions).
_DRAFT_SOURCE_METRICS = {
    SOURCE_TREE: (
        "nos_tpu_decode_draft_source_tree_rounds",
        "nos_tpu_decode_draft_source_tree_accepted",
        "nos_tpu_decode_draft_source_tree_demotions",
    ),
    SOURCE_HISTORY: (
        "nos_tpu_decode_draft_source_history_rounds",
        "nos_tpu_decode_draft_source_history_accepted",
        "nos_tpu_decode_draft_source_history_demotions",
    ),
}


class DecodeServer:
    def __init__(
        self,
        params,
        cfg: GPTConfig,
        n_slots: int = 4,
        max_len: int = 128,
        prompt_buckets: Sequence[int] = (8, 16, 32),
        eos_id: Optional[int] = None,
        temperature: float = 0.0,
        seed: int = 0,
        pipeline_depth: int = 16,
        steps_per_dispatch: int = 1,
        burst_windows: int = 4,
        block_size: int = 32,
        total_blocks: Optional[int] = None,
        spec_k: int = 0,
        spec_ngram: int = 3,
        spec_sync: bool = False,
        spec_tree_drafts: bool = True,
        prefill_budget_tokens: Optional[int] = None,
        prefix_cache: bool = True,
        radix_cache: bool = True,
        spill_blocks: Optional[int] = None,
        kv_store=None,
        quota=None,
        mesh=None,
        tp_axis: str = "tp",
        metrics=None,
        tracing=None,
        fault_injector=None,
        surgical_recovery: bool = True,
        max_transient_retries: int = 4,
        transient_backoff_s: float = 0.02,
        checkpoint_hook=None,
        cost_ledger=None,
        kv_dtype: str = constants.KV_DTYPE_NATIVE,
        device=None,
    ):
        """The reference's constructor (decode_server.py:325), restricted
        to the ported features; see the module docstring. `device` is
        where the engine runs: None means CUDA and raises when no CUDA
        device exists (the port never drifts to the CPU on its own);
        "cpu" runs the kernels' plain versions, as the tests do. With a
        tensor-parallel `mesh` (`nos_tpu_torch.parallel.build_mesh`) the
        engine runs on the devices of its `tp_axis`, and `device` may only
        name the first of them.

        `steps_per_dispatch` (K) runs K decode steps per macro dispatch;
        `burst_windows` (N) fuses up to N macro windows into one dispatch
        while every active slot decodes and nothing waits (`_burst_plan`;
        1 = every window its own tick); `prefill_budget_tokens` bounds the
        prompt tokens one tick may dispatch (None = the largest bucket, 0
        = unbudgeted); `prefix_cache` maps cached full prompt blocks into a
        new slot's page table instead of recomputing them; `radix_cache`
        (effective with `prefix_cache`) makes that index a radix tree:
        a prompt diverging mid-block from a cached path copies the shared
        head (copy-on-write) and a finished request registers its output
        blocks, so a follow-up turn is charged about its new suffix.
        `spill_blocks` sizes the host-RAM tier a cached block about to be
        evicted spills to, revived by a copy-in charged against the
        prefill budget (None: one pool's worth; 0: off). `spec_k` > 0
        drafts up to spec_k tokens per slot (the radix tree's stored
        continuation when `spec_tree_drafts`, else the slot's own
        prompt-lookup n-gram index of `spec_ngram`) and verifies them in
        one `paged_verify_window` over the drafting slots; greedy only.
        `spec_sync` syncs histories (blocking) before every draft probe.
        `surgical_recovery` (default True) selects the failure model of
        the module docstring (False: every outstanding request fails and
        the pool resets); `max_transient_retries` and
        `transient_backoff_s` (doubling, capped at 0.5 s) bound the
        transient retries; `fault_injector` (`runtime/faults.py`) threads
        a deterministic chaos schedule through the named sites, and
        `checkpoint_hook` (or `set_checkpoint_hook`) is called with
        `checkpoint_snapshot()` at every burst boundary and only reads it.
        Outputs are identical for any K, N, budget, prefix, radix, spill
        and speculation setting on the CPU, and a replayed window is
        identical to the eager one on the card. On CUDA in float32 those
        settings change which programs of which shapes compute a token
        (a decode step, a verify window, a prefill chunk or wave, a
        restore's replay), and two products round by shape there: the f32
        projections (cuBLAS picks its kernel by the row count, M = 8
        against 72 or 256: up to 5.3 f32 steps on an H100) and the
        attention (the split decode kernel against the window kernel's simt
        route: up to 20 steps; tests/test_torch_kernels.py::
        test_f32_rows_across_program_shapes). So a token may differ where
        the top two logits lie that close (chip_smoke.py's
        F32_CROSS_SHAPE_STEPS); bf16 is held to its oracle in any case.
        `kv_dtype="int8"` stores the pool as int8
        codes with one f32 scale per (block, layer, k|v): about half the
        pool's and every spill payload's bytes, its divergence from the
        native pool bounded by `runtime/divergence.py`. A `cfg` with
        experts, sliding layers or per-layer RoPE (`cfg.mixed`) is served
        on one device over the native pool: a tensor-parallel mesh or the
        int8 pool raises. Its expert layers count their work on the device
        (`expert_counts()`).

        `quota` (a `runtime/quota.py` QuotaPolicy) arms elastic tenant
        quotas over decode ticks, `tracing` (a `tracing.EngineTracing`)
        request spans, the flight recorder and the tick-phase profiler,
        `metrics` (an `observability.Metrics`, duck-typed: inc, set_gauge,
        observe) the engine's metric series, and `cost_ledger` (a
        `serving/accounting.py` CostLedger, duck-typed) per-tenant cost
        attribution; each observes or schedules on the host only, and
        with quotas off the engine's outputs and counters are the same
        with any of them armed or not. `kv_store` (a
        `serving/kv_store.py` FleetKVStore, shared by the replicas of a
        fleet) replaces the private spill tier with the fleet store: the
        same hits and revives, plus the write-through publish, prewarm
        and failover revives from other replicas' blocks.

        On CUDA the constructor captures the K-step window as a CUDA graph
        (`_WindowGraph`) that every window replays (`graph_replays`
        counts them), and the batch-1 prompt chunk as one graph per bucket
        and body (mid, final) that every such chunk replays
        (`prefill_graph_replays`; `prefill_eager_chunks` counts the chunks
        run eagerly). A mesh whose shards all lie on the engine's device
        is captured whole, every shard in one graph; a mesh over distinct
        cards (never run yet) runs its windows and chunks eagerly, as the
        CPU does."""
        if kv_dtype not in constants.KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of {constants.KV_DTYPES}: {kv_dtype!r}")
        if cfg.mixed and (kv_dtype == constants.KV_DTYPE_INT8
                          or (mesh is not None and int(mesh.shape.get(tp_axis, 1)) > 1)):
            raise ValueError("a config with experts, sliding windows or per-layer RoPE is "
                             "served on one device over the native pool: no tensor "
                             "parallelism, no int8 pool")
        # Tensor-parallel serving (decode_server.py:646-691): a mesh whose
        # tp axis is wider than 1 arms it; tp=1 (or no mesh) is the
        # single-device path, with no placement and no wrapping.
        tp_width = 1
        if mesh is not None:
            if tp_axis not in mesh.shape:
                raise ValueError(f"mesh has no '{tp_axis}' axis: {dict(mesh.shape)}")
            tp_width = int(mesh.shape[tp_axis])
        if tp_width > 1:
            if cfg.fuse_projections:
                raise ValueError(
                    "fuse_projections is incompatible with tensor-parallel "
                    "decode: concatenating column-sharded weights would "
                    "reshard mid-block"
                )
            if cfg.heads % tp_width or cfg.n_kv % tp_width or cfg.hidden % tp_width:
                raise ValueError(
                    f"tp={tp_width} must divide heads={cfg.heads}, "
                    f"kv_heads={cfg.n_kv}, and hidden={cfg.hidden}"
                )
            self._mesh = mesh
        else:
            self._mesh = None
        self._tp_axis = tp_axis
        #: Shards this engine computes over (1 = single device).
        self.tp = tp_width if self._mesh is not None else 1
        if self._mesh is not None:
            self.params, self._param_specs, self._tp = place_tp(params, cfg, mesh, tp_axis)
            self.device = self._tp.devices[0]
            if device is not None and canonical_device(device) != self.device:
                raise ValueError(
                    f"device {device} is not the mesh's first shard device {self.device}"
                )
        else:
            self.device = resolve(device, "DecodeServer")
            self._param_specs = None
            self._tp = None
            self.params = _params_to(params, self.device)
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        # Buckets are both admission padding sizes AND prefill chunk sizes;
        # prompts longer than the largest bucket prefill in chunks of it.
        self.prompt_buckets = sorted(b for b in prompt_buckets if b < max_len)
        if not self.prompt_buckets:
            raise ValueError(
                f"no prompt bucket smaller than max_len={max_len}: {prompt_buckets}"
            )
        self.eos_id = eos_id
        self.temperature = float(temperature)
        self._base_key = prng.PRNGKey(seed, device=self.device)
        self.pipeline_depth = max(
            1, pipeline_depth if eos_id is None else min(pipeline_depth, 2)
        )
        self.block_size = int(block_size)
        self.max_pages = -(-max_len // self.block_size)
        # +1: block 0 is the scratch page (inactive-lane writes, padding).
        self.total_blocks = (
            total_blocks if total_blocks is not None else 1 + n_slots * self.max_pages
        )
        if self.total_blocks < 2:
            raise ValueError("total_blocks must be >= 2 (scratch + 1)")
        self.kv_dtype = kv_dtype
        self._kv_quant = kv_dtype == constants.KV_DTYPE_INT8
        self.cache = self._new_pool()
        # Tracing (decode_server.py:752-759): the tracer and recorder hooks
        # are None-guarded; the profiler is a disabled instance when tracing
        # is off, so every tick phase, upload and read wait costs one flag
        # check.
        self.tracing = tracing
        self._tracer = tracing.tracer if tracing is not None else None
        self._recorder = tracing.recorder if tracing is not None else None
        self._prof = tracing.profiler if tracing is not None else TickProfiler(enabled=False)
        self._stage = HostStage(self.device, self._prof)
        self._syncs = SyncLedger(self._prof)
        self._tick_state = TickState(self._stage, n_slots, self.max_pages,
                                     mesh=self._mesh, tp_axis=tp_axis)
        self._table_np = np.zeros((n_slots, self.max_pages), dtype=np.int32)
        self.prefix_cache = bool(prefix_cache)
        self.radix_cache = bool(radix_cache) and self.prefix_cache
        # An int8 pool salts the chain keys with its payload dtype, so the
        # two formats never alias each other's blocks (decode_server.py:768).
        self._fault_injector = fault_injector
        self._checkpoint_hook = checkpoint_hook
        self.metrics = metrics
        self._block_mgr = BlockManager(self.total_blocks, self.block_size, n_slots,
                                       fault_injector=fault_injector, radix=self.radix_cache,
                                       key_salt=kv_dtype + ":" if self._kv_quant else "")
        if self._recorder is not None:
            self._block_mgr.attach_recorder(self._recorder)
        # The host-RAM spill tier (decode_server.py:775-812), attached with
        # this engine's copy-out: the engine owns the pool, the manager
        # decides when content moves.
        if spill_blocks is None:
            spill_blocks = self.total_blocks
        self.spill_tier: Optional[SpillTier] = None
        #: Bytes of one full-width spilled block (every layer's K and V;
        #: int8: one byte a code plus one f32 scale per layer and k|v, the
        #: nbytes of the payload `_extract_block` ships).
        elems = cfg.n_kv * self.block_size * cfg.head_dim
        if self._kv_quant:
            self._bytes_per_block = cfg.layers * 2 * (elems + 4)
        else:
            itemsize = torch.empty((), dtype=cfg.torch_dtype).element_size()
            self._bytes_per_block = cfg.layers * 2 * elems * itemsize
        if kv_store is not None:
            # The fleet KV store (decode_server.py:800-809): the host tier
            # becomes this engine's adapter over one content-addressed
            # store every replica shares, behind the same duck surface.
            self.spill_tier = StoreTier(kv_store)
        elif int(spill_blocks) > 0:
            self.spill_tier = SpillTier(int(spill_blocks) * self._bytes_per_block)
        if self.spill_tier is not None:
            # A weak reader: the manager must not keep the engine, and with
            # it the pool's device memory, alive in a reference cycle.
            reader = weakref.WeakMethod(self._extract_block)
            many = weakref.WeakMethod(self._extract_blocks)
            self._block_mgr.attach_spill(self.spill_tier, lambda block: reader()(block),
                                         lambda blocks: many()(blocks))
        # Shared-store state (decode_server.py:812-819), inert on a private
        # tier: chains queued for prewarm (`prewarm_from_store`, drained by
        # `_pump_prewarm` under the prefill budget), the write-through
        # publish's bound per busy tick, and the store counters.
        self._pending_prewarm: Deque[Tuple[str, List[str], List[Tuple[int, ...]]]] = deque()
        self._store_shared = bool(getattr(self.spill_tier, "is_shared", False))
        self._publish_per_tick = 2
        #: Prompt tokens copied in from the store by prewarm.
        self.prewarm_tokens = 0
        #: Blocks the write-through publish put into the store.
        self.store_published_blocks = 0
        # Phase disaggregation (decode_server.py:830-834): the prefill-
        # complete hook and the handoff counters.
        self._handoff_hook = None
        self.handoff_exports = 0
        self.handoff_ingests = 0
        self.handoff_published_blocks = 0
        self.handoff_revived_tokens = 0
        #: Tier payloads refused for a wire format this pool cannot take.
        self.kv_quant_payload_rejected = 0
        #: Prompt tokens a restore's replay took from the host tier.
        self.failover_revive_tokens = 0
        # Elastic tenant quotas (decode_server.py:835-840): `_tick_tokens`
        # gathers one tick's decode tokens per tenant for the policy's
        # window.
        self._quota = quota
        self._tick_tokens: Dict[str, int] = {}
        self.preemptions = 0
        # The cost ledger (decode_server.py:841-853) and its engine-side
        # conservation counters: slot-seconds accrue at the release site
        # the ledger is charged from, so tenant charges sum to the total.
        self._cost = cost_ledger
        self._chip_rate = float(self.tp) / float(max(1, n_slots))
        self.slot_seconds_total = 0.0
        self.kv_block_ticks = 0
        self.cost_receipts = 0
        # Monotonic counters owned by the tier, the manager and the policy,
        # mirrored into the metrics registry by delta each tick.
        self._metric_shadow: Dict[str, int] = {}
        self._waiting: Deque[_Request] = deque()
        self._queue: "queue.Queue" = queue.Queue()
        self._slots = [_Slot() for _ in range(n_slots)]
        # The step-feed vector (each lane's last token) and the burst's eos
        # carry: fixed buffers the window reads and writes in place.
        self._last_dev = torch.zeros((n_slots,), dtype=torch.int32, device=self.device)
        self._finished = torch.zeros((n_slots,), dtype=torch.bool, device=self.device)
        self._first_dev = torch.zeros((n_slots,), dtype=torch.int32, device=self.device)
        # The window's per-lane count of tokens it executed (the burst's
        # quota fold reads it), written in place by every window, and the
        # burst's [N, n_slots] copies of it, one row per fused window.
        self._win_counts = torch.zeros((n_slots,), dtype=torch.int32, device=self.device)
        self._burst_counts = torch.zeros((max(1, int(burst_windows)), n_slots),
                                         dtype=torch.int32, device=self.device)
        self._inflight: Deque[_TokRef] = deque()
        self._stop = threading.Event()
        # Set the moment the engine stops accepting work: a submit() after
        # it raises instead of stranding a Future.
        self._closed = threading.Event()
        # Every accepted request's Future (the drain loop's ground truth).
        self._accept_lock = threading.Lock()
        self._accepted: List[Future] = []
        self._thread: Optional[threading.Thread] = None
        self._engine_idle = False
        #: Dispatches of decode work: macro windows and bursts, one each.
        self.steps_run = 0
        self.macro_dispatches = 0
        self.burst_windows = max(1, int(burst_windows))
        self.burst_dispatches = 0
        #: Macro windows run inside bursts.
        self.burst_windows_run = 0
        #: Ticks that found the engine empty.
        self.idle_ticks = 0
        # Set by a quota-armed burst that already folded its windows into
        # the quota window, so the end of the tick does not fold again.
        self._quota_burst_folded = False
        #: Per-slot dispatch accounting: tokens from macro windows and
        #: bursts, and verify rounds.
        self.macro_tokens_by_slot = np.zeros((n_slots,), dtype=np.int64)
        self.spec_rounds_by_slot = np.zeros((n_slots,), dtype=np.int64)
        if prefill_budget_tokens is None:
            prefill_budget_tokens = self.prompt_buckets[-1]
        self.prefill_budget_tokens = max(0, int(prefill_budget_tokens))
        self._prefill_rr = 0
        self.prefill_dispatches = 0
        # Of those, the batched multi-slot window waves.
        self.prefill_window_dispatches = 0
        self.prefill_tokens = 0
        # Ticks that dispatched BOTH prefill work and a macro window.
        self.ticks_with_prefill_and_macro = 0
        # Per-request latency samples (seconds, monotonic clock):
        # queue-wait = submit -> slot reservation; TTFT = submit -> final
        # prefill chunk DISPATCHED (the first token exists on the stream).
        self.queue_wait_s: List[float] = []
        self.ttft_s: List[float] = []
        # Per-tenant samples and counters (key "" = untenanted), kept with
        # or without a quota (decode_server.py:943-956).
        self.ttft_s_by_tenant: Dict[str, List[float]] = {}
        self.queue_wait_s_by_tenant: Dict[str, List[float]] = {}
        self.admissions_by_tenant: Dict[str, int] = {}
        self.tokens_by_tenant: Dict[str, int] = {}
        # Per-slot sampling identity: (serial of the request in the slot,
        # step within the request), riding in the packed tick state. Serials
        # make streams independent of slot reuse order.
        self._slot_serial = np.zeros((n_slots,), dtype=np.int64)
        self._next_serial = 1
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        # The failure model (decode_server.py:957-971): recovery counters
        # and the restore-latency samples (fault detection -> the restored
        # slot's replayed final chunk dispatched).
        self.surgical_recovery = bool(surgical_recovery)
        self.max_transient_retries = int(max_transient_retries)
        self.transient_backoff_s = float(transient_backoff_s)
        self._transient_streak = 0
        self.recoveries = 0
        self.slots_restored = 0
        self.replay_tokens = 0
        self.requests_poisoned = 0
        self.transient_retries = 0
        self.fail_all_recoveries = 0
        self.restore_latency_s: List[float] = []
        # Speculation (decode_server.py:974-989, :887-923).
        self.spec_k = max(0, int(spec_k))
        self.spec_ngram = int(spec_ngram)
        self.spec_sync = bool(spec_sync)
        self.spec_tree_drafts = bool(spec_tree_drafts)
        if self.spec_k > 0 and self.temperature > 0.0:
            raise ValueError(
                "speculative decoding (spec_k > 0) is greedy-exact: "
                "temperature must be 0"
            )
        if self.spec_k > 0:
            # Drafts come from materialized tokens: a deep pipeline would
            # keep refs in flight and starve the lookup.
            self.pipeline_depth = min(self.pipeline_depth, 2)
        self._pending_verifies: Deque[_PendingVerify] = deque()
        #: Verify dispatches, tokens they accepted, and source demotions;
        #: by draft source too (tree + history rounds = verify windows
        #: drafted, tree + history accepted = spec_tokens_accepted).
        self.spec_rounds = 0
        self.spec_tokens_accepted = 0
        self.spec_demotions = 0
        self.spec_tree_rounds = 0
        self.spec_history_rounds = 0
        self.spec_tree_tokens_accepted = 0
        self.spec_history_tokens_accepted = 0
        self.spec_tree_demotions = 0
        self.spec_history_demotions = 0
        #: Ticks that dispatched both a verify round and a macro window.
        self.both_dispatch_ticks = 0
        #: The expert layers' device tallies (`ops/moe.py`), one row for the
        #: prefill programs (chunks, waves) and one for decode (windows,
        #: bursts, verify rounds): [rows routed, (layer, call) pairs summed
        #: over the experts that got a row]. Read by `expert_counts()`.
        self._expert_tally = torch.zeros((2, 2), dtype=torch.int64, device=self.device)
        #: CUDA graphs of the decode window captured, and windows run as a
        #: graph replay.
        self.graph_captures = 0
        self.graph_replays = 0
        self._graph: Optional[_WindowGraph] = None
        # The batch-1 prompt chunk's fixed inputs, [start, length, slot,
        # serial, step0] then the tokens (filled by one packed upload a
        # chunk), and a final chunk's sampled first token: every bucket's
        # program reads and writes these, replayed or eager.
        self._chunk_in = torch.zeros((_CHUNK_META + self.prompt_buckets[-1],),
                                     dtype=torch.int32, device=self.device)
        self._chunk_tok = torch.zeros((1,), dtype=torch.int32, device=self.device)
        #: Batch-1 prompt chunks run as a replay of their bucket's graph, and
        #: run eagerly (the CPU, a mesh over distinct cards).
        self.prefill_graph_replays = 0
        self.prefill_eager_chunks = 0
        self._prefill_graphs: Dict[Tuple[int, bool], _WindowGraph] = {}
        shard_devices = (self._tp.devices if self._tp is not None else [self.device])
        if self.device.type == "cuda" and all(
                canonical_device(d) == canonical_device(self.device) for d in shard_devices):
            with _collector_off():
                self._graph = _WindowGraph(self._macro, self.device)
                self.graph_captures += 1
                # One pool for the chunk graphs: they never run at once,
                # and their outputs live in the buffers above.
                pool = torch.cuda.graph_pool_handle()
                for bucket in self.prompt_buckets:
                    for final in (False, True):
                        self._prefill_graphs[bucket, final] = _WindowGraph(
                            self._prefill_body(bucket, final), self.device, pool)

    # -- the programs ----------------------------------------------------------
    def _new_pool(self):
        """The paged pool: one device, or partitioned on KV heads across the
        mesh's shards."""
        return init_paged_cache(self.cfg, self.total_blocks, self.block_size,
                                kv_dtype=self.kv_dtype, device=self.device, mesh=self._mesh,
                                tp_axis=self._tp_axis)

    def _pools(self) -> list:
        """The pool's per-layer dicts, one per shard in shard order."""
        return self.cache if self._tp is not None else [self.cache]

    # -- the spill tier's and the radix tree's copies (decode_server.py:1210-1299)
    # Plain PyTorch on the engine's stream: they write the pool's tensors
    # (and an int8 pool's scales) in place and never rebind them (the
    # captured window holds their addresses). A block's tensors are its K
    # and V over every layer at full width, [layers, n_kv, block_size,
    # head_dim] each, and for an int8 pool its K and V scales [layers]:
    # under a mesh the copy-out gathers the shards' KV-head slices (and
    # takes the scales once: the shards' copies are equal) and the copy-in
    # slices them back, so a payload is the same bytes at any tp.
    def _gather_blocks(self, blocks: List[int]) -> tuple:
        """Blocks' full-width tensors on the engine's device, the block axis
        second: (k, v) [L, n, nkv, bs, hd], or for an int8 pool (k, v,
        k_scale, v_scale) through the funnel module, the scales [L, n]. The
        one definition of the payload layout: the shards' KV heads side by
        side, their equal scales taken once."""
        L = self.cfg.layers
        # One block is a slice (no index upload); several, one gather.
        idx = (slice(blocks[0], blocks[0] + 1) if len(blocks) == 1
               else torch.tensor(blocks, dtype=torch.long))
        parts = []
        for pool in self._pools():
            at = idx if isinstance(idx, slice) else idx.to(pool["0"]["k"].device)
            parts.append(qkv.extract_block(pool, at, L) if self._kv_quant else tuple(
                torch.stack([pool[str(i)][name][at] for i in range(L)]) for name in ("k", "v")))
        if len(parts) == 1:
            return parts[0]
        codes = tuple(torch.cat([p[j].to(self.device) for p in parts], dim=2)
                      for j in range(2))
        return codes + parts[0][2:]

    def _revive(self, tensors: tuple, block: int) -> None:
        """Copy a block's full-width tensors (as `_gather_blocks` returns
        one block's, the block axis dropped) into `block`."""
        pools = self._pools()
        k, v = tensors[:2]
        width = k.shape[1] // len(pools)
        for s, pool in enumerate(pools):
            dev = pool["0"]["k"].device
            ks = k[:, s * width:(s + 1) * width].to(dev)
            vs = v[:, s * width:(s + 1) * width].to(dev)
            if self._kv_quant:
                qkv.revive_block(pool, ks, vs, tensors[2].to(dev), tensors[3].to(dev), block)
                continue
            for i in range(self.cfg.layers):
                pool[str(i)]["k"][block].copy_(ks[i])
                pool[str(i)]["v"][block].copy_(vs[i])

    def _cow_copy(self, src: int, dst: int, length: int) -> None:
        """The first `length` rows of block `src` into block `dst`, every
        layer, each shard its own head slices. `src` is only read. The
        native copy keeps `dst`'s tail; the int8 copy zeroes it and takes
        the source's scales (`quantized_kv.cow_copy_block`)."""
        for pool in self._pools():
            if self._kv_quant:
                qkv.cow_copy_block(pool, src, dst, length)
                continue
            for layer in pool.values():
                for t in (layer["k"], layer["v"]):
                    t[dst, :, :length].copy_(t[src, :, :length])

    def _extract_block(self, block: int):
        """The spill tier's reader: one block's payload copied to host
        memory, (payload, nbytes). One counted blocking read per block: it
        waits behind everything queued on the stream that may still write
        the block. Spilling is the slow path by definition (allocation
        pressure), and the bytes moved are the point. A native payload is
        (k, v); an int8 payload is the tagged ("int8", k, v, k_scale,
        v_scale), its nbytes with the scales (decode_server.py:1306-1329)."""
        return self._read_blocks([block])[0]

    def _extract_blocks(self, blocks: List[int]) -> list:
        """Several blocks' payloads, each as `_extract_block` gives it, for
        the publish paths (a handoff's prompt chain, the idle sweep). On
        the card in one pass: the blocks gathered on the device and read
        back together, one counted blocking read instead of one a block
        (a 32k-token chain is 1024 blocks). A pool on the CPU reads them
        one by one, as the reference counts its copy-outs."""
        if self.device.type != "cuda":
            return [self._extract_block(b) for b in blocks]
        return self._read_blocks(blocks)

    def _read_blocks(self, blocks: List[int]) -> list:
        """Blocks' payloads and nbytes through one counted blocking read."""
        tensors = self._gather_blocks(blocks)
        self._syncs.note()
        host = [t.cpu() for t in tensors]
        out = []
        for n in range(len(blocks)):
            block = tuple(t[:, n].contiguous() for t in host)
            nbytes = sum(t.numel() * t.element_size() for t in block)
            out.append(((constants.KV_DTYPE_INT8,) + block if self._kv_quant else block,
                        nbytes))
        return out

    def _payload_matches(self, payload) -> bool:
        """Whether a tier payload's wire format is this pool's: a native
        engine takes (k, v) pairs, an int8 engine ("int8", k, v, k_scale,
        v_scale); the other format is refused and recomputed instead."""
        if not isinstance(payload, (tuple, list)):
            return False
        if self._kv_quant:
            return len(payload) == 5 and payload[0] == constants.KV_DTYPE_INT8
        return len(payload) == 2 and not isinstance(payload[0], str)

    def _dispatch_revive(self, payload, block: int) -> bool:
        """Copy one tier payload into device `block`: one counted upload a
        tensor (two native, four int8), then the in-place copy-in. False
        (counted) for a payload of another wire format; the caller
        recomputes the range."""
        if not self._payload_matches(payload):
            self.kv_quant_payload_rejected += 1
            if self.metrics is not None:
                self.metrics.inc("nos_tpu_decode_kv_quant_payload_rejected")
            return False
        tensors = payload[1:] if self._kv_quant else payload
        with self._prof.dispatch(DISPATCH_REVIVE):
            self._revive(tuple(self._stage.to_device(t) for t in tensors), block)
        return True

    def _table(self):
        """The tick state's block table as the programs take it: one tensor,
        or one per shard."""
        st = self._tick_state
        return st.table if self._tp is None else st.tables

    def _sample(self, logits, serial, step) -> torch.Tensor:
        """Greedy at temperature 0, else lane i samples
        categorical(fold_in(fold_in(PRNGKey(seed), serial[i]), step[i]),
        logits[i] / T) (decode_server.py:1014-1024). int32 [N]."""
        if self.temperature <= 0.0:
            return greedy(logits)
        keys = prng.fold_in(prng.fold_in(self._base_key, serial), step)
        return prng.categorical(keys, logits / self.temperature).to(torch.int32)

    def _macro(self) -> torch.Tensor:
        """K ragged decode steps (decode_server.py:1067) over the engine's
        fixed state, written in place: the body `_WindowGraph` captures,
        and the window itself on the CPU. Per step k a lane takes part iff
        it is active, still owes tokens (k < steps_left), stays inside the
        cache window and, with an eos_id, has not sampled its eos earlier
        in this dispatch (`_finished`, the burst's carry, zeroed by each
        dispatch); other lanes coast (their writes go to the scratch page,
        token held). Returns the [K, n_slots] token window; `_last_dev`
        takes the last tokens, `_win_counts` each lane's count of steps
        taken (the burst program's per-window counts,
        decode_server.py:3918), and the TickState's pos / step /
        steps_left advance by the same min(K, steps_left, max_len - pos)
        the host bookkeeping mirrors."""
        st = self._tick_state
        K = self.steps_per_dispatch
        token = self._last_dev
        table = self._table()
        toks = []
        counts = torch.zeros_like(self._win_counts)
        for k in range(K):
            pos_k = st.pos + k
            mask = st.mask & (k < st.steps_left) & (pos_k < self.max_len)
            if self.eos_id is not None:
                mask = mask & ~self._finished
            logits, _ = paged_decode_step(
                self.params, token, self.cfg, self.cache, table, pos_k, mask,
                self.block_size, tp=self._tp, moe_tally=self._expert_tally[1],
            )
            nxt = self._sample(logits, st.serial, st.step + k)
            token = torch.where(mask, nxt, token)
            toks.append(torch.where(mask, nxt, 0))
            counts += mask.to(counts.dtype)
            if self.eos_id is not None:
                self._finished |= mask & (nxt == self.eos_id)
        execd = torch.where(
            st.mask,
            torch.clamp(torch.minimum(st.steps_left, self.max_len - st.pos), 0, K),
            0,
        ).to(st.pos.dtype)
        self._last_dev.copy_(token)
        self._win_counts.copy_(counts)
        st.pos.add_(execd)
        st.step.add_(execd)
        st.steps_left.sub_(execd)
        return torch.stack(toks)

    def _window(self) -> torch.Tensor:
        """Run one K-step window: a replay of the captured graph where there
        is one, else `_macro` eagerly. Returns its [K, n_slots] tokens."""
        if self._graph is None:
            return self._macro()
        out = self._graph.replay()
        self.graph_replays += 1
        return out

    def _prefill_body(self, bucket: int, final: bool):
        """The batch-1 prompt chunk at `bucket` over fixed device state, the
        program a graph captures (`_prefill_graphs`) and the CPU runs: its
        inputs from `_chunk_in` (positions, pages and the window's pos and
        length derive from start and length on the device), the page-table
        row read from the tick state's table at the slot's index. A mid
        chunk only writes the pool; a final chunk also samples its first
        token, at the slot's serial and step0, from its last row's logits
        (`paged_prefill_last`) into `_chunk_tok`. The engine keeps no body
        (it would tie the engine into a reference cycle), only its graph."""
        meta, tables = self._chunk_in, self._table()
        start, length, slot, serial, step0 = (meta[i:i + 1] for i in range(_CHUNK_META))
        tokens = meta[_CHUNK_META:_CHUNK_META + bucket][None, :]  # [1, C]

        def body():
            if self._tp is None:
                row = tables.index_select(0, slot)[0]
            else:
                row = [t.index_select(0, slot.to(t.device))[0] for t in tables]
            if not final:
                paged_prefill_chunk(self.params, tokens, self.cfg, self.cache, row, start,
                                    length, self.block_size, with_logits=False, tp=self._tp,
                                    moe_tally=self._expert_tally[0])
                return None
            logits, _ = paged_prefill_last(self.params, tokens, self.cfg, self.cache, row,
                                           start, length, self.block_size, tp=self._tp,
                                           moe_tally=self._expert_tally[0])
            self._chunk_tok.copy_(self._sample(logits, serial, step0))
            return None

        return body

    def _chunk_inputs(self, bucket: int, idx: int, start: int, piece: Sequence[int],
                      step0: int = 0) -> np.ndarray:
        """A batch-1 chunk's inputs packed for its one upload (host work):
        [start, length, slot, serial, step0], then `piece` zero-padded to
        `bucket`, int32. `step0` is 0 for a fresh request; a restore passes
        its replayed-token count, so a sampled stream continues its PRNG
        draws where the fault interrupted it."""
        inputs = np.zeros((_CHUNK_META + bucket,), dtype=np.int32)
        inputs[:_CHUNK_META] = (start, len(piece), idx, self._slot_serial[idx], step0)
        inputs[_CHUNK_META:_CHUNK_META + len(piece)] = piece
        return inputs

    def _prefill_chunk(self, inputs: np.ndarray, final: bool) -> None:
        """One batch-1 prompt chunk from its packed `inputs`: ONE counted
        upload into `_chunk_in`, then a replay of its bucket's graph, or
        its body eagerly where none was captured. A final chunk's first
        token then goes to the step-feed vector and to this wave's
        first-token vector (cloned per wave by the caller: earlier waves'
        refs still hold the previous one, so no graph holds it)."""
        key = (len(inputs) - _CHUNK_META, final)
        self._stage.upload(self._chunk_in, inputs)
        graph = self._prefill_graphs.get(key)
        if graph is not None:
            graph.replay()
            self.prefill_graph_replays += 1
        else:
            self._prefill_body(*key)()
            self.prefill_eager_chunks += 1
        if final:
            slot = int(inputs[2])
            self._last_dev[slot:slot + 1].copy_(self._chunk_tok)
            self._first_dev[slot:slot + 1].copy_(self._chunk_tok)

    def _prefill_window(self, tokens, table, pos, lengths, active) -> None:
        paged_prefill_window(
            self.params, tokens, self.cfg, self.cache, table, pos, lengths, active,
            self.block_size, tp=self._tp, moe_tally=self._expert_tally[0],
        )

    # -- client side -----------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new: int = 16, tenant: Optional[str] = None,
               trace_id: Optional[str] = None) -> Future:
        """Queue one request; thread-safe (decode_server.py:1415): a call
        to `transfer_in_request` with a fresh Future. `tenant` names the
        quota account its decode tokens bill under (only a QuotaPolicy acts
        on it); a tenant whose TenantShare pins another `kv_dtype` than
        this pool's is refused. `trace_id` continues a trace opened
        elsewhere (the router's); with a tracer armed and none given, the
        engine mints one. Raises RuntimeError once the engine has stopped
        (or begun draining)."""
        return self.transfer_in_request(prompt, max_new, tenant=tenant, trace_id=trace_id)

    def transfer_in_request(self, prompt: Sequence[int], max_new: int = 16,
                            tenant: Optional[str] = None, future: Optional[Future] = None,
                            t_submit: Optional[float] = None, trace_id: Optional[str] = None,
                            handoff: bool = False) -> Future:
        """The request ingress (decode_server.py:1433): `submit`, plus the
        form the drain controller (`serving/drain.py`) uses to move a
        waiting request to another replica with its ORIGINAL client Future
        and submit time, so the client never sees the move. Thread-safe:
        the queue is the cross-thread boundary. `handoff=True` marks the
        request for phase-disaggregated export (serving/disagg.py): this
        engine runs its prefill only, and at the final chunk the slot is
        checkpointed, its prompt chain published to the shared store and
        the checkpoint handed to the armed handoff hook for decode
        elsewhere. Without an armed hook the marker is inert and the
        request decodes here."""
        if self._closed.is_set():
            raise RuntimeError(
                "DecodeServer is stopped (or draining): submit() after stop() "
                "would strand the request; route it elsewhere"
            )
        if self._quota is not None and tenant:
            pin = getattr(self._quota.share_of(tenant), "kv_dtype", None)
            if pin is not None and pin != self.kv_dtype:
                raise ValueError(
                    f"tenant {tenant!r} is pinned to kv_dtype={pin!r} but this "
                    f"engine's pool is {self.kv_dtype!r}: route the request to a "
                    "matching replica"
                )
        fut: Future = future if future is not None else Future()
        if max_new <= 0:
            fut.set_result([])
            return fut
        if self._tracer is not None:
            if trace_id is None:
                trace_id = self._tracer.new_trace()
            self._tracer.event(trace_id, constants.TRACE_EV_SUBMIT,
                               prompt_tokens=len(prompt), max_new=max_new)
        self._note_accepted(fut)
        self._queue.put(_Request(list(prompt), max_new, fut,
                                 t_submit if t_submit is not None else time.monotonic(),
                                 tenant=tenant, trace_id=trace_id, handoff_export=handoff))
        return fut

    def transfer_in_checkpoint(self, ck: SlotCheckpoint, t_restore: Optional[float] = None,
                               handoff: bool = False) -> None:
        """Accept a SlotCheckpoint taken on ANOTHER replica (drain, migrate,
        failover; decode_server.py:1504): queued as a restore, its replay
        the tokens generated at the source, its sampling serial kept and
        its PRNG step offset by the replay, so a temperature stream goes on
        bit for bit on an engine with the source's params, config and
        seed. The checkpoint's Future resolves here. `handoff=True` marks a
        phase-disaggregation arrival (the decode half of serving/disagg.py's
        handoff): the replay's staged store revives count as
        `handoff_revived_tokens`, the witness that the prefill replica's KV
        was shipped through the fleet store rather than recomputed here,
        instead of as failover traffic."""
        if self._closed.is_set():
            raise RuntimeError(
                "DecodeServer is stopped (or draining): cannot accept a "
                "migrated checkpoint; route it elsewhere"
            )
        if ck.future is not None and ck.future.done():
            return  # resolved at capture (eos or budget): nothing to replay
        if ck.future is not None:
            self._note_accepted(ck.future)
        if handoff:
            self.handoff_ingests += 1
            if self.metrics is not None:
                self.metrics.inc("nos_tpu_fleet_handoff_ingests")
        self._queue.put(_Request(
            prompt=list(ck.prompt), max_new=ck.max_new,
            future=ck.future if ck.future is not None else Future(),
            t_submit=ck.t_submit, replay=list(ck.generated), serial=ck.serial,
            t_restore=t_restore if t_restore is not None else time.monotonic(),
            spec=dict(ck.spec) if ck.spec is not None else None, tenant=ck.tenant,
            trace_id=ck.trace_id, handoff_ingest=handoff))

    def generate(self, prompt: Sequence[int], max_new: int = 16, timeout=None):
        return self.submit(prompt, max_new).result(timeout=timeout)

    def checkpoint_snapshot(self) -> List[SlotCheckpoint]:
        """A passive checkpoint of every active, unresolved slot
        (decode_server.py:1760): never blocks and never resolves a future.
        Only refs already materializable are read (the first unready one
        ends the run), and the capture stops strictly before an eos or the
        budget's last token, so a restore always replays and regenerates
        the end itself. Any prefix of a stream is a valid checkpoint. The
        checkpoints alias the live client futures."""
        out: List[SlotCheckpoint] = []
        for idx, slot in enumerate(self._slots):
            if not slot.active or slot.future is None or slot.future.done():
                continue
            if slot.request_prompt is None:
                continue
            tokens: List[int] = list(slot.replay)
            for ref, lane, row in slot.refs:
                if not ref.is_ready():
                    break
                tokens.append(self._token_at(ref, lane, row))
            if self.eos_id is not None and self.eos_id in tokens:
                tokens = tokens[: tokens.index(self.eos_id)]
            tokens = tokens[: max(0, slot.max_new - 1)]
            spec = slot.adapt.snapshot(len(tokens)) if slot.adapt is not None else None
            out.append(SlotCheckpoint(
                prompt=list(slot.request_prompt), generated=tokens, max_new=slot.max_new,
                serial=int(self._slot_serial[idx]), t_submit=slot.t_submit,
                prefill_cursor=slot.prefill_cursor, spec=spec, tenant=slot.tenant,
                trace_id=slot.trace_id, future=slot.future))
        return out

    def tenant_probe(self) -> Dict[str, Dict[str, object]]:
        """Per-tenant host-side probe (decode_server.py:1652): cumulative
        decode tokens and admissions, requests waiting now, and with a
        QuotaPolicy the policy's own windowed share (usage, min share,
        starved, borrower). Plain host reads, no locks, no device
        traffic."""
        waiting: Dict[str, int] = {}
        for req in (*list(self._waiting), *list(self._queue.queue)):
            tname = getattr(req, "tenant", None) or ""
            waiting[tname] = waiting.get(tname, 0) + 1
        tenants = set(self.tokens_by_tenant) | set(self.admissions_by_tenant) | set(waiting)
        for slot in self._slots:
            if slot.active:
                tenants.add(slot.tenant or "")
        if self._quota is not None:
            tenants |= set(self._quota.tenants)
        rows: Dict[str, Dict[str, object]] = {}
        for tname in tenants:
            row: Dict[str, object] = {
                constants.TENANT_KEY_TOKENS: self.tokens_by_tenant.get(tname, 0),
                constants.TENANT_KEY_ADMISSIONS: self.admissions_by_tenant.get(tname, 0),
                constants.TENANT_KEY_WAITING: waiting.get(tname, 0),
            }
            if self._quota is not None:
                row[constants.TENANT_KEY_USAGE] = self._quota.usage(tname)
                row[constants.TENANT_KEY_MIN_SHARE] = self._quota.share_of(tname).min_share
                row[constants.TENANT_KEY_QUOTA_STARVED] = self._quota.is_starved(tname)
                row[constants.TENANT_KEY_QUOTA_BORROWER] = self._quota.is_borrower(tname)
            rows[tname] = row
        return rows

    def set_checkpoint_hook(self, hook) -> None:
        """Arm (or, with None, disarm) the burst-boundary checkpoint hook
        after construction; the hook only reads the checkpoints."""
        self._checkpoint_hook = hook

    def set_handoff_hook(self, hook) -> None:
        """Arm (or, with None, disarm) the prefill-complete handoff hook
        (decode_server.py:1825, serving/disagg.py). The hook runs on the
        engine's thread with one argument, the freshly captured
        SlotCheckpoint, its prompt chain already published to the shared
        store and its slot already released, and owns the checkpoint from
        then on: this engine has dropped the future from its accepted set,
        so the hook must place the checkpoint or resolve its future. A
        raising hook is contained: the export is done, the engine logs and
        keeps ticking."""
        self._handoff_hook = hook

    # -- the serving plane's hooks (decode_server.py:1623-1890) ------------------
    # Each may run on another thread than the engine's: `probe`,
    # `tenant_probe` and `prefix_keys` on the router's, `checkpoint_snapshot`
    # on the supervisor's probe thread, `prewarm_from_store` on the control
    # thread (ReplicaSet.add, before the engine's thread starts). They read
    # host state only and launch nothing. `drain_extract` and `forsake` join
    # the engine's thread before they touch its state.
    def probe(self) -> Dict[str, object]:
        """The router's load probe (decode_server.py:1623): active slots,
        queued requests and the prompt tokens reserved slots still owe the
        prefill budget, plus the capacity the fleet accounts. Plain host
        reads, no device traffic, no locks: a read racing the engine's
        thread shades a routing score, never an output."""
        active = 0
        backlog = 0
        for slot in self._slots:
            if not slot.active:
                continue
            active += 1
            pending = slot.pending_prompt
            if pending is not None:
                backlog += max(0, len(pending) - slot.prefill_cursor)
        return {
            constants.PROBE_KEY_ACTIVE_SLOTS: active,
            constants.PROBE_KEY_QUEUED_REQUESTS: self._queue.qsize() + len(self._waiting),
            constants.PROBE_KEY_PREFILL_BACKLOG: backlog,
            constants.PROBE_KEY_DRAINING: self._closed.is_set(),
            constants.PROBE_KEY_TP_DEVICES: self.tp,
            constants.PROBE_KEY_SLOTS_TOTAL: self.n_slots,
            # total - 1: the scratch block is never allocatable.
            constants.PROBE_KEY_KV_BLOCKS_TOTAL: self._block_mgr.total_blocks - 1,
        }

    def drain_extract(self) -> Tuple[List[SlotCheckpoint], List[_Request]]:
        """The drain half of the move protocol (decode_server.py:1705):
        close admission, stop the loop, and hand back what this replica
        owes: a checkpoint of every admitted slot (the capture recovery and
        preemption take) and every restore already waiting, in serial
        order, and the requests not yet admitted, FIFO, with their client
        Futures. The pool is released and its conservation checked; the
        engine is left stopped and empty."""
        self._closed.set()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self._drain_queue()
        checkpoints: List[SlotCheckpoint] = []
        for idx, slot in enumerate(self._slots):
            if not slot.active:
                continue
            ck = self._checkpoint_slot(idx)
            self._release_slot(idx)
            if ck is not None:
                checkpoints.append(ck)
        pending: List[_Request] = []
        while self._waiting:
            req = self._waiting.popleft()
            if req.serial is not None:
                # Already restore-shaped: re-wrap it as a checkpoint.
                checkpoints.append(SlotCheckpoint(
                    prompt=list(req.prompt), generated=list(req.replay), max_new=req.max_new,
                    serial=req.serial, t_submit=req.t_submit, spec=req.spec,
                    tenant=req.tenant, trace_id=req.trace_id, future=req.future))
            else:
                pending.append(req)
        self._inflight.clear()
        self._pending_verifies.clear()
        checkpoints.sort(key=lambda ck: ck.serial)
        if not self._block_mgr.conserved():
            raise RuntimeError("pool conservation violated during drain")
        return checkpoints, pending

    def forsake(self) -> List[Future]:
        """Disown every outstanding Future WITHOUT resolving it
        (decode_server.py:1838): the fleet supervisor has taken this
        replica's streams over (re-homed or failed each), so the `stop()`
        that retires it must not fail them a second time. Closes
        admission, stops the loop thread, clears every queue, slot future
        and accepted reference, and returns the disowned futures."""
        self._closed.set()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        disowned: List[Future] = []
        for slot in self._slots:
            if slot.future is not None and not slot.future.done():
                disowned.append(slot.future)
            slot.future = None
        while self._waiting:
            req = self._waiting.popleft()
            if not req.future.done():
                disowned.append(req.future)
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if not req.future.done():
                disowned.append(req.future)
        self._inflight.clear()
        self._pending_verifies.clear()
        with self._accept_lock:
            self._accepted = []
        return disowned

    def reopen(self) -> None:
        """Undo the admission close after an extraction whose re-homing
        failed (the drain's rollback; decode_server.py:1875):
        `drain_extract` left the engine stopped, empty and conserved, so
        clearing the stop and closed latches makes it a valid cold
        destination again. Only on an engine whose loop thread has
        exited."""
        if self._thread is not None:
            raise RuntimeError("reopen() on an engine whose loop thread is still attached")
        self._stop.clear()
        self._closed.clear()

    def prewarm(self) -> "DecodeServer":
        """Run every prefill program once per prompt bucket, the mid chunk,
        the final chunk and the multi-slot window, before traffic arrives
        (decode_server.py:1378): the reference compiles them; here the
        kernels are built and loaded and the programs' buffers allocated.
        Where the batch-1 chunks are graphs, their captures' warm-ups ran
        them already, and only the windows run here. Every write goes to
        the scratch page (a chunk of length 0, a window over an all-zero
        page table), and the final chunk's first-token scatter to lane 0,
        so it runs before serving only."""
        if any(s.active for s in self._slots):
            raise RuntimeError("prewarm() runs before serving: a slot is active")
        self._sync_tick_state(for_table_only=True)
        table = self._table()
        # All-zero page tables: a released slot's row may still name cached
        # blocks, which the scratch writes must not touch.
        zeros = (torch.zeros_like(table) if self._tp is None
                 else [torch.zeros_like(t) for t in table])
        with _DEVICE_GATE.shared():
            self._first_dev = self._first_dev.clone()
            for bucket in self.prompt_buckets:
                if not self._prefill_graphs:
                    for final in (False, True):
                        self._prefill_chunk(self._chunk_inputs(bucket, 0, 0, []), final)
                lanes = np.zeros((self.n_slots,), dtype=np.int32)
                self._prefill_window(
                    self._stage.to_device(np.zeros((self.n_slots, bucket), dtype=np.int32)),
                    zeros, self._stage.to_device(lanes), self._stage.to_device(lanes),
                    self._stage.to_device(np.zeros((self.n_slots,), dtype=bool)))
        return self

    def prewarm_from_store(self, keys: Optional[Sequence[str]] = None,
                           max_blocks: Optional[int] = None) -> int:
        """Queue fleet-store blocks to prewarm into this engine's device
        cache (decode_server.py:2521): a freshly created or
        drain-destination replica pulls the store's hot subtree into its
        radix cache, so its first traffic hits instead of recomputing.
        `keys` defaults to the store's MRU-first, ancestor-closed hot set;
        each key's root chain is rebuilt from store metadata (a chain the
        store broke by retirement is skipped). Planned keys are
        stage-pinned at once and drained by `_pump_prewarm` under the
        prefill budget live admissions use, admissions first. Returns the
        number of blocks queued (0 without a shared store). Host-only: the
        store takes its lock, the deque takes atomic appends, and only the
        engine's thread consumes the queue and touches the pool."""
        tier = self.spill_tier
        if tier is None or not self._store_shared:
            return 0
        store = tier.store
        if keys is None:
            keys = store.hot_keys()
        planned = {entry[0] for entry in self._pending_prewarm}
        plan: List[Tuple[str, List[str], List[Tuple[int, ...]]]] = []
        for key in keys:
            chain: List[Tuple[str, Tuple[int, ...]]] = []
            node, broken = key, False
            while node:
                meta = store.meta(node)
                if meta is None:
                    broken = True
                    break
                chain.append((node, meta[1]))
                node = meta[0]
            if broken:
                continue
            chain.reverse()
            chain_keys = [k for k, _ in chain]
            chain_tokens = [t for _, t in chain]
            for i, (k, _) in enumerate(chain):
                if k in planned or self._block_mgr.device_resident(k):
                    continue
                planned.add(k)
                plan.append((k, chain_keys[: i + 1], chain_tokens[: i + 1]))
        if max_blocks is not None:
            plan = plan[:max_blocks]
        if not plan:
            return 0
        tier.stage([k for k, _, _ in plan])
        self._pending_prewarm.extend(plan)
        return len(plan)

    def _pump_prewarm(self, budget: int, spent: int) -> Tuple[int, int]:
        """Drain queued prewarm copy-ins under the tick's remaining prefill
        budget (decode_server.py:2584), `block_size` tokens a block, the
        price a revive pays. Allocation is strictly additive: the plain
        free list only, keeping `n_slots` free blocks for admissions, so a
        prewarm can slow-start but never evict live traffic's cache.
        Returns (copy-ins, budget used)."""
        tier = self.spill_tier
        copies = 0
        used = 0
        reserve = self.n_slots
        while self._pending_prewarm:
            key, chain_keys, chain_tokens = self._pending_prewarm[0]
            cost = self.block_size
            if budget and (spent + used) and spent + used + cost > budget:
                break
            if self._block_mgr.device_resident(key):
                # A real admission's revive served it meanwhile.
                self._pending_prewarm.popleft()
                tier.unstage([key])
                continue
            if self._block_mgr.counts()["free"] <= reserve:
                # No additive headroom: keep the queue for a later release.
                break
            payload = tier.take(key)
            if payload is None:
                self._pending_prewarm.popleft()
                continue
            if not self._payload_matches(payload):
                # Another wire format (counted): never index bytes this
                # pool cannot attend.
                self.kv_quant_payload_rejected += 1
                if self.metrics is not None:
                    self.metrics.inc("nos_tpu_decode_kv_quant_payload_rejected")
                self._pending_prewarm.popleft()
                continue
            block = self._block_mgr.admit_prewarm_block(key, chain_tokens, chain_keys,
                                                        reserve_free=reserve)
            if block is None:
                self._pending_prewarm.popleft()
                continue
            self._dispatch_revive(payload, block)
            self._pending_prewarm.popleft()
            self._tick_state.mark_dirty()
            self.prewarm_tokens += cost
            copies += 1
            used += cost
        return copies, used

    # -- engine ----------------------------------------------------------------
    def start(self) -> "DecodeServer":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = False, drain_timeout_s: Optional[float] = None) -> None:
        """Stop the engine. `drain=False`: the loop exits and every
        outstanding future FAILS. `drain=True`: admission closes first, then
        every queued and in-flight request runs to completion (an engine
        never start()ed drains by ticking inline) unless `drain_timeout_s`
        elapses first."""
        if drain:
            self._closed.set()
            deadline = (
                time.monotonic() + drain_timeout_s if drain_timeout_s is not None else None
            )
            while self._has_outstanding():
                if deadline is not None and time.monotonic() > deadline:
                    logger.warning("drain timed out with work outstanding; hard-stopping")
                    break
                if self._thread is None:
                    self._tick()
                else:
                    self._stop.wait(0.005)
        self._closed.set()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._fail_outstanding(RuntimeError("DecodeServer stopped"))

    def _note_accepted(self, fut: Future) -> None:
        with self._accept_lock:
            if len(self._accepted) > 64:
                self._accepted = [f for f in self._accepted if not f.done()]
            self._accepted.append(fut)

    def _drop_accepted(self, fut: Future) -> None:
        """Ownership transfer at a handoff export (decode_server.py:1605):
        the future now belongs to another replica's completion, so this
        engine's drain must stop counting it as work owed here."""
        with self._accept_lock:
            self._accepted = [f for f in self._accepted if f is not fut]

    def _has_outstanding(self) -> bool:
        with self._accept_lock:
            self._accepted = [f for f in self._accepted if not f.done()]
            return bool(self._accepted)

    def _fail_outstanding(self, exc: Exception) -> None:
        for idx, slot in enumerate(self._slots):
            if slot.future is not None and not slot.future.done():
                slot.future.set_exception(exc)
                self._close_receipt(slot, constants.RECEIPT_STATUS_FAILED, 0)
            self._release_slot(idx)
        self._inflight.clear()
        # Unresolved verify rounds refer to slots that no longer exist.
        self._pending_verifies.clear()
        while self._waiting:
            req = self._waiting.popleft()
            if not req.future.done():
                req.future.set_exception(exc)
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if not req.future.done():
                req.future.set_exception(exc)

    def _release_slot(self, idx: int, spill: bool = False) -> None:
        """Return the slot's page references to the pool (shared blocks only
        decrement; refcount-0 indexed blocks retire to the cached-free LRU,
        or with `spill` (preemption) to the host tier, freeing the device
        blocks at once) and clear its lane (decode_server.py:1911). Claimed
        revives not yet copied die with it. With a cost ledger this is the
        one slot-seconds charge site, for every kind of release."""
        if self._cost is not None:
            self._note_slot_release(idx)
        slot = self._slots[idx]
        if slot.pending_revives and self.spill_tier is not None:
            self.spill_tier.unstage([k for _, _, k in slot.pending_revives])
        self._block_mgr.release(idx, spill=spill)
        self._slots[idx] = _Slot()
        self._tick_state.mark_table_dirty()

    def _note_slot_release(self, idx: int) -> None:
        slot = self._slots[idx]
        if not slot.active or not slot.t_reserved:
            return
        held = max(0.0, time.monotonic() - slot.t_reserved)
        slot.t_reserved = 0.0
        self.slot_seconds_total += held
        self._cost.charge(slot.trace_id, slot.tenant or "", slot_seconds=held,
                          chip_ms=held * 1000.0 * self._chip_rate)

    def _close_receipt(self, slot: _Slot, status: str,
                       tokens: Optional[int] = None) -> Optional[dict]:
        """Close the request's cost receipt at its finish or failure
        (decode_server.py:1947); a no-op without a ledger or a trace id."""
        if self._cost is None:
            return None
        rec = self._cost.close_request(slot.trace_id, slot.tenant or "", status=status,
                                       tokens=tokens)
        if rec is not None:
            self.cost_receipts += 1
        return rec

    def _reset_device_state(self) -> None:
        """After an engine error the pool is untrustworthy: zero it (an int8
        pool's scales too), and the token vectors, in place (the reference
        reallocates them; the captured window holds their addresses, and
        keeps them across every recovery). The page table goes up again
        with the next packed sync, and the prefix index dies with the
        pool; host-tier payloads survive."""
        for pool in self._pools():
            for layer in pool.values():
                for t in layer.values():
                    t.zero_()
        self._table_np[:] = 0
        self._tick_state.mark_table_dirty()
        self._block_mgr.reset()
        self._last_dev.zero_()
        self._first_dev.zero_()

    def _bucket(self, n: int) -> int:
        for b in self.prompt_buckets:
            if b >= n:
                return b
        return self.prompt_buckets[-1]

    def _drain_queue(self) -> None:
        while True:
            try:
                self._waiting.append(self._queue.get_nowait())
            except queue.Empty:
                break

    def _next_request(self) -> Optional[_Request]:
        """FIFO across the waiting line and the client queue."""
        self._drain_queue()
        if self._waiting:
            return self._waiting.popleft()
        return None

    def _admit(self) -> None:
        """Admission (decode_server.py:2002, :2041) only RESERVES the slot,
        its serial, its KV blocks and a prefill cursor; the per-tick budget
        scheduler (_pump_prefill) spends the prompt tokens. A rejected
        request does not burn its slot: the same slot pulls the next queued
        request. Checkpoint restores re-enter here at the head of the line:
        their effective prompt is prompt + replay, their client validation
        is skipped (their first admission passed it), and they keep their
        sampling serial. A fault between block assignment and binding
        undoes the partial admission and puts the request back at the
        head of the line before it propagates. With a QuotaPolicy,
        requests of a tenant at its ceiling, or borrowing while a starved
        tenant waits, are skipped in place: they keep their position, and
        a preempted borrower cannot retake what its preemption freed."""
        skipped: List[_Request] = []
        starved_waiting = False
        if self._quota is not None:
            self._drain_queue()
            starved_waiting = any(self._quota.is_starved(r.tenant) for r in self._waiting)
        try:
            self._admit_scan(skipped, starved_waiting)
        finally:
            # Skipped requests go back to the front in their order.
            for req in reversed(skipped):
                self._waiting.appendleft(req)

    def _admit_scan(self, skipped: List[_Request], starved_waiting: bool) -> None:
        for idx, slot in enumerate(self._slots):
            if slot.active:
                continue
            while True:
                req = self._next_request()
                if req is None:
                    return
                if self._quota is not None and self._quota.admission_blocked(
                        req.tenant, starved_waiting):
                    skipped.append(req)
                    continue
                full_prompt = list(req.prompt) + list(req.replay)
                eff_new = req.max_new - len(req.replay)
                if not req.replay:
                    if len(full_prompt) >= self.max_len:
                        req.future.set_exception(ValueError(
                            f"prompt length {len(full_prompt)} >= max_len {self.max_len}"))
                        continue
                    if len(full_prompt) + eff_new - 1 > self.max_len:
                        # The request cannot complete inside the
                        # per-sequence window: reject rather than resolve
                        # with fewer tokens.
                        req.future.set_exception(ValueError(
                            f"prompt length {len(full_prompt)} + max_new {eff_new} "
                            f"exceeds max_len {self.max_len}: output would be truncated"))
                        continue
                # The cache holds positions 0..len+max_new-2 (the final
                # sampled token is never re-attended); a restore moves
                # tokens from max_new into the prompt, never their sum.
                n_blocks = max(1, -(-(len(full_prompt) + eff_new - 1) // self.block_size))
                if n_blocks > self.total_blocks - 1:
                    req.future.set_exception(ValueError(
                        f"request needs {n_blocks} KV blocks; the pool has "
                        f"{self.total_blocks - 1}"))
                    continue
                evict0 = self._block_mgr.evictions
                try:
                    admitted = self._block_mgr.admit(
                        idx, full_prompt, n_blocks, use_cache=self.prefix_cache)
                except Exception:
                    # The `block_admit` site (or a bookkeeping error) fires
                    # before the request is bound: re-queue it at the head,
                    # then let the engine's fault handling see the fault.
                    self._waiting.appendleft(req)
                    raise
                if admitted is None:
                    # Pool exhausted: wait, FIFO head-of-line.
                    self._waiting.appendleft(req)
                    return
                break
            blocks, n_hit = admitted
            bound = False
            try:
                if self.metrics is not None and self.prefix_cache:
                    self.metrics.inc("nos_tpu_decode_prefix_lookups")
                    if n_hit:
                        self.metrics.inc("nos_tpu_decode_prefix_hit_blocks", n_hit)
                        self.metrics.inc("nos_tpu_decode_prefix_hit_tokens",
                                         n_hit * self.block_size)
                    evicted = self._block_mgr.evictions - evict0
                    if evicted:
                        self.metrics.inc("nos_tpu_decode_prefix_evictions", evicted)
                self._table_np[idx, :] = 0
                self._table_np[idx, : len(blocks)] = blocks
                self._tick_state.mark_table_dirty()
                serial = req.serial if req.serial is not None else self._next_serial
                if req.serial is None:
                    self._next_serial += 1
                self._slot_serial[idx] = serial
                slot.phase = "reserved"
                slot.future = req.future
                slot.request_prompt = list(req.prompt)
                slot.max_new = req.max_new
                slot.replay = list(req.replay)
                slot.step_base = len(req.replay)
                slot.t_restore = req.t_restore
                slot.tenant = req.tenant
                slot.trace_id = req.trace_id
                slot.trace_decoding = False
                slot.handoff_export = req.handoff_export
                slot.handoff_ingest = req.handoff_ingest
                slot.pending_prompt = full_prompt
                # Prefix hits are already in the page table: the cursor
                # starts at the first miss (always below the last-token
                # block).
                slot.prefill_cursor = n_hit * self.block_size
                # Host-tier hits right behind the device run, to copy in
                # (_pump_revives), then the diverging block's shared head,
                # to copy (_pump_cow), both instead of recomputing them.
                slot.pending_revives = self._block_mgr.claim_revives(idx)
                slot.pending_cow = self._block_mgr.claim_cow(idx)
                if self.metrics is not None and slot.pending_cow is not None:
                    self.metrics.inc("nos_tpu_decode_prefix_cow_hits")
                    self.metrics.inc("nos_tpu_decode_prefix_cow_tokens", slot.pending_cow[4])
                slot.t_submit = req.t_submit
                slot.pos = slot.prefill_cursor
                slot.remaining = eff_new - 1
                slot.refs = []
                slot.eos_scanned = 0
                if self.spec_k > 0:
                    slot.prompt = list(full_prompt)
                    slot.adapt = (AdaptiveSpec.restore(req.spec) if req.spec is not None
                                  else AdaptiveSpec())
                # Bind last: from here the recovery sweep finds the future.
                slot.active = True
                bound = True
                replayed = 0
                if req.t_restore:
                    # Replay accounting counts only the uncached suffix:
                    # device hits, staged revives and the COW head serve
                    # their tokens without recompute.
                    cached = (n_hit + len(slot.pending_revives)) * self.block_size
                    if slot.pending_cow is not None:
                        cached += int(slot.pending_cow[4])
                    replayed = max(0, len(full_prompt) - cached)
                    self.replay_tokens += replayed
                    if self.metrics is not None:
                        self.metrics.inc("nos_tpu_decode_replay_tokens", replayed)
                else:
                    wait = time.monotonic() - req.t_submit
                    tname = req.tenant or ""
                    self.queue_wait_s.append(wait)
                    self.queue_wait_s_by_tenant.setdefault(tname, []).append(wait)
                    self.admissions_by_tenant[tname] = self.admissions_by_tenant.get(tname, 0) + 1
                if self._cost is not None:
                    # The slot-seconds interval opens at the reservation;
                    # cached prefill (device hits and the COW head) and a
                    # restore's replay are charged here.
                    slot.t_reserved = time.monotonic()
                    acct = req.tenant or ""
                    self._cost.open_request(slot.trace_id, acct)
                    cached = n_hit * self.block_size
                    if slot.pending_cow is not None:
                        cached += int(slot.pending_cow[4])
                    if cached:
                        self._cost.charge(slot.trace_id, acct, prefill_tokens_cached=cached)
                    if req.t_restore and replayed:
                        self._cost.charge(slot.trace_id, acct, replay_tokens=replayed)
                if self._tracer is not None:
                    self._tracer.event(
                        slot.trace_id,
                        constants.TRACE_EV_RESTORE if req.t_restore
                        else constants.TRACE_EV_RESERVED,
                        slot=idx, serial=serial, hit_blocks=n_hit,
                        replay_tokens=len(req.replay))
                if self._recorder is not None:
                    self._recorder.record(constants.FLIGHT_EV_ADMIT, slot=idx, serial=serial,
                                          hit_blocks=n_hit, restore=int(bool(req.t_restore)))
                self._check_fault("admit", idx)
            except Exception:
                if not bound:
                    self._block_mgr.release(idx)
                    self._slots[idx] = _Slot()
                    self._waiting.appendleft(req)
                raise

    # -- budgeted prefill ------------------------------------------------------
    def _pump_prefill(self) -> int:
        """Spend up to `prefill_budget_tokens` prompt tokens of chunked
        prefill this tick, in WAVES of at most one chunk per admitted slot,
        scanned round-robin from a rotating start. The tick's first chunk
        always dispatches; once a chunk does not fit, the tick's prefill
        closes. Returns the number of dispatches."""
        rr = self._prefill_rr % self.n_slots
        order = [
            idx
            for idx in (*range(rr, self.n_slots), *range(rr))
            if self._slots[idx].active
            and self._slots[idx].phase in ("reserved", "prefilling")
        ]
        if not order:
            return 0
        self._prefill_rr = (self._prefill_rr + 1) % self.n_slots
        budget = self.prefill_budget_tokens  # 0 = unbudgeted (inline drain)
        chunk = self.prompt_buckets[-1]
        spent = 0
        dispatches = 0
        exhausted = False
        while not exhausted:
            wave: List[Tuple[int, int, list]] = []
            revived = 0
            for idx in order:
                slot = self._slots[idx]
                if slot.phase not in ("reserved", "prefilling"):
                    continue  # finished in an earlier wave of this tick
                if slot.pending_revives or slot.pending_cow is not None:
                    # This wave's visit goes to the copies, charged like
                    # the recompute they replace; if the budget closes
                    # before they are done, the rest waits a tick.
                    with self._prof.phase(constants.TICK_PHASE_PUMP_REVIVES):
                        if slot.pending_revives:
                            n_copies, used = self._pump_revives(idx, budget, spent)
                            left = bool(slot.pending_revives)
                        else:
                            n_copies, used = self._pump_cow(idx, budget, spent)
                            left = slot.pending_cow is not None
                    revived += n_copies
                    dispatches += n_copies
                    spent += used
                    if left:
                        exhausted = True
                        break
                    continue
                start = slot.prefill_cursor
                piece = slot.pending_prompt[start : start + chunk]
                if budget and spent and spent + len(piece) > budget:
                    exhausted = True
                    break
                wave.append((idx, start, piece))
                spent += len(piece)
            if not wave and not revived:
                break
            if wave:
                dispatches += self._dispatch_prefill_wave(wave)
            if budget and spent >= budget:
                break
        if self._pending_prewarm and not exhausted:
            # Leftover budget warms the fleet-store prewarm queue
            # (decode_server.py:2361): admissions always go first.
            n_pw, _ = self._pump_prewarm(budget, spent)
            dispatches += n_pw
        return dispatches

    def _pump_revives(self, idx: int, budget: int, spent: int) -> Tuple[int, int]:
        """Copy slot `idx`'s host-spilled prefix blocks into its fresh
        pages, front first, `block_size` budget tokens a block
        (decode_server.py:2368). Returns (copy-ins, budget used). A payload
        the tier dropped meanwhile sends the rest of the run to recompute:
        the same output, paid in forward passes."""
        slot = self._slots[idx]
        copies = used = 0
        while slot.pending_revives:
            start, block, key = slot.pending_revives[0]
            if start != slot.prefill_cursor:
                # The compute path already owns this range: recompute.
                self.spill_tier.unstage([k for _, _, k in slot.pending_revives])
                slot.pending_revives = []
                break
            cost = self.block_size
            if budget and (spent + used) and spent + used + cost > budget:
                break
            self._check_fault("revive", idx)
            payload = self.spill_tier.take(key)
            if payload is None or not self._dispatch_revive(payload, block):
                self.spill_tier.unstage([k for _, _, k in slot.pending_revives[1:]])
                slot.pending_revives = []
                break
            self._tick_state.mark_dirty()
            if self._tracer is not None:
                self._tracer.event(slot.trace_id, constants.TRACE_EV_REVIVE, slot=idx,
                                   block=block, offset=start)
            if self._recorder is not None:
                self._recorder.record(constants.FLIGHT_EV_REVIVE, slot=idx, block=block)
            slot.pending_revives.pop(0)
            slot.prefill_cursor = start + cost
            slot.pos = slot.prefill_cursor
            if slot.phase == "reserved":
                slot.phase = "prefilling"
            copies += 1
            used += cost
            if slot.handoff_ingest:
                # A handoff arrival serving its replay from the prefill
                # replica's published payloads: shipped, not recomputed.
                self.handoff_revived_tokens += cost
                if self.metrics is not None:
                    self.metrics.inc("nos_tpu_fleet_handoff_revived_tokens", cost)
            elif slot.t_restore:
                # A restore (after a fault or a preemption) took these
                # replay tokens from host bytes instead of recompute.
                self.failover_revive_tokens += cost
            if self._cost is not None:
                # Cached service of `block_size` prompt tokens, at the
                # price of one full-width payload copy-in.
                self._cost.charge(slot.trace_id, slot.tenant or "", prefill_tokens_cached=cost,
                                  spill_bytes=self._bytes_per_block)
            # Device-resident again: re-index it for same-prefix arrivals.
            self._block_mgr.note_progress(idx, slot.prefill_cursor)
        return copies, used

    def _pump_cow(self, idx: int, budget: int, spent: int) -> Tuple[int, int]:
        """Slot `idx`'s staged copy-on-write, charging its `length` budget
        tokens (decode_server.py:2459): a device source is one `_cow_copy`
        (its pin released after), a host source a full-payload revive into
        the private block, of which only the matched head counts (the slot's
        own chunks overwrite the tail before anything attends it). A
        dropped payload means recompute. Returns (copies, budget used);
        `pending_cow` still set means the budget closed first."""
        slot = self._slots[idx]
        offset, dst, src, key, n = slot.pending_cow
        if offset != slot.prefill_cursor:
            slot.pending_cow = None
            self._block_mgr.cow_done(idx)
            return 0, 0
        if budget and spent and spent + n > budget:
            return 0, 0
        self._check_fault("cow", idx)
        if src is not None:
            with self._prof.dispatch(DISPATCH_COW):
                self._cow_copy(src, dst, n)
            self._block_mgr.cow_done(idx)
        else:
            payload = self.spill_tier.get(key) if self.spill_tier is not None else None
            if payload is None or not self._dispatch_revive(payload, dst):
                slot.pending_cow = None
                return 0, 0
        slot.pending_cow = None
        slot.prefill_cursor = offset + n
        slot.pos = slot.prefill_cursor
        if slot.phase == "reserved":
            slot.phase = "prefilling"
        self._tick_state.mark_dirty()
        if self._tracer is not None:
            self._tracer.event(slot.trace_id, constants.TRACE_EV_COW, slot=idx, block=dst,
                               offset=offset, tokens=n)
        if self._recorder is not None:
            self._recorder.record(constants.FLIGHT_EV_COW, slot=idx, block=dst, tokens=n)
        return 1, n

    def _dispatch_prefill_wave(self, wave: List[Tuple[int, int, list]]) -> int:
        """Dispatch one wave (decode_server.py:2644). Mid-prompt chunks
        sharing a bucket go through the batched multi-slot window program;
        a singleton mid chunk keeps the batch-1 program. Final chunks
        always go through the batch-1 program's final body, which samples
        the first token (`_prefill_chunk`)."""
        self._check_fault("dispatch_prefill_wave", wave[0][0])
        # The wave's first dispatch uploads the table (a no-op after it).
        packed = self._pack_tick_state(for_table_only=True)
        table = self._table()
        mids: Dict[int, List[Tuple[int, int, list]]] = {}
        finals: List[Tuple[int, int, list]] = []
        for entry in wave:
            idx, start, piece = entry
            if start + len(piece) >= len(self._slots[idx].pending_prompt):
                finals.append(entry)
            else:
                mids.setdefault(self._bucket(len(piece)), []).append(entry)
        dispatches = 0
        for bucket, entries in sorted(mids.items()):
            if len(entries) == 1:
                inputs = self._chunk_inputs(bucket, *entries[0])
                with self._prof.dispatch(DISPATCH_PREFILL_CHUNK):
                    self._tick_state.sync(packed)
                    self._prefill_chunk(inputs, final=False)
            else:
                # The wave's own lanes only, their table rows gathered on
                # the device: n chunks compute n x bucket rows, whatever
                # the engine's lane count.
                n = len(entries)
                tokens = np.zeros((n, bucket), dtype=np.int32)
                lanes = np.zeros((n,), dtype=np.int64)
                pos = np.zeros((n,), dtype=np.int32)
                lengths = np.zeros((n,), dtype=np.int32)
                for row, (idx, start, piece) in enumerate(entries):
                    tokens[row, : len(piece)] = piece
                    lanes[row] = idx
                    pos[row] = start
                    lengths[row] = len(piece)
                with self._prof.dispatch(DISPATCH_PREFILL_WINDOW):
                    self._tick_state.sync(packed)
                    rows = self._stage.to_device(lanes)
                    if self._tp is None:
                        wave_table = table.index_select(0, rows)
                    else:
                        wave_table = [t.index_select(0, rows.to(t.device)) for t in table]
                    self._prefill_window(
                        self._stage.to_device(tokens),
                        wave_table,
                        self._stage.to_device(pos),
                        self._stage.to_device(lengths),
                        torch.ones((n,), dtype=torch.bool, device=rows.device),
                    )
                self.prefill_window_dispatches += 1
            dispatches += 1
        ref = None
        for n, (idx, start, piece) in enumerate(finals):
            inputs = self._chunk_inputs(self._bucket(len(piece)), idx, start, piece,
                                        self._slots[idx].step_base)
            with self._prof.dispatch(DISPATCH_PREFILL_LAST):
                self._tick_state.sync(packed)
                if n == 0:
                    self._first_dev = self._first_dev.clone()
                self._prefill_chunk(inputs, final=True)
                if n == len(finals) - 1:
                    # ONE ref over the wave's first-token vector for every
                    # slot finishing in this wave: a single device->host
                    # transfer.
                    ref = _TokRef(self._first_dev, self._syncs)
            dispatches += 1
        # Cursor/phase advances dirty the scheduling metadata (not the table).
        self._tick_state.mark_dirty()
        for idx, start, piece in wave:
            slot = self._slots[idx]
            slot.prefill_cursor = start + len(piece)
            slot.pos = slot.prefill_cursor
            if slot.phase == "reserved":
                slot.phase = "prefilling"
            self.prefill_tokens += len(piece)
            if self._cost is not None:
                self._cost.charge(slot.trace_id, slot.tenant or "",
                                  prefill_tokens_charged=len(piece))
            if self._tracer is not None:
                self._tracer.event(slot.trace_id, constants.TRACE_EV_PREFILL_CHUNK, slot=idx,
                                   start=start, tokens=len(piece))
            # Full prompt blocks behind the dispatched cursor become
            # shareable; a later same-prefix chunk runs after this wave on
            # the same stream, so its reads see these writes.
            self._block_mgr.note_progress(idx, slot.prefill_cursor)
        if finals:
            now = time.monotonic()
            exports: List[int] = []
            for idx, _, _ in finals:
                slot = self._slots[idx]
                slot.phase = "decoding"
                slot.pos = len(slot.pending_prompt)
                slot.pending_prompt = None
                slot.refs.append((ref, idx, None))
                if slot.t_restore:
                    # A restored slot's first token is its replay coming
                    # back online: a restore-latency sample, not a TTFT.
                    self.restore_latency_s.append(now - slot.t_restore)
                else:
                    self.ttft_s.append(now - slot.t_submit)
                    self.ttft_s_by_tenant.setdefault(slot.tenant or "", []).append(
                        now - slot.t_submit)
                if self._tracer is not None:
                    self._tracer.event(slot.trace_id, constants.TRACE_EV_FIRST_TOKEN, slot=idx,
                                       pos=slot.pos)
                self._finish_if_done(idx)
                # Re-read the lane: a request that finished at its first
                # token has a fresh _Slot there and never exports.
                if (self._slots[idx].handoff_export and self._slots[idx].active
                        and self._handoff_hook is not None):
                    exports.append(idx)
            # In this wave, before the tick's decode dispatch builds its
            # lane list: an exported slot never enters a window.
            for idx in exports:
                self._export_handoff(idx)
        self.prefill_dispatches += dispatches
        n_tokens = sum(len(piece) for _, _, piece in wave)
        if self._recorder is not None:
            self._recorder.record(constants.FLIGHT_EV_PREFILL_WAVE, dispatches=dispatches,
                                  tokens=n_tokens, finals=len(finals))
        if self.metrics is not None:
            self.metrics.inc("nos_tpu_decode_prefill_dispatches", dispatches)
            self.metrics.inc("nos_tpu_decode_prefill_tokens", n_tokens)
        return dispatches

    def _export_handoff(self, idx: int) -> None:
        """Prefill-complete export (decode_server.py:2812): checkpoint the
        slot, publish its prompt chain into the shared store, release the
        slot and hand the checkpoint to the handoff hook; the decode runs
        on whatever replica the coordinator picks. The capture materializes
        the first token (the destination replays it: serial and PRNG step
        ride the checkpoint), the chain goes to the store before the
        release so every full prompt block is there when the destination
        stages its revives, and the future leaves this engine's accepted
        set with the checkpoint. A key the store has dropped meanwhile
        degrades that block to recompute at the destination: the same
        tokens."""
        slot = self._slots[idx]
        ck = self._checkpoint_slot(idx)
        if ck is None:
            # Completed at capture (eos or budget): resolved here.
            self._release_slot(idx)
            return
        published = self._block_mgr.publish_slot_chain(idx)
        self.handoff_exports += 1
        self.handoff_published_blocks += published
        if self.metrics is not None:
            self.metrics.inc("nos_tpu_fleet_handoff_exports")
            if published:
                self.metrics.inc("nos_tpu_fleet_handoff_published_blocks", published)
        if self._tracer is not None:
            self._tracer.event(slot.trace_id, constants.TRACE_EV_HANDOFF, slot=idx,
                               published_blocks=published, generated=len(ck.generated))
        if ck.future is not None:
            self._drop_accepted(ck.future)
        self._release_slot(idx)
        try:
            self._handoff_hook(ck)
        except Exception as exc:
            # The hook owns recovery (it holds the checkpoint and the
            # future); its raise must not take the engine loop down.
            logger.exception("handoff hook raised (%s); engine continues",
                             classify_fault(exc))

    # -- completion ------------------------------------------------------------
    @staticmethod
    def _token_at(ref: _TokRef, lane: int, row: Optional[int]) -> int:
        arr = ref.np()
        if row is None:
            return int(arr[lane])  # admission-wave first-token vector
        return int(arr[row, lane])  # macro-dispatch window [K, n_slots]

    def _materialize_tokens(self, slot: _Slot) -> List[int]:
        return [self._token_at(ref, lane, row) for ref, lane, row in slot.refs]

    def _finalize(self, slot: _Slot) -> List[int]:
        """Materialize the output, truncated at EOS (the countdown can fire
        before a late EOS was scanned). A restored slot prepends its
        replayed tokens (never holding an eos: such a checkpoint resolves
        at capture), so the client sees one generation."""
        tokens = self._materialize_tokens(slot)
        if self.eos_id is not None and self.eos_id in tokens:
            tokens = tokens[: tokens.index(self.eos_id) + 1]
        return list(slot.replay) + tokens

    def _trace_finish(self, idx: int, slot: _Slot, n_tokens: int,
                      receipt: Optional[dict] = None) -> None:
        """The lifecycle terminus (decode_server.py:2890): one span event
        and one recorder event per completed request, the receipt's
        numeric fields riding the span as attrs."""
        if self._tracer is not None:
            attrs = {}
            if receipt is not None:
                attrs = {k: round(v, 6) if isinstance(v, float) else v
                         for k, v in receipt.items()
                         if isinstance(v, (int, float)) and not isinstance(v, bool)
                         and k not in ("tokens", "slot")}
            self._tracer.event(slot.trace_id, constants.TRACE_EV_FINISH, slot=idx,
                               tokens=n_tokens, **attrs)
        if self._recorder is not None:
            self._recorder.record(constants.FLIGHT_EV_FINISH, slot=idx, tokens=n_tokens)

    def _finish_if_done(self, idx: int) -> None:
        """Deterministic completion: the countdown and the cache bound are
        known at dispatch time (slot.pos is the NEXT write index)."""
        slot = self._slots[idx]
        if not slot.active or slot.phase != "decoding":
            return
        if slot.remaining <= 0 or slot.pos >= self.max_len:
            out = self._finalize(slot)
            self._register_output(idx, slot, out)
            slot.future.set_result(out)
            # Release before the terminus, so the receipt closed there
            # holds the final slot-seconds.
            self._release_slot(idx)
            receipt = self._close_receipt(slot, constants.RECEIPT_STATUS_OK, len(out))
            self._trace_finish(idx, slot, len(out), receipt)

    def _register_output(self, idx: int, slot: _Slot, out: List[int]) -> None:
        """Radix mode (decode_server.py:2942): key the finished request's
        generated-token blocks, so a follow-up turn re-submitting `history
        + new tokens` walks the tree to the end of the history. Runs just
        before the release, so those blocks retire to the cached LRU."""
        if not self.radix_cache:
            return
        before = self._block_mgr.output_blocks
        self._block_mgr.register_output(idx, list(slot.request_prompt or []) + out)
        registered = self._block_mgr.output_blocks - before
        if self.metrics is not None and registered:
            self.metrics.inc("nos_tpu_decode_output_blocks_registered", registered)

    def _scan_eos(self) -> None:
        """With an eos_id, termination depends on token values: scan refs
        that have materialized (the depth clamp bounds the lag). Tokens
        dispatched after a late-detected EOS are discarded."""
        if self.eos_id is None:
            return
        for idx, slot in enumerate(self._slots):
            if not slot.active:
                continue
            while slot.eos_scanned < len(slot.refs):
                ref, lane, row = slot.refs[slot.eos_scanned]
                if not ref.is_ready():
                    break
                token = self._token_at(ref, lane, row)
                slot.eos_scanned += 1
                if token == self.eos_id:
                    slot.refs = slot.refs[: slot.eos_scanned]
                    out = self._finalize(slot)
                    self._register_output(idx, slot, out)
                    slot.future.set_result(out)
                    self._release_slot(idx)
                    receipt = self._close_receipt(slot, constants.RECEIPT_STATUS_OK, len(out))
                    self._trace_finish(idx, slot, len(out), receipt)
                    break

    # -- speculative rounds (decode_server.py:2991-3259) -------------------------
    def _sync_spec_history(self, idx: int, blocking: bool) -> bool:
        """Bring the slot's host history up to date with its refs (only
        refs already materialized unless `blocking`). True when every
        dispatched token is in it: the verify round needs window[0] to be
        the true last token, at slot.pos == len(history) - 1."""
        slot = self._slots[idx]
        if slot.history is None:
            if not slot.refs:
                return False  # prefill not dispatched yet
            if not blocking and not slot.refs[0][0].is_ready():
                return False
            slot.history = list(slot.prompt)
            slot.lookup = _LookupIndex(slot.history, self.spec_ngram)
        known = len(slot.history) - len(slot.prompt)
        new = []
        for ref, lane, row in slot.refs[known:]:
            if not blocking and not ref.is_ready():
                break
            new.append(self._token_at(ref, lane, row))
        if new:
            slot.lookup.extend(new)  # appends to slot.history (shared alias)
        return len(slot.history) - len(slot.prompt) == len(slot.refs)

    def _spec_sources(self) -> List[str]:
        """Draft sources in probe order: the radix tree's stored
        continuation (tree armed and `spec_tree_drafts`), then the slot's
        own prompt lookup, always last."""
        if self.spec_tree_drafts and self._block_mgr.has_tree():
            return [SOURCE_TREE, SOURCE_HISTORY]
        return [SOURCE_HISTORY]

    def _spec_drafts(self) -> dict:
        """Non-blocking draft probe: {slot idx -> (draft tokens, source)}
        for decoding slots with no verify in flight, more than one token
        left, a source their controller allows, a fully synced history,
        and a continuation from a source. The tree probe
        (`BlockManager.draft_continuation`) reads without touching
        refcounts or the LRU."""
        drafts = {}
        sources = self._spec_sources()
        for idx, slot in enumerate(self._slots):
            if not slot.active or slot.phase != "decoding":
                continue
            if slot.verifying or slot.remaining <= 1:
                continue
            if not any(slot.adapt.allowed(len(slot.refs), s) for s in sources):
                continue
            if not self._sync_spec_history(idx, blocking=self.spec_sync):
                continue
            # At most `remaining` tokens a round, and the window's last row
            # inside the slot's blocks (positions 0..prompt+max_new-2).
            base = min(self.spec_k, slot.remaining - 1)
            for source in sources:
                if not slot.adapt.allowed(len(slot.refs), source):
                    continue
                cap = min(base, slot.adapt.cap(self.spec_k, source))
                if source == SOURCE_TREE:
                    d = self._block_mgr.draft_continuation(slot.history, cap)
                else:
                    d = slot.lookup.draft(cap)
                if d:
                    drafts[idx] = (d, source)
                    break
        return drafts

    def _dispatch_verify(self, drafts: dict) -> None:
        """One `paged_verify_window` over ONLY the drafting slots (the
        other lanes write the scratch page), W = spec_k + 1 rows each. The
        [n_slots, W] greedy predictions stay on the device as a `_TokRef`;
        acceptance resolves on a later tick while macro windows go on."""
        self._check_fault("dispatch_verify", next(iter(drafts)))
        W = self.spec_k + 1
        tokens = np.zeros((self.n_slots, W), dtype=np.int32)
        lengths = np.zeros((self.n_slots,), dtype=np.int32)
        active = np.zeros((self.n_slots,), dtype=bool)
        windows: Dict[int, list] = {}
        sources: Dict[int, str] = {}
        for idx, (draft, source) in drafts.items():
            slot = self._slots[idx]
            window = [slot.history[-1]] + draft[: max(0, slot.remaining - 1)]
            windows[idx] = window
            sources[idx] = source
            tokens[idx, : len(window)] = window
            lengths[idx] = len(window)
            active[idx] = True
            slot.verifying = True
            self.spec_rounds_by_slot[idx] += 1
            if source == SOURCE_TREE:
                self.spec_tree_rounds += 1
            else:
                self.spec_history_rounds += 1
            if self.metrics is not None:
                self.metrics.inc(_DRAFT_SOURCE_METRICS[source][0])
            if self._tracer is not None and not slot.trace_decoding:
                slot.trace_decoding = True
                self._tracer.event(slot.trace_id, constants.TRACE_EV_DECODE, slot=idx)
        # The drafting flags changed the macro mask: the verify's read of
        # `pos` and this tick's window consume one freshly packed state.
        self._tick_state.mark_dirty()
        packed = self._pack_tick_state()
        with self._prof.dispatch(DISPATCH_VERIFY):
            self._tick_state.sync(packed)
            logits, _ = paged_verify_window(
                self.params, self._stage.to_device(tokens), self.cfg, self.cache,
                self._table(), self._tick_state.pos, self._stage.to_device(lengths),
                self._stage.to_device(active), self.block_size, tp=self._tp,
                moe_tally=self._expert_tally[1],
            )
            preds = _TokRef(greedy(logits), self._syncs)
        self.steps_run += 1
        self.spec_rounds += 1
        if self._recorder is not None:
            self._recorder.record(constants.FLIGHT_EV_VERIFY, slots=len(drafts), window=W)
        if self.metrics is not None:
            self.metrics.inc("nos_tpu_decode_steps")
            self.metrics.inc("nos_tpu_decode_spec_rounds")
        self._pending_verifies.append(_PendingVerify(preds, windows, sources))

    def _resolve_verifies(self, block: bool) -> None:
        """Fold completed verify rounds into slot state, oldest first: only
        rounds whose predictions are ready, or with `block` the oldest one
        (used only when the drafting slots are the engine's sole possible
        progress; at most one blocking read a call)."""
        while self._pending_verifies:
            entry = self._pending_verifies[0]
            if not block and not entry.preds.is_ready():
                return
            # Before the popleft: a transient here retries the same round.
            self._check_fault("resolve_verifies", next(iter(entry.windows)))
            self._pending_verifies.popleft()
            block = False
            self._apply_verify(entry)

    def _apply_verify(self, entry: _PendingVerify) -> None:
        """Resolve one verify round: one host read of the [n_slots, W]
        predictions, then per slot the accepted prefix, its controller's
        update, and an in-place scatter of each slot's new last token into
        the step-feed vector."""
        preds = entry.preds.np()
        self._tick_state.mark_dirty()
        rows: List[int] = []
        vals: List[int] = []
        for idx, window in entry.windows.items():
            slot = self._slots[idx]
            if not slot.active or not slot.verifying:
                continue  # released meanwhile
            slot.verifying = False
            accepted = accept_prefix(window, preds[idx, : len(window)])
            # A host-backed ref: it materializes without a device read.
            ref = _TokRef(torch.tensor(accepted, dtype=torch.int32).reshape(-1, 1))
            slot.refs.extend((ref, 0, j) for j in range(len(accepted)))
            slot.pos += len(accepted)
            slot.remaining -= len(accepted)
            slot.lookup.extend(accepted)
            self.spec_tokens_accepted += len(accepted)
            source = entry.sources.get(idx, SOURCE_HISTORY)
            if source == SOURCE_TREE:
                self.spec_tree_tokens_accepted += len(accepted)
            else:
                self.spec_history_tokens_accepted += len(accepted)
            if accepted:
                tname = slot.tenant or ""
                self.tokens_by_tenant[tname] = self.tokens_by_tenant.get(tname, 0) + len(accepted)
                if self._cost is not None:
                    self._cost.charge(slot.trace_id, tname, decode_tokens=len(accepted))
                if self._quota is not None:
                    self._tick_tokens[tname] = self._tick_tokens.get(tname, 0) + len(accepted)
            if self.metrics is not None:
                self.metrics.inc("nos_tpu_decode_spec_tokens_accepted", len(accepted))
                self.metrics.inc(_DRAFT_SOURCE_METRICS[source][1], len(accepted))
            if len(window) > 1 and slot.adapt.observe(
                    len(window) - 1, len(accepted) - 1, len(slot.refs), source):
                self.spec_demotions += 1
                if source == SOURCE_TREE:
                    self.spec_tree_demotions += 1
                else:
                    self.spec_history_demotions += 1
                if self.metrics is not None:
                    self.metrics.inc(_DRAFT_SOURCE_METRICS[source][2])
            rows.append(idx)
            vals.append(accepted[-1])
            if self.eos_id is not None and self.eos_id in accepted:
                slot.remaining = 0  # _finalize truncates at the eos
            self._finish_if_done(idx)
        if self._recorder is not None:
            self._recorder.record(constants.FLIGHT_EV_RESOLVE, slots=len(entry.windows),
                                  scattered=len(rows))
        if rows:
            with (self._prof.phase(constants.TICK_PHASE_SAMPLE_SCATTER),
                  self._prof.dispatch(DISPATCH_SCATTER)):
                self._last_dev[self._stage.to_device(rows, dtype=torch.long)] = (
                    self._stage.to_device(vals, dtype=torch.int32))

    # -- the tick ----------------------------------------------------------------
    def _run(self) -> None:
        """The engine loop (decode_server.py:3261): a tick-path exception
        is classified and repaired by `_recover`; without
        `surgical_recovery`, or when recovery itself raises, every
        outstanding request fails and the pool resets."""
        while not self._stop.is_set():
            try:
                self._tick()
                self._transient_streak = 0
            except Exception as exc:  # noqa: BLE001 — classified below
                logger.exception("decode engine step failed")
                with _DEVICE_GATE.shared():
                    if not self.surgical_recovery:
                        self._fail_all(exc)
                        continue
                    try:
                        self._recover(exc)
                    except Exception as rexc:  # nos-lint: ignore[NOS012]
                        # Recovery itself failed (double fault / bookkeeping
                        # violation): fail-all is the deliberate last-resort
                        # backstop — no classification can be trusted here.
                        logger.exception("surgical recovery failed; failing all")
                        self._fail_all(rexc)

    def _fail_all(self, exc: Exception) -> None:
        """The fail-all sweep (without surgical recovery, or when recovery
        itself raised): every outstanding request fails, the pool resets,
        and the flight recorder dumps a postmortem."""
        self.fail_all_recoveries += 1
        if self._recorder is not None:
            self._recorder.record(constants.FLIGHT_EV_FAIL_ALL)
            self._recorder.dump(constants.FLIGHT_EV_FAIL_ALL)
        self._fail_outstanding(exc)
        self._reset_device_state()

    def _check_fault(self, site: str, slot: Optional[int] = None) -> None:
        """The chaos hook: raises the injector's scheduled fault for this
        visit of `site`, if any."""
        if self._fault_injector is not None:
            self._fault_injector.check(site, slot=slot)

    def _recover(self, exc: Exception) -> None:
        """Surgical recovery (decode_server.py:3303): classify, then repair
        the minimum. TRANSIENT: nothing is torn down (an injected fault
        raised before its site's work), the next tick is the retry, after
        a backoff of transient_backoff_s doubling per retry, capped at 0.5
        s; a streak past `max_transient_retries` escalates to device-lost.
        POISON: the culpable slot's future fails with the exception and
        every other active slot is checkpointed and restored; a poison
        bound to no active slot escalates. DEVICE-LOST: every slot is
        checkpointed, the pool reset in place (`_reset_device_state`,
        which also clears the prefix index) and the checkpoints re-admitted
        at the head of the line in serial order; their replay re-derives
        the KV."""
        kind = classify_fault(exc)
        if kind == FAULT_TRANSIENT:
            self._transient_streak += 1
            if self._transient_streak <= self.max_transient_retries:
                self.transient_retries += 1
                if self._recorder is not None:
                    # Every recovery, a retry included, leaves a postmortem
                    # of the events leading up to the fault.
                    self._recorder.record(constants.FLIGHT_EV_TRANSIENT_RETRY,
                                          streak=self._transient_streak)
                    self._recorder.dump(FAULT_TRANSIENT)
                if self.metrics is not None:
                    self.metrics.inc("nos_tpu_decode_transient_retries")
                delay = min(0.5, self.transient_backoff_s * (2 ** (self._transient_streak - 1)))
                self._stop.wait(delay)
                return
            kind = FAULT_DEVICE_LOST  # retries exhausted: stop trusting it
        poison_slot = None
        if kind == FAULT_POISON:
            poison_slot = poison_slot_of(exc)
            if poison_slot is None or not self._slots[poison_slot].active:
                kind = FAULT_DEVICE_LOST
                poison_slot = None
        t_fault = time.monotonic()
        self.recoveries += 1
        checkpoints: List[SlotCheckpoint] = []
        for idx, slot in enumerate(self._slots):
            if not slot.active:
                continue
            if idx == poison_slot:
                if slot.future is not None and not slot.future.done():
                    slot.future.set_exception(exc)
                self.requests_poisoned += 1
                # The failed receipt and the trace's terminus (the release
                # folds its trailing slot-seconds into the closed receipt).
                self._close_receipt(slot, constants.RECEIPT_STATUS_FAILED, 0)
                if self._tracer is not None:
                    self._tracer.event(slot.trace_id, constants.TRACE_EV_FINISH, slot=idx,
                                       tokens=0, poisoned=1)
                if self.metrics is not None:
                    self.metrics.inc("nos_tpu_decode_requests_poisoned")
                self._release_slot(idx)
                continue
            ck = self._checkpoint_slot(idx)
            self._release_slot(idx)
            if ck is not None:
                checkpoints.append(ck)
        self._inflight.clear()
        self._pending_verifies.clear()
        self._reset_device_state()
        self._transient_streak = 0
        self._enqueue_restores([
            _Request(prompt=list(ck.prompt), max_new=ck.max_new, future=ck.future,
                     t_submit=ck.t_submit, replay=list(ck.generated), serial=ck.serial,
                     t_restore=t_fault, spec=ck.spec, tenant=ck.tenant, trace_id=ck.trace_id)
            for ck in checkpoints])
        self.slots_restored += len(checkpoints)
        if self._recorder is not None:
            # The postmortem: the ring's events leading up to this fault,
            # frozen per recovery under the classified kind.
            self._recorder.record(constants.FLIGHT_EV_RECOVERY, kind=kind,
                                  checkpoints=len(checkpoints),
                                  poison_slot=-1 if poison_slot is None else poison_slot)
            self._recorder.dump(kind)
        if self.metrics is not None:
            self.metrics.inc("nos_tpu_decode_recoveries", kind=kind)
            if checkpoints:
                self.metrics.inc("nos_tpu_decode_slots_restored", len(checkpoints))
        if not self._block_mgr.conserved():
            # A leaked block would wedge the pool invisibly: fail loudly
            # (`_run`'s backstop turns this into the fail-all sweep).
            raise RuntimeError("pool conservation violated after recovery")

    def _checkpoint_slot(self, idx: int) -> Optional[SlotCheckpoint]:
        """Slot `idx`'s host-recoverable state (decode_server.py:3434): its
        tokens so far (every ref materializes: a ref's copy to pinned host
        memory is queued when it is made, and no recovery frees it). None
        when the tokens already complete the request: its future resolves
        here, a finished request is never replayed."""
        slot = self._slots[idx]
        tokens = list(slot.replay) + self._materialize_tokens(slot)
        if self.eos_id is not None and self.eos_id in tokens:
            tokens = tokens[: tokens.index(self.eos_id) + 1]
            if slot.future is not None and not slot.future.done():
                slot.future.set_result(tokens)
                receipt = self._close_receipt(slot, constants.RECEIPT_STATUS_OK, len(tokens))
                self._trace_finish(idx, slot, len(tokens), receipt)
            return None
        if len(tokens) >= slot.max_new:
            if slot.future is not None and not slot.future.done():
                slot.future.set_result(tokens[: slot.max_new])
                receipt = self._close_receipt(slot, constants.RECEIPT_STATUS_OK, slot.max_new)
                self._trace_finish(idx, slot, slot.max_new, receipt)
            return None
        spec = slot.adapt.snapshot(len(slot.refs)) if slot.adapt is not None else None
        return SlotCheckpoint(
            prompt=list(slot.request_prompt or []), generated=tokens, max_new=slot.max_new,
            serial=int(self._slot_serial[idx]), t_submit=slot.t_submit,
            prefill_cursor=slot.prefill_cursor, spec=spec, tenant=slot.tenant,
            trace_id=slot.trace_id, future=slot.future)

    def _enqueue_restores(self, reqs: List[_Request]) -> None:
        """Restores re-enter at the head of the line (decode_server.py:
        3482), merged by serial with any restore already waiting there:
        the head is one serial-sorted restore region, fresh arrivals queue
        behind it."""
        head: List[_Request] = []
        while self._waiting and self._waiting[0].serial is not None:
            head.append(self._waiting.popleft())
        for req in sorted(head + list(reqs), key=lambda r: r.serial, reverse=True):
            self._waiting.appendleft(req)

    # -- elastic quotas (decode_server.py:3497-3608) ------------------------------
    def _preempt_slot(self, idx: int) -> None:
        """Quota-driven preemption (decode_server.py:3498): checkpoint the
        slot (the capture recovery takes; its refs, a burst's in flight
        too, materialize through their events), release its blocks to the
        host tier (one counted blocking copy-out per block, queued on the
        stream behind every window that wrote it), and re-queue the
        checkpoint in the restore region. The replay re-derives the KV
        through the budgeted prefill, usually from a revive of what was
        just spilled, and the client sees one uninterrupted stream."""
        slot = self._slots[idx]
        if not slot.active:
            return
        self._check_fault("preempt", idx)
        t0 = time.monotonic()
        if self._tracer is not None:
            self._tracer.event(slot.trace_id, constants.TRACE_EV_PREEMPT, slot=idx,
                               serial=int(self._slot_serial[idx]))
            self._tracer.event(slot.trace_id, constants.TRACE_EV_SPILL, slot=idx,
                               blocks=len(self._block_mgr.slot_blocks(idx)))
        if self._recorder is not None:
            self._recorder.record(constants.FLIGHT_EV_PREEMPT, slot=idx)
        ck = self._checkpoint_slot(idx)
        spills0 = self.spill_tier.spills if self.spill_tier is not None else 0
        self._release_slot(idx, spill=True)
        if self._cost is not None and self.spill_tier is not None:
            # The preemption's device->host bytes, billed to the preempted
            # stream: this engine's puts times the full-width payload size.
            moved = max(0, (self.spill_tier.spills - spills0) * self._bytes_per_block)
            if moved:
                self._cost.charge(slot.trace_id, slot.tenant or "", spill_bytes=moved)
        self.preemptions += 1
        if self.metrics is not None:
            self.metrics.inc("nos_tpu_decode_preemptions")
        if ck is None:
            return  # the capture already resolved the request
        self._enqueue_restores([
            _Request(prompt=list(ck.prompt), max_new=ck.max_new, future=ck.future,
                     t_submit=ck.t_submit, replay=list(ck.generated), serial=ck.serial,
                     t_restore=t0, spec=ck.spec, tenant=ck.tenant, trace_id=ck.trace_id)])

    def _enforce_quota(self) -> None:
        """The preemption side of elastic quotas, once a tick
        (decode_server.py:3566): if a starved tenant (observed share below
        its guaranteed min, not over its ceiling) has a request waiting
        that the engine cannot host now (no idle slot, or too few pool
        blocks), preempt borrower slots lowest-priority-first until it
        fits or no borrower is left."""
        if self._quota is None:
            return
        self._drain_queue()
        target = None
        for req in self._waiting:
            if self._quota.is_starved(req.tenant) and not self._quota.over_ceiling(req.tenant):
                target = req
                break
        if target is None:
            return
        full = len(target.prompt) + len(target.replay)
        eff_new = target.max_new - len(target.replay)
        needed = max(1, -(-(full + eff_new - 1) // self.block_size))
        if needed > self.total_blocks - 1:
            return  # unservable anyway; admission rejects it
        for _ in range(self.n_slots):
            if any(not s.active for s in self._slots) and self._block_mgr.available() >= needed:
                return
            victim = self._quota.select_victim(
                [(idx, s.tenant, int(self._slot_serial[idx]))
                 for idx, s in enumerate(self._slots) if s.active],
                target.tenant)
            if victim is None:
                return
            self._preempt_slot(victim)

    def _tick(self) -> None:
        """One engine iteration (decode_server.py:3610, :3639): (0) with a
        QuotaPolicy, quota enforcement may preempt borrower slots, (1)
        admission reserves slots and pages, (2) the prefill budget
        dispatches bounded chunk waves (and the copy-ins and COW copies
        ahead of them), (3) drafting slots get one verify dispatch, (4)
        every other decoding slot gets the K-step macro program, or, in a
        steady decode state, a burst of up to N of them in one dispatch.
        All of it is ordered on one stream over disjoint page sets. The
        only blocking reads are the oldest verify round's, when the
        drafting slots are the engine's sole possible progress, and a
        quota-armed burst's counts. With tracing armed every phase runs
        inside the TickProfiler (host clock reads only, never a device
        sync)."""
        prof = self._prof
        with _DEVICE_GATE.shared():
            prof.begin_tick()
            try:
                self._tick_phases(prof)
            finally:
                prof.end_tick(self.metrics)

    def _tick_phases(self, prof) -> None:
        if self._engine_idle and not self._pending_prewarm and self._queue.empty():
            # The idle fast path: the previous tick proved the engine empty
            # and only a submit (or a queued prewarm) can change that. O(1): the quota folds its
            # shared empty entry, nothing is published.
            self.idle_ticks += 1
            if self._quota is not None:
                self._quota.observe_idle_tick()
            with prof.phase(constants.TICK_PHASE_IDLE):
                self._stop.wait(0.005)
            return
        self._engine_idle = False
        with prof.phase(constants.TICK_PHASE_QUOTA_ENFORCE):
            self._enforce_quota()
        with prof.phase(constants.TICK_PHASE_ADMIT):
            self._admit()
        if self._pending_verifies:
            with prof.phase(constants.TICK_PHASE_RESOLVE):
                self._resolve_verifies(block=False)
        with prof.phase(constants.TICK_PHASE_EOS_SCAN):
            self._scan_eos()
        if not any(s.active for s in self._slots):
            self._note_quota_tick()
            if self._pending_prewarm:
                # No live traffic: the whole prefill budget goes to prewarm
                # copy-ins (decode_server.py:3670).
                with prof.phase(constants.TICK_PHASE_PUMP_PREFILL):
                    self._pump_prewarm(self.prefill_budget_tokens, 0)
            if self._store_shared:
                # Quiesced: publish the remaining cached blocks into the
                # fleet store in one sweep (decode_server.py:3676).
                self.store_published_blocks += self._block_mgr.publish_to_tier(0)
            self.idle_ticks += 1
            # The fast path arms only on a provably empty engine: a waiting
            # request needs the admission scan, a pending prewarm the pump.
            self._engine_idle = (not self._waiting and not self._pending_prewarm
                                 and self._queue.empty())
            with prof.phase(constants.TICK_PHASE_IDLE):
                self._stop.wait(0.005)
            return
        with prof.phase(constants.TICK_PHASE_PUMP_PREFILL):
            n_prefill = self._pump_prefill()
        n_drafting = 0
        if self.spec_k > 0:
            with prof.phase(constants.TICK_PHASE_DISPATCH_VERIFY):
                drafts = self._spec_drafts()
                if drafts:
                    # A blocking (spec_sync) history pass may have
                    # materialized a late eos: never verify a dead slot.
                    self._scan_eos()
                    drafts = {i: d for i, d in drafts.items() if self._slots[i].active}
                if drafts:
                    self._dispatch_verify(drafts)
                    n_drafting = len(drafts)
        macro = [
            i for i, s in enumerate(self._slots)
            if s.active and s.phase == "decoding" and not s.verifying
        ]
        n_burst = 0
        if macro:
            # Steady state? Fuse up to N macro windows into ONE burst
            # dispatch (the host crosses once per K*N tokens); any host
            # obligation degrades to the per-tick macro dispatch.
            n_burst = self._burst_plan(macro, n_prefill, n_drafting)
            if n_burst:
                with prof.phase(constants.TICK_PHASE_DISPATCH_BURST):
                    self._dispatch_burst(macro, n_burst)
            else:
                with prof.phase(constants.TICK_PHASE_DISPATCH_MACRO):
                    self._dispatch_macro(macro)
        if n_drafting and macro:
            self.both_dispatch_ticks += 1
        if n_prefill and macro:
            self.ticks_with_prefill_and_macro += 1
            if self.metrics is not None:
                self.metrics.inc("nos_tpu_decode_ticks_with_prefill_and_macro")
        if not n_drafting and not macro and not n_prefill:
            # Every active slot awaits its verify outcome: the one
            # blocking read.
            with prof.phase(constants.TICK_PHASE_RESOLVE):
                self._resolve_verifies(block=True)
        if self._store_shared:
            # The write-through publish (decode_server.py:3740): a bounded
            # number of indexed, still device-resident blocks a busy tick
            # go to the fleet store before this replica dies or drains;
            # the idle sweep publishes the rest.
            self.store_published_blocks += self._block_mgr.publish_to_tier(
                self._publish_per_tick)
        self._note_quota_tick()
        if self._cost is not None:
            self._note_cost_tick(n_burst if n_burst else 1)
        if self.metrics is not None:
            with prof.phase(constants.TICK_PHASE_PUBLISH):
                self._publish_gauges(n_drafting, len(macro))

    def _note_quota_tick(self) -> None:
        """Fold this tick's per-tenant decode tokens into the quota window
        (decode_server.py:3756), on every tick, idle ones included, so a
        ceiling-blocked tenant's share decays. A quota-armed burst folded
        its windows already, one tick each."""
        if self._quota is None:
            return
        if self._quota_burst_folded:
            self._quota_burst_folded = False
            self._tick_tokens = {}
            return
        self._quota.observe_tick(self._tick_tokens)
        self._tick_tokens = {}

    def _note_cost_tick(self, weight: int) -> None:
        """Charge each active slot's tenant `blocks held x weight`
        KV-block-ticks (decode_server.py:3773; `weight` = a burst's fused
        windows, else 1), an int8 pool under its own field."""
        w = max(1, int(weight))
        name = (constants.COST_KV_BLOCK_TICKS_INT8 if self._kv_quant
                else constants.COST_KV_BLOCK_TICKS)
        for idx, slot in enumerate(self._slots):
            if not slot.active:
                continue
            held = len(self._block_mgr.slot_blocks(idx)) * w
            if held:
                self.kv_block_ticks += held
                self._cost.charge(slot.trace_id, slot.tenant or "", **{name: held})

    def _pack_tick_state(self, for_table_only: bool = False) -> Optional[np.ndarray]:
        """The device-resident tick metadata packed from the host mirrors:
        ONE [n_slots, max_pages + 5] int32 array (table row, then pos /
        macro mask / serial / step / steps_left), or None when no host
        event dirtied it. The prefill programs read only the table. The
        packing is host work; `TickState.sync` uploads the array inside
        the dispatch that reads it."""
        st = self._tick_state
        if for_table_only:
            if not st.table_dirty:
                return None
        elif not st.dirty and not st.table_dirty:
            return None
        P = self.max_pages
        packed = np.zeros((self.n_slots, P + 5), dtype=np.int32)
        packed[:, :P] = self._table_np
        for i, s in enumerate(self._slots):
            packed[i, P] = s.pos
            packed[i, P + 1] = int(s.active and s.phase == "decoding" and not s.verifying)
            packed[i, P + 2] = self._slot_serial[i]
            packed[i, P + 3] = s.step_base + len(s.refs)
            packed[i, P + 4] = s.remaining if s.active else 0
        return packed

    def _sync_tick_state(self, for_table_only: bool = False) -> None:
        """Pack and upload the tick metadata in one call (outside a tick)."""
        self._tick_state.sync(self._pack_tick_state(for_table_only))

    def _burst_plan(self, macro: List[int], n_prefill: int, n_drafting: int = 0) -> int:
        """How many macro windows to fuse into one burst dispatch this tick
        (decode_server.py:3827): 0 = stay per-tick. Bursts engage only in a
        steady decode state: no prefill this tick, no slot drafting or
        awaiting a verify, every active slot decoding, no queued or
        waiting request, not stopping or draining, so every host event
        sees the per-tick engine. The count is capped at the work left
        (ceil(max remaining / K)), so lanes never coast through whole
        trailing windows, and a burst has at least 2. A spec-armed engine
        bursts only while every active slot holds every draft source in
        demotion cooldown, and then ends the burst by the earliest expiry
        (`AdaptiveSpec.denial_margin`)."""
        if self.burst_windows <= 1 or n_prefill or n_drafting or self._pending_verifies:
            return 0
        if self._closed.is_set() or self._stop.is_set():
            return 0
        # A scheduled injected fault keeps the engine per-tick, so every
        # site keeps its per-tick visit cadence.
        if self._fault_injector is not None and self._fault_injector.has_pending():
            return 0
        if self._waiting or not self._queue.empty():
            return 0
        active = [s for s in self._slots if s.active]
        if not active or len(macro) != len(active):
            return 0
        K = self.steps_per_dispatch
        max_rem = max(min(s.remaining, self.max_len - s.pos) for s in active)
        if max_rem <= 0:
            return 0
        n = min(self.burst_windows, -(-max_rem // K))
        if self.spec_k > 0:
            sources = self._spec_sources()
            margin = min(s.adapt.denial_margin(len(s.refs), sources) for s in active)
            if not margin:
                return 0  # some slot could draft right now
            n = min(n, margin // K)
        return n if n >= 2 else 0

    def _dispatch_burst(self, idxs: List[int], n_windows: int) -> None:
        """One burst (decode_server.py:3958): N macro windows, one host
        crossing. On CUDA each window is a replay of the captured window,
        on the CPU `_macro`; the eos carry spans the burst, so a lane that
        samples its eos mid-burst coasts on the scratch page for the rest
        of it. One `_TokRef` holds the [N*K, n_slots] token matrix (row =
        window*K + k). A lane executes contiguously from the burst's first
        row until it runs out, then coasts, so its rows are exactly
        range(total): one flat extend, the same arithmetic the windows
        applied on the device. With a QuotaPolicy each window's per-lane
        counts (`_win_counts`) are copied on the device into row w of
        `_burst_counts`, and after the burst the [N, n_slots] counts are
        read back in one counted blocking read and folded, one
        `observe_tick` per window (decode_server.py:4034-4049). A clean
        burst without a quota uploads nothing and reads nothing back."""
        self._check_fault("dispatch_burst", idxs[0])
        K = self.steps_per_dispatch
        packed = self._pack_tick_state()
        with self._prof.dispatch(DISPATCH_BURST):
            self._tick_state.sync(packed)
            self._finished.zero_()
            toks = torch.empty((n_windows * K, self.n_slots), dtype=torch.int32,
                               device=self.device)
            for w in range(n_windows):
                toks[w * K:(w + 1) * K].copy_(self._window())
                if self._quota is not None:
                    self._burst_counts[w].copy_(self._win_counts)
            ref = _TokRef(toks, self._syncs)
            counts = (_TokRef(self._burst_counts[:n_windows], self._syncs)
                      if self._quota is not None else None)
        self._inflight.append(ref)
        self.steps_run += 1
        self.burst_dispatches += 1
        self.burst_windows_run += n_windows
        if self._recorder is not None:
            self._recorder.record(constants.FLIGHT_EV_BURST, slots=len(idxs), windows=n_windows,
                                  k=K)
        if self.metrics is not None:
            self.metrics.inc("nos_tpu_decode_steps")
            self.metrics.inc("nos_tpu_decode_burst_dispatches")
            self.metrics.inc("nos_tpu_decode_burst_windows", n_windows)
        for idx in idxs:
            slot = self._slots[idx]
            if self._tracer is not None and not slot.trace_decoding:
                slot.trace_decoding = True
                self._tracer.event(slot.trace_id, constants.TRACE_EV_DECODE, slot=idx)
            total = min(n_windows * K, slot.remaining, self.max_len - slot.pos)
            slot.refs.extend((ref, idx, r) for r in range(total))
            slot.pos += total
            slot.remaining -= total
            self.macro_tokens_by_slot[idx] += total
            if total:
                tname = slot.tenant or ""
                self.tokens_by_tenant[tname] = self.tokens_by_tenant.get(tname, 0) + total
                if self._cost is not None:
                    self._cost.charge(slot.trace_id, tname, decode_tokens=total)
        if counts is not None:
            counts = counts.np()
            for w in range(n_windows):
                tick_tokens: Dict[str, int] = {}
                for idx in idxs:
                    n = int(counts[w, idx])
                    if n:
                        tenant = self._slots[idx].tenant or ""
                        tick_tokens[tenant] = tick_tokens.get(tenant, 0) + n
                self._quota.observe_tick(tick_tokens)
            self._quota_burst_folded = True
        for idx in idxs:
            self._finish_if_done(idx)
        self._backpressure()
        if self._checkpoint_hook is not None:
            # The burst boundary is the cheap capture cadence: the host is
            # crossing anyway, and every ref dispatched before this burst
            # can materialize.
            self._checkpoint_hook(self.checkpoint_snapshot())

    def _dispatch_macro(self, idxs: List[int]) -> None:
        """One K-step macro dispatch for the decoding slots. Inputs come
        from the device-resident TickState; the window advances pos / step
        / steps_left on the device, so steady-state dispatches upload
        nothing."""
        self._check_fault("dispatch_macro", idxs[0])
        K = self.steps_per_dispatch
        packed = self._pack_tick_state()
        with self._prof.dispatch(DISPATCH_MACRO):
            self._tick_state.sync(packed)
            self._finished.zero_()
            ref = _TokRef(self._window(), self._syncs)
        self._inflight.append(ref)
        self.steps_run += 1
        self.macro_dispatches += 1
        if self._recorder is not None:
            self._recorder.record(constants.FLIGHT_EV_MACRO, slots=len(idxs), k=K)
        if self.metrics is not None:
            self.metrics.inc("nos_tpu_decode_steps")
            self.metrics.inc("nos_tpu_decode_macro_dispatches")
        for idx in idxs:
            slot = self._slots[idx]
            if self._tracer is not None and not slot.trace_decoding:
                slot.trace_decoding = True
                self._tracer.event(slot.trace_id, constants.TRACE_EV_DECODE, slot=idx)
            executed = min(K, slot.remaining, self.max_len - slot.pos)
            for k in range(executed):
                slot.refs.append((ref, idx, k))
            slot.pos += executed
            slot.remaining -= executed
            self.macro_tokens_by_slot[idx] += executed
            if executed:
                tname = slot.tenant or ""
                self.tokens_by_tenant[tname] = self.tokens_by_tenant.get(tname, 0) + executed
                if self._cost is not None:
                    self._cost.charge(slot.trace_id, tname, decode_tokens=executed)
                if self._quota is not None:
                    self._tick_tokens[tname] = self._tick_tokens.get(tname, 0) + executed
            self._finish_if_done(idx)
        self._backpressure()

    def _backpressure(self) -> None:
        """Bound the dispatch queue; materializing the oldest in-flight
        window is (amortized) already-complete work."""
        while len(self._inflight) > self.pipeline_depth:
            self._inflight.popleft().np()

    # -- counters (read through to the BlockManager and the spill tier) ---------
    def expert_counts(self) -> Dict[str, int]:
        """The expert layers' tallies as host ints (one blocking read; 0
        for a dense config): `prefill_rows` / `decode_rows`, the (token,
        expert) rows routed by the prefill programs and by the decode
        ones, and `prefill_expert_hits` / `decode_expert_hits`, the
        (layer, call) pairs summed over the experts that got at least one
        row. A captured graph's replays add to them like eager calls."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        (pr, ph), (dr, dh) = self._expert_tally.tolist()
        return {"prefill_rows": pr, "prefill_expert_hits": ph,
                "decode_rows": dr, "decode_expert_hits": dh}

    @property
    def prefix_lookups(self) -> int:
        return self._block_mgr.lookups

    @property
    def prefix_hit_blocks(self) -> int:
        return self._block_mgr.hit_blocks

    @property
    def prefix_hit_tokens(self) -> int:
        """Prompt tokens served from cached blocks instead of prefill."""
        return self._block_mgr.hit_tokens

    @property
    def prefix_evictions(self) -> int:
        return self._block_mgr.evictions

    @property
    def prefix_cow_hits(self) -> int:
        """Admissions that staged a mid-block copy-on-write."""
        return self._block_mgr.cow_hits

    @property
    def prefix_cow_tokens(self) -> int:
        """Prompt tokens served by COW copies instead of recompute."""
        return self._block_mgr.cow_hit_tokens

    @property
    def output_blocks_registered(self) -> int:
        """Generated-token blocks keyed at request completion."""
        return self._block_mgr.output_blocks

    @property
    def radix_nodes(self) -> int:
        """Radix-tree size (0 in flat-chain mode), a gauge."""
        return self._block_mgr.radix_nodes()

    def prefix_keys(self) -> frozenset:
        """Chain keys resident in the prefix cache: device index and host
        tier."""
        return self._block_mgr.index_keys()

    @property
    def spills(self) -> int:
        """Blocks whose KV moved to the host tier instead of being lost."""
        return self.spill_tier.spills if self.spill_tier is not None else 0

    @property
    def revives(self) -> int:
        """Host-tier blocks copied back into device pages."""
        return self.spill_tier.revives if self.spill_tier is not None else 0

    @property
    def spill_drops(self) -> int:
        """Host-tier entries dropped under host-capacity pressure."""
        return self.spill_tier.drops if self.spill_tier is not None else 0

    @property
    def spill_host_bytes(self) -> int:
        return self.spill_tier.host_bytes if self.spill_tier is not None else 0

    @property
    def kv_quant_enabled(self) -> int:
        """1 when the pool stores int8 codes and per-block scales."""
        return int(self._kv_quant)

    @property
    def kv_pool_bytes(self) -> int:
        """Bytes of the logical paged pool (decode_server.py:4198-4213):
        every shard's K/V codes, and the scales once (each shard holds a
        copy of them). Shapes only, no device sync."""
        pools = self._pools()
        total = 0
        for s, pool in enumerate(pools):
            for layer in pool.values():
                for name, t in layer.items():
                    if name in ("k", "v") or s == 0:
                        total += t.numel() * t.element_size()
        return total

    # -- the fleet KV store's counters (decode_server.py:4215-4251): per
    # engine, 0 on a private tier. store_bytes and store_entries are gauges
    # of the one shared store, so a fleet merge sums N copies of them.
    @property
    def store_hits(self) -> int:
        """Revive reads the shared store served."""
        return getattr(self.spill_tier, "store_hits", 0)

    @property
    def store_misses(self) -> int:
        """Staged revives the store had retired meanwhile."""
        return getattr(self.spill_tier, "store_misses", 0)

    @property
    def store_puts(self) -> int:
        """Spills and publishes this engine put into the shared store."""
        return getattr(self.spill_tier, "store_puts", 0)

    @property
    def store_dedup_hits(self) -> int:
        """Puts that found the key already resident: N replicas, one copy."""
        return getattr(self.spill_tier, "store_dedup_hits", 0)

    @property
    def store_bytes(self) -> int:
        """Shared-store resident bytes (a gauge; 0 on a private tier)."""
        return self.spill_tier.host_bytes if self._store_shared else 0

    @property
    def store_entries(self) -> int:
        """Shared-store resident entries (a gauge)."""
        return len(self.spill_tier) if self._store_shared else 0

    @property
    def borrowed_ticks(self) -> int:
        """Ticks where a tenant ran above its guaranteed share
        (decode_server.py:4254)."""
        return self._quota.borrowed_ticks if self._quota is not None else 0

    @property
    def h2d_uploads(self) -> int:
        """Host->device transfers on the tick path (HostStage)."""
        return self._stage.uploads

    @property
    def blocking_syncs(self) -> int:
        """Blocking device->host reads on the tick path (SyncLedger)."""
        return self._syncs.syncs

    @property
    def staging_syncs(self) -> int:
        """Packed TickState uploads."""
        return self._tick_state.syncs

    # -- the tick profiler's read-throughs (decode_server.py:4283-4318): zeros
    # and empty without tracing, as in the reference -----------------------------
    @property
    def ticks_profiled(self) -> int:
        return self._prof.ticks

    @property
    def tick_wall_s(self) -> float:
        """Total measured wall time across profiled ticks."""
        return self._prof.tick_wall_s

    @property
    def tick_dispatch_s(self) -> float:
        """Host wall time inside program invocations. On CUDA that is
        issue time (a launch returns before its kernel runs), not device
        time."""
        return self._prof.dispatch_s

    @property
    def tick_host_overhead_s(self) -> float:
        """Tick wall minus dispatch time: the host's own scheduling and its
        blocking reads (`tick_read_wait_s`)."""
        return self._prof.host_overhead_s

    @property
    def tick_read_wait_s(self) -> float:
        """The part of `tick_host_overhead_s` the engine thread spent
        waiting on device->host reads (token refs materializing)."""
        return self._prof.read_wait_s

    @property
    def tick_phase_s(self) -> Dict[str, float]:
        """Per-phase exclusive wall totals (constants.TICK_PHASES)."""
        return dict(self._prof.phase_s)

    @property
    def host_overhead_samples(self) -> List[float]:
        return list(self._prof.host_overhead_samples)

    @property
    def dispatch_samples(self) -> List[float]:
        return list(self._prof.dispatch_samples)

    def _publish_gauges(self, n_drafting: int, n_macro: int) -> None:
        """Per-tick split, queue-depth and pool-state gauges, and the
        delta-mirrored counters of the spill tier, the policy and the
        staging ledgers (decode_server.py:4320; metrics registry only)."""
        m = self.metrics
        m.set_gauge("nos_tpu_decode_slots_drafting", n_drafting)
        m.set_gauge("nos_tpu_decode_slots_macro", n_macro)
        m.set_gauge("nos_tpu_decode_slots_prefilling",
                    sum(1 for s in self._slots if s.active and s.phase != "decoding"))
        m.set_gauge("nos_tpu_decode_inflight_dispatches", len(self._inflight))
        m.set_gauge("nos_tpu_decode_pending_verifies", len(self._pending_verifies))
        m.set_gauge("nos_tpu_decode_waiting_requests", len(self._waiting))
        m.set_gauge("nos_tpu_decode_tp_devices", self.tp)
        pool = self._block_mgr.counts()
        m.set_gauge("nos_tpu_decode_kv_blocks_free", pool["free"])
        m.set_gauge("nos_tpu_decode_kv_blocks_cached", pool["cached"])
        m.set_gauge("nos_tpu_decode_kv_blocks_shared", pool["shared"])
        m.set_gauge("nos_tpu_decode_kv_blocks_spilled", pool["spilled"])
        m.set_gauge("nos_tpu_decode_spill_host_bytes", self.spill_host_bytes)
        m.set_gauge("nos_tpu_decode_radix_nodes", self.radix_nodes)
        m.set_gauge("nos_tpu_decode_kv_quant_enabled", self.kv_quant_enabled)
        m.set_gauge("nos_tpu_decode_kv_quant_pool_bytes", self.kv_pool_bytes)
        if self._store_shared:
            m.set_gauge("nos_tpu_fleet_kv_store_bytes", self.store_bytes)
            m.set_gauge("nos_tpu_fleet_kv_store_entries", self.store_entries)
        for name, cur in (
            ("nos_tpu_decode_spills", self.spills),
            ("nos_tpu_decode_revives", self.revives),
            ("nos_tpu_decode_spill_drops", self.spill_drops),
            ("nos_tpu_fleet_kv_store_hits", self.store_hits),
            ("nos_tpu_fleet_kv_store_misses", self.store_misses),
            ("nos_tpu_fleet_kv_store_puts", self.store_puts),
            ("nos_tpu_fleet_kv_store_dedup_hits", self.store_dedup_hits),
            ("nos_tpu_fleet_kv_prewarm_tokens", self.prewarm_tokens),
            ("nos_tpu_fleet_kv_failover_revive_tokens", self.failover_revive_tokens),
            ("nos_tpu_decode_borrowed_ticks", self.borrowed_ticks),
            ("nos_tpu_decode_h2d_uploads", self.h2d_uploads),
            ("nos_tpu_decode_blocking_syncs", self.blocking_syncs),
            ("nos_tpu_decode_staging_syncs", self.staging_syncs),
            ("nos_tpu_decode_idle_ticks", self.idle_ticks),
        ):
            prev = self._metric_shadow.get(name, 0)
            if cur > prev:
                m.inc(name, cur - prev)
                self._metric_shadow[name] = cur


def _params_to(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _params_to(v, device) for k, v in tree.items()}
    return tree.to(device)
