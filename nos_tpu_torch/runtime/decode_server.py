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
drafts verified through `paged_verify_window`), and eos handling. The
constructor keeps the reference's signature; every argument that would
arm a feature not yet ported (quotas, fault injection and recovery,
tracing, the cost ledger, the fleet KV store) raises
NotImplementedError naming its ROADMAP item, with a mesh or without. An
exception on the tick path fails every outstanding request and resets the
pool (the reference's `surgical_recovery=False` behaviour).

PyTorch in place of JAX: the programs write the pool in place on one CUDA
stream, whose ordering replaces JAX's donation chain. The reference jits
its K-step window (`_macro`); here, on CUDA, the constructor captures the
window once as a CUDA graph (`_WindowGraph`) over fixed device state (the
pool, the TickState buffers, the last-token and eos-carry vectors), and
every macro dispatch and every window of a burst replays it. Prefill runs
eagerly, and so do verify rounds and the spill tier's copies, which write
the pool in place: a verify round moves a drafting slot's `pos` on the
host, and the next packed sync carries it into the TickState buffers the
graph reads. On the CPU the same `_macro` runs eagerly as the window.
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

import gc
import logging
import queue
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future
from contextlib import contextmanager
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
from nos_tpu_torch.ops import decode_attention, flash_attention, paged_attention
from nos_tpu_torch.ops import quantized_kv as qkv
from nos_tpu_torch.parallel.mesh import canonical_device
from nos_tpu_torch.runtime.block_manager import BlockManager
from nos_tpu_torch.runtime.spill import SpillTier
from nos_tpu_torch.runtime.staging import HostStage, SyncLedger, TickState

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
    engine's `blocking_syncs` ledger when they materialize."""

    __slots__ = ("_arr", "_event", "_np", "_ledger")

    def __init__(self, arr: torch.Tensor, ledger: Optional[SyncLedger] = None):
        self._np = None
        self._event = None
        self._ledger = ledger
        if arr.device.type == "cuda":
            host = torch.empty(arr.shape, dtype=arr.dtype, pin_memory=True)
            host.copy_(arr, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
            arr = host
        self._arr = arr

    def np(self) -> np.ndarray:
        if self._np is None:
            if self._ledger is not None:
                self._ledger.note()
            if self._event is not None:
                self._event.synchronize()
            self._np = self._arr.numpy()
            self._arr = None
            self._event = None
        return self._np

    def is_ready(self) -> bool:
        return self._np is not None or self._event is None or self._event.query()


def _launch_counts() -> Dict[tuple, int]:
    """Every kernel wrapper's launch count, keyed (ops module, entry
    point, route); LAUNCHES[name] is the sum over its routes."""
    counts = {}
    for mod in (decode_attention, flash_attention, paged_attention):
        for entry, routes in mod.ROUTE_LAUNCHES.items():
            for route, n in routes.items():
                counts[(mod, entry, route)] = n
    return counts


def _add_launches(delta: Dict[tuple, int]) -> None:
    for (mod, entry, route), n in delta.items():
        mod.LAUNCHES[entry] += n
        mod.ROUTE_LAUNCHES[entry][route] += n


class _WindowGraph:
    """The engine's K-step decode window as one CUDA graph: the reference's
    `jax.jit` of `_macro` (decode_server.py:1067), on the H100.

    `body()` runs the window over the engine's fixed device state and
    returns its [K, n_slots] token window. At construction it runs once
    eagerly on the current stream, with every lane masked (the caller's
    state), which builds and loads the kernels, allocates the split decode
    kernels' counters and the kept constants (rope frequencies, sampler
    floats), and writes only the scratch page; then it is captured on a
    side stream in "thread_local" mode, so client threads may submit
    meanwhile. A capture or replay failure raises.

    Before the capture the cyclic collector runs, and it stays off while
    the capture lasts: a dead engine in a reference cycle still holds its
    own graph, pool and pinned buffers, and freeing those inside a capture
    invalidates it (torch's capture no longer collects first).

    A kernel wrapper counts its launch when its Python runs, so the
    capture's counts are taken back and kept as the graph's `delta`, and
    each replay adds the delta: launch counts stay true under replay."""

    def __init__(self, body, device: torch.device):
        with torch.cuda.device(device):
            body()  # warm-up
            before = _launch_counts()
            self._graph = torch.cuda.CUDAGraph()
            # A side stream of this card (torch's shared capture stream
            # lives on whichever card first made it).
            side = torch.cuda.Stream(device)
            collecting = gc.isenabled()
            gc.collect()
            gc.disable()
            try:
                with torch.cuda.graph(self._graph, stream=side,
                                      capture_error_mode="thread_local"):
                    self._out = body()
            finally:
                if collecting:
                    gc.enable()
        after = _launch_counts()
        self.delta = {k: n - before[k] for k, n in after.items() if n != before[k]}
        _add_launches({k: -n for k, n in self.delta.items()})

    def replay(self) -> torch.Tensor:
        """Replay on the current stream; returns the graph's token buffer,
        which the next replay rewrites."""
        self._graph.replay()
        _add_launches(self.delta)
        return self._out


@dataclass
class _Request:
    """One queued/waiting request."""

    prompt: list
    max_new: int
    future: Future
    t_submit: float


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
    # The client's prompt: what a finished request registers its output
    # blocks under (radix mode).
    request_prompt: Optional[list] = None
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


@dataclass
class _PendingVerify:
    """One in-flight verify dispatch: the device-held argmax predictions
    [n_slots, spec_k + 1], each drafting slot's dispatched window, and the
    source that drafted it."""

    preds: _TokRef
    windows: Dict[int, list]
    sources: Dict[int, str]


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
        surgical_recovery: bool = False,
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
        Outputs are identical for any K, N, budget, prefix, radix, spill
        and speculation setting. `kv_dtype="int8"` stores the pool as int8
        codes with one f32 scale per (block, layer, k|v): about half the
        pool's and every spill payload's bytes, its divergence from the
        native pool bounded by `runtime/divergence.py`.

        On CUDA the constructor captures the K-step window as a CUDA graph
        (`_WindowGraph`) that every window replays (`graph_replays`
        counts them). A mesh whose shards all lie on the engine's device
        is captured whole, every shard in one graph; a mesh over distinct
        cards (never run yet) runs its windows eagerly, as the CPU does."""
        if kv_dtype not in constants.KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of {constants.KV_DTYPES}: {kv_dtype!r}")
        # (armed?, what it arms, its item in ROADMAP.md queue A)
        armed = [
            (quota is not None, "tenant quotas", "Fleet"),
            (fault_injector is not None or bool(surgical_recovery),
             "fault injection and surgical recovery", "Fleet"),
            (checkpoint_hook is not None, "the checkpoint hook", "Fleet"),
            (metrics is not None or tracing is not None, "metrics and tracing", "Fleet"),
            (cost_ledger is not None, "the cost ledger", "Fleet"),
            (kv_store is not None, "the fleet KV store", "Fleet"),
        ]
        for on, feature, item in armed:
            if on:
                raise NotImplementedError(
                    f"{feature} is not ported to PyTorch yet "
                    f"(ROADMAP.md queue A: {item})"
                )
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
        self._stage = HostStage(self.device)
        self._syncs = SyncLedger()
        self._tick_state = TickState(self._stage, n_slots, self.max_pages,
                                     mesh=self._mesh, tp_axis=tp_axis)
        self._table_np = np.zeros((n_slots, self.max_pages), dtype=np.int32)
        self.prefix_cache = bool(prefix_cache)
        self.radix_cache = bool(radix_cache) and self.prefix_cache
        # An int8 pool salts the chain keys with its payload dtype, so the
        # two formats never alias each other's blocks (decode_server.py:768).
        self._block_mgr = BlockManager(self.total_blocks, self.block_size, n_slots,
                                       radix=self.radix_cache,
                                       key_salt=kv_dtype + ":" if self._kv_quant else "")
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
        if int(spill_blocks) > 0:
            self.spill_tier = SpillTier(int(spill_blocks) * self._bytes_per_block)
            # A weak reader: the manager must not keep the engine, and with
            # it the pool's device memory, alive in a reference cycle.
            reader = weakref.WeakMethod(self._extract_block)
            self._block_mgr.attach_spill(self.spill_tier, lambda block: reader()(block))
        #: Tier payloads refused for a wire format this pool cannot take.
        self.kv_quant_payload_rejected = 0
        self._waiting: Deque[_Request] = deque()
        self._queue: "queue.Queue" = queue.Queue()
        self._slots = [_Slot() for _ in range(n_slots)]
        # The step-feed vector (each lane's last token) and the burst's eos
        # carry: fixed buffers the window reads and writes in place.
        self._last_dev = torch.zeros((n_slots,), dtype=torch.int32, device=self.device)
        self._finished = torch.zeros((n_slots,), dtype=torch.bool, device=self.device)
        self._first_dev = torch.zeros((n_slots,), dtype=torch.int32, device=self.device)
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
        #: Host wall seconds per tick phase (constants.TICK_PHASES).
        self.tick_phase_s: Dict[str, float] = {p: 0.0 for p in constants.TICK_PHASES}
        self._phase_nested: List[float] = []
        # Per-slot sampling identity: (serial of the request in the slot,
        # step within the request), riding in the packed tick state. Serials
        # make streams independent of slot reuse order.
        self._slot_serial = np.zeros((n_slots,), dtype=np.int64)
        self._next_serial = 1
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
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
        #: CUDA graphs captured, and windows run as a graph replay.
        self.graph_captures = 0
        self.graph_replays = 0
        self._graph: Optional[_WindowGraph] = None
        shard_devices = (self._tp.devices if self._tp is not None else [self.device])
        if self.device.type == "cuda" and all(
                canonical_device(d) == canonical_device(self.device) for d in shard_devices):
            self._graph = _WindowGraph(self._macro, self.device)
            self.graph_captures += 1

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
    def _extract(self, block: int) -> tuple:
        """One block's tensors on the engine's device: (k, v), or for an
        int8 pool (k, v, k_scale, v_scale) through the funnel module."""
        L = self.cfg.layers
        if self._kv_quant:
            parts = [qkv.extract_block(pool, block, L) for pool in self._pools()]
        else:
            parts = [tuple(torch.stack([pool[str(i)][name][block] for i in range(L)])
                           for name in ("k", "v")) for pool in self._pools()]
        if len(parts) == 1:
            return parts[0]
        codes = tuple(torch.cat([p[j].to(self.device) for p in parts], dim=1)
                      for j in range(2))
        return codes + parts[0][2:]

    def _revive(self, tensors: tuple, block: int) -> None:
        """Copy a block's full-width tensors (as `_extract` returns them, on
        the engine's device) into `block`."""
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
        tensors = self._extract(block)
        self._syncs.note()
        tensors = tuple(t.cpu() for t in tensors)
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        if self._kv_quant:
            return (constants.KV_DTYPE_INT8,) + tensors, nbytes
        return tensors, nbytes

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
            return False
        tensors = payload[1:] if self._kv_quant else payload
        self._revive(tuple(self._stage.to_device(t) for t in tensors), block)
        return True

    def _table(self):
        """The tick state's block table as the programs take it: one tensor,
        or one per shard."""
        st = self._tick_state
        return st.table if self._tp is None else st.tables

    def _table_row(self, table, idx: int):
        return table[idx] if self._tp is None else [t[idx] for t in table]

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
        takes the last tokens and the TickState's pos / step / steps_left
        advance by the same min(K, steps_left, max_len - pos) the host
        bookkeeping mirrors."""
        st = self._tick_state
        K = self.steps_per_dispatch
        token = self._last_dev
        table = self._table()
        toks = []
        for k in range(K):
            pos_k = st.pos + k
            mask = st.mask & (k < st.steps_left) & (pos_k < self.max_len)
            if self.eos_id is not None:
                mask = mask & ~self._finished
            logits, _ = paged_decode_step(
                self.params, token, self.cfg, self.cache, table, pos_k, mask,
                self.block_size, tp=self._tp,
            )
            nxt = self._sample(logits, st.serial, st.step + k)
            token = torch.where(mask, nxt, token)
            toks.append(torch.where(mask, nxt, 0))
            if self.eos_id is not None:
                self._finished |= mask & (nxt == self.eos_id)
        execd = torch.where(
            st.mask,
            torch.clamp(torch.minimum(st.steps_left, self.max_len - st.pos), 0, K),
            0,
        ).to(st.pos.dtype)
        self._last_dev.copy_(token)
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

    def _prefill_chunk(self, tokens, table_row, start: int, length: int) -> None:
        paged_prefill_chunk(
            self.params, tokens, self.cfg, self.cache, table_row, start, length,
            self.block_size, with_logits=False, tp=self._tp,
        )

    def _prefill_last(self, tokens, table_row, start: int, length: int, slot: int) -> None:
        """The final chunk: sample the first token at the true last prompt
        position and scatter it into the step-feed vector and into this
        wave's first-token vector (cloned per wave by the caller: earlier
        waves' refs still hold the previous one)."""
        logits, _ = paged_prefill_chunk(
            self.params, tokens, self.cfg, self.cache, table_row, start, length,
            self.block_size, tp=self._tp,
        )
        serial = torch.full((1,), int(self._slot_serial[slot]), dtype=torch.int64,
                            device=self.device)
        first = self._sample(logits[length - 1][None, :], serial,
                             torch.zeros_like(serial))[0]
        self._last_dev[slot] = first
        self._first_dev[slot] = first

    def _prefill_window(self, tokens, table, pos, lengths, active) -> None:
        paged_prefill_window(
            self.params, tokens, self.cfg, self.cache, table, pos, lengths, active,
            self.block_size, tp=self._tp,
        )

    # -- client side -----------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new: int = 16) -> Future:
        """Queue one request; thread-safe. Raises RuntimeError once the
        engine has stopped (or begun draining)."""
        if self._closed.is_set():
            raise RuntimeError(
                "DecodeServer is stopped (or draining): submit() after stop() "
                "would strand the request"
            )
        fut: Future = Future()
        if max_new <= 0:
            fut.set_result([])
            return fut
        self._note_accepted(fut)
        self._queue.put(_Request(list(prompt), max_new, fut, time.monotonic()))
        return fut

    def generate(self, prompt: Sequence[int], max_new: int = 16, timeout=None):
        return self.submit(prompt, max_new).result(timeout=timeout)

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

    def _has_outstanding(self) -> bool:
        with self._accept_lock:
            self._accepted = [f for f in self._accepted if not f.done()]
            return bool(self._accepted)

    def _fail_outstanding(self, exc: Exception) -> None:
        for idx, slot in enumerate(self._slots):
            if slot.future is not None and not slot.future.done():
                slot.future.set_exception(exc)
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

    def _release_slot(self, idx: int) -> None:
        """Return the slot's page references to the pool (shared blocks only
        decrement; refcount-0 indexed blocks retire to the cached-free LRU)
        and clear its lane. Claimed revives not yet copied die with it."""
        slot = self._slots[idx]
        if slot.pending_revives and self.spill_tier is not None:
            self.spill_tier.unstage([k for _, _, k in slot.pending_revives])
        self._block_mgr.release(idx)
        self._slots[idx] = _Slot()
        self._tick_state.mark_table_dirty()

    def _reset_device_state(self) -> None:
        """After an engine error the pool is untrustworthy: zero it (an int8
        pool's scales too), and the token vectors, in place (the reference
        reallocates them; the captured window holds their addresses)."""
        for pool in self._pools():
            for layer in pool.values():
                for t in layer.values():
                    t.zero_()
        self._table_np[:] = 0
        self._tick_state.mark_table_dirty()
        # The device index dies with the pool; host payloads survive.
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
        request."""
        for idx, slot in enumerate(self._slots):
            if slot.active:
                continue
            while True:
                req = self._next_request()
                if req is None:
                    return
                prompt = req.prompt
                if len(prompt) >= self.max_len:
                    req.future.set_exception(
                        ValueError(f"prompt length {len(prompt)} >= max_len {self.max_len}")
                    )
                    continue
                if len(prompt) + req.max_new - 1 > self.max_len:
                    # The request cannot complete inside the per-sequence
                    # window: reject rather than resolve with fewer tokens.
                    req.future.set_exception(
                        ValueError(
                            f"prompt length {len(prompt)} + max_new {req.max_new} "
                            f"exceeds max_len {self.max_len}: output would be truncated"
                        )
                    )
                    continue
                # The cache holds positions 0..len+max_new-2 (the final
                # sampled token is never re-attended).
                n_blocks = max(1, -(-(len(prompt) + req.max_new - 1) // self.block_size))
                if n_blocks > self.total_blocks - 1:
                    req.future.set_exception(
                        ValueError(
                            f"request needs {n_blocks} KV blocks; the pool has "
                            f"{self.total_blocks - 1}"
                        )
                    )
                    continue
                admitted = self._block_mgr.admit(
                    idx, prompt, n_blocks, use_cache=self.prefix_cache
                )
                if admitted is None:
                    # Pool exhausted: wait, FIFO head-of-line.
                    self._waiting.appendleft(req)
                    return
                break
            blocks, n_hit = admitted
            self._table_np[idx, :] = 0
            self._table_np[idx, : len(blocks)] = blocks
            self._tick_state.mark_table_dirty()
            self._slot_serial[idx] = self._next_serial
            self._next_serial += 1
            slot.phase = "reserved"
            slot.future = req.future
            slot.request_prompt = prompt
            slot.pending_prompt = prompt
            # Prefix hits are already in the page table: the cursor starts
            # at the first miss (always below the last-token block).
            slot.prefill_cursor = n_hit * self.block_size
            # Host-tier hits right behind the device run, to copy in
            # (_pump_revives), then the diverging block's shared head, to
            # copy (_pump_cow), both instead of recomputing them.
            slot.pending_revives = self._block_mgr.claim_revives(idx)
            slot.pending_cow = self._block_mgr.claim_cow(idx)
            slot.t_submit = req.t_submit
            slot.pos = slot.prefill_cursor
            slot.remaining = req.max_new - 1
            slot.refs = []
            slot.eos_scanned = 0
            if self.spec_k > 0:
                slot.prompt = list(prompt)
                slot.adapt = AdaptiveSpec()
            slot.active = True
            self.queue_wait_s.append(time.monotonic() - req.t_submit)

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
                    with self._phase(constants.TICK_PHASE_PUMP_REVIVES):
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
            payload = self.spill_tier.take(key)
            if payload is None or not self._dispatch_revive(payload, block):
                self.spill_tier.unstage([k for _, _, k in slot.pending_revives[1:]])
                slot.pending_revives = []
                break
            self._tick_state.mark_dirty()
            slot.pending_revives.pop(0)
            slot.prefill_cursor = start + cost
            slot.pos = slot.prefill_cursor
            if slot.phase == "reserved":
                slot.phase = "prefilling"
            copies += 1
            used += cost
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
        if src is not None:
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
        return 1, n

    def _dispatch_prefill_wave(self, wave: List[Tuple[int, int, list]]) -> int:
        """Dispatch one wave. Mid-prompt chunks sharing a bucket go through
        the batched multi-slot window program; a singleton mid chunk keeps
        the batch-1 program. Final chunks always go through the per-slot
        `_prefill_last`, which samples the first token."""
        self._sync_tick_state(for_table_only=True)
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
                idx, start, piece = entries[0]
                padded = np.zeros((1, bucket), dtype=np.int32)
                padded[0, : len(piece)] = piece
                self._prefill_chunk(
                    self._stage.to_device(padded), self._table_row(table, idx), start,
                    len(piece),
                )
            else:
                tokens = np.zeros((self.n_slots, bucket), dtype=np.int32)
                pos = np.zeros((self.n_slots,), dtype=np.int32)
                lengths = np.zeros((self.n_slots,), dtype=np.int32)
                active = np.zeros((self.n_slots,), dtype=bool)
                for idx, start, piece in entries:
                    tokens[idx, : len(piece)] = piece
                    pos[idx] = start
                    lengths[idx] = len(piece)
                    active[idx] = True
                self._prefill_window(
                    self._stage.to_device(tokens),
                    table,
                    self._stage.to_device(pos),
                    self._stage.to_device(lengths),
                    self._stage.to_device(active),
                )
                self.prefill_window_dispatches += 1
            dispatches += 1
        if finals:
            self._first_dev = self._first_dev.clone()
        for idx, start, piece in finals:
            padded = np.zeros((1, self._bucket(len(piece))), dtype=np.int32)
            padded[0, : len(piece)] = piece
            self._prefill_last(
                self._stage.to_device(padded), self._table_row(table, idx), start,
                len(piece), idx,
            )
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
            # Full prompt blocks behind the dispatched cursor become
            # shareable; a later same-prefix chunk runs after this wave on
            # the same stream, so its reads see these writes.
            self._block_mgr.note_progress(idx, slot.prefill_cursor)
        if finals:
            # ONE ref over the wave's first-token vector for every slot
            # finishing in this wave: a single device->host transfer.
            now = time.monotonic()
            ref = _TokRef(self._first_dev, self._syncs)
            for idx, _, _ in finals:
                slot = self._slots[idx]
                slot.phase = "decoding"
                slot.pos = len(slot.pending_prompt)
                slot.pending_prompt = None
                slot.refs.append((ref, idx, None))
                self.ttft_s.append(now - slot.t_submit)
                self._finish_if_done(idx)
        self.prefill_dispatches += dispatches
        return dispatches

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
        before a late EOS was scanned)."""
        tokens = self._materialize_tokens(slot)
        if self.eos_id is not None and self.eos_id in tokens:
            tokens = tokens[: tokens.index(self.eos_id) + 1]
        return tokens

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
            self._release_slot(idx)

    def _register_output(self, idx: int, slot: _Slot, out: List[int]) -> None:
        """Radix mode (decode_server.py:2942): key the finished request's
        generated-token blocks, so a follow-up turn re-submitting `history
        + new tokens` walks the tree to the end of the history. Runs just
        before the release, so those blocks retire to the cached LRU."""
        if self.radix_cache:
            self._block_mgr.register_output(idx, list(slot.request_prompt or []) + out)

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
            if source == SOURCE_TREE:
                self.spec_tree_rounds += 1
            else:
                self.spec_history_rounds += 1
        # The drafting flags changed the macro mask: the verify's read of
        # `pos` and this tick's window consume one freshly packed state.
        self._tick_state.mark_dirty()
        self._sync_tick_state()
        logits, _ = paged_verify_window(
            self.params, self._stage.to_device(tokens), self.cfg, self.cache, self._table(),
            self._tick_state.pos, self._stage.to_device(lengths),
            self._stage.to_device(active), self.block_size, tp=self._tp,
        )
        self.steps_run += 1
        self.spec_rounds += 1
        self._pending_verifies.append(
            _PendingVerify(_TokRef(greedy(logits), self._syncs), windows, sources))

    def _resolve_verifies(self, block: bool) -> None:
        """Fold completed verify rounds into slot state, oldest first: only
        rounds whose predictions are ready, or with `block` the oldest one
        (used only when the drafting slots are the engine's sole possible
        progress; at most one blocking read a call)."""
        while self._pending_verifies:
            entry = self._pending_verifies[0]
            if not block and not entry.preds.is_ready():
                return
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
            if len(window) > 1 and slot.adapt.observe(
                    len(window) - 1, len(accepted) - 1, len(slot.refs), source):
                self.spec_demotions += 1
                if source == SOURCE_TREE:
                    self.spec_tree_demotions += 1
                else:
                    self.spec_history_demotions += 1
            rows.append(idx)
            vals.append(accepted[-1])
            if self.eos_id is not None and self.eos_id in accepted:
                slot.remaining = 0  # _finalize truncates at the eos
            self._finish_if_done(idx)
        if rows:
            with self._phase(constants.TICK_PHASE_SAMPLE_SCATTER):
                self._last_dev[self._stage.to_device(rows, dtype=torch.long)] = (
                    self._stage.to_device(vals, dtype=torch.int32))

    # -- the tick ----------------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._tick()
            except Exception as exc:  # noqa: BLE001 — every request fails, the pool resets
                logger.exception("decode engine step failed")
                self._fail_outstanding(exc)
                self._reset_device_state()

    @contextmanager
    def _phase(self, name: str):
        """Time a tick phase, exclusive of the phases nested in it."""
        t0 = time.perf_counter()
        self._phase_nested.append(0.0)
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.tick_phase_s[name] += dt - self._phase_nested.pop()
            if self._phase_nested:
                self._phase_nested[-1] += dt

    def _tick(self) -> None:
        """One engine iteration (decode_server.py:3610, :3639): (1)
        admission reserves slots and pages, (2) the prefill budget
        dispatches bounded chunk waves (and the copy-ins and COW copies
        ahead of them), (3) drafting slots get one verify dispatch, (4)
        every other decoding slot gets the K-step macro program, or, in a
        steady decode state, a burst of up to N of them in one dispatch.
        All of it is ordered on one stream over disjoint page sets. The
        only blocking read is the oldest verify round's, when the drafting
        slots are the engine's sole possible progress."""
        if self._engine_idle and self._queue.empty():
            # The previous tick proved the engine empty; only a submit can
            # change that.
            with self._phase(constants.TICK_PHASE_IDLE):
                self._stop.wait(0.005)
            return
        self._engine_idle = False
        with self._phase(constants.TICK_PHASE_ADMIT):
            self._admit()
        if self._pending_verifies:
            with self._phase(constants.TICK_PHASE_RESOLVE):
                self._resolve_verifies(block=False)
        with self._phase(constants.TICK_PHASE_EOS_SCAN):
            self._scan_eos()
        if not any(s.active for s in self._slots):
            self._engine_idle = not self._waiting and self._queue.empty()
            with self._phase(constants.TICK_PHASE_IDLE):
                self._stop.wait(0.005)
            return
        with self._phase(constants.TICK_PHASE_PUMP_PREFILL):
            n_prefill = self._pump_prefill()
        n_drafting = 0
        if self.spec_k > 0:
            with self._phase(constants.TICK_PHASE_DISPATCH_VERIFY):
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
        if macro:
            # Steady state? Fuse up to N macro windows into ONE burst
            # dispatch (the host crosses once per K*N tokens); any host
            # obligation degrades to the per-tick macro dispatch.
            n_burst = self._burst_plan(macro, n_prefill, n_drafting)
            if n_burst:
                with self._phase(constants.TICK_PHASE_DISPATCH_BURST):
                    self._dispatch_burst(macro, n_burst)
            else:
                with self._phase(constants.TICK_PHASE_DISPATCH_MACRO):
                    self._dispatch_macro(macro)
        if n_drafting and macro:
            self.both_dispatch_ticks += 1
        if n_prefill and macro:
            self.ticks_with_prefill_and_macro += 1
        if not n_drafting and not macro and not n_prefill:
            # Every active slot awaits its verify outcome: the one
            # blocking read.
            with self._phase(constants.TICK_PHASE_RESOLVE):
                self._resolve_verifies(block=True)

    def _sync_tick_state(self, for_table_only: bool = False) -> None:
        """Re-sync the device-resident tick metadata from the host mirrors:
        ONE packed [n_slots, max_pages + 5] int32 upload (table row, then
        pos / macro mask / serial / step / steps_left), only when a host
        event dirtied it. The prefill programs read only the table."""
        st = self._tick_state
        if for_table_only:
            if not st.table_dirty:
                return
        elif not st.dirty and not st.table_dirty:
            return
        P = self.max_pages
        packed = np.zeros((self.n_slots, P + 5), dtype=np.int32)
        packed[:, :P] = self._table_np
        for i, s in enumerate(self._slots):
            packed[i, P] = s.pos
            packed[i, P + 1] = int(s.active and s.phase == "decoding" and not s.verifying)
            packed[i, P + 2] = self._slot_serial[i]
            packed[i, P + 3] = len(s.refs)
            packed[i, P + 4] = s.remaining if s.active else 0
        st.sync(packed)

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
        # A8 (fleet): a scheduled injected fault keeps the tick per-tick.
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
        applied on the device. A clean burst uploads nothing and reads
        nothing back."""
        self._sync_tick_state()
        K = self.steps_per_dispatch
        self._finished.zero_()
        toks = torch.empty((n_windows * K, self.n_slots), dtype=torch.int32,
                           device=self.device)
        for w in range(n_windows):
            toks[w * K:(w + 1) * K].copy_(self._window())
        ref = _TokRef(toks, self._syncs)
        self._inflight.append(ref)
        self.steps_run += 1
        self.burst_dispatches += 1
        self.burst_windows_run += n_windows
        for idx in idxs:
            slot = self._slots[idx]
            total = min(n_windows * K, slot.remaining, self.max_len - slot.pos)
            slot.refs.extend((ref, idx, r) for r in range(total))
            slot.pos += total
            slot.remaining -= total
        # A8 (fleet): the per-window quota fold and the checkpoint hook at
        # the burst boundary.
        for idx in idxs:
            self._finish_if_done(idx)
        self._backpressure()

    def _dispatch_macro(self, idxs: List[int]) -> None:
        """One K-step macro dispatch for the decoding slots. Inputs come
        from the device-resident TickState; the window advances pos / step
        / steps_left on the device, so steady-state dispatches upload
        nothing."""
        self._sync_tick_state()
        K = self.steps_per_dispatch
        self._finished.zero_()
        ref = _TokRef(self._window(), self._syncs)
        self._inflight.append(ref)
        self.steps_run += 1
        self.macro_dispatches += 1
        for idx in idxs:
            slot = self._slots[idx]
            executed = min(K, slot.remaining, self.max_len - slot.pos)
            for k in range(executed):
                slot.refs.append((ref, idx, k))
            slot.pos += executed
            slot.remaining -= executed
            self._finish_if_done(idx)
        self._backpressure()

    def _backpressure(self) -> None:
        """Bound the dispatch queue; materializing the oldest in-flight
        window is (amortized) already-complete work."""
        while len(self._inflight) > self.pipeline_depth:
            self._inflight.popleft().np()

    # -- counters (read through to the BlockManager and the spill tier) ---------
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


def _params_to(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _params_to(v, device) for k, v in tree.items()}
    return tree.to(device)
