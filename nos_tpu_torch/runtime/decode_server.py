"""DecodeServer: continuous batching for autoregressive LLM serving.

Port of the engine core of `nos_tpu/runtime/decode_server.py` (:324). The
engine keeps a fixed set of batch lanes ("slots"), admits a waiting request
into a free slot by reserving its KV blocks, prefills prompts in bounded
chunks under a per-tick token budget, and steps every decoding slot together
through a K-step macro program, one token per sequence per step, each at its
own position in a block-paged KV pool. Sequences finish and free their slot
independently.

What this slice carries over: the native pool, greedy sampling, a single
device, the budgeted chunked prefill (including the multi-slot
`paged_prefill_window` wave), the K-step macro decode, the flat chain-key
prefix cache of `BlockManager`, and eos handling. The constructor keeps the
reference's signature; every argument that would arm a feature not yet
ported (radix COW, the spill tier, temperature sampling, bursts,
speculation, the int8 pool, tensor parallelism, quotas, fault injection and
recovery, tracing, the cost ledger, the fleet KV store) raises
NotImplementedError naming its ROADMAP item. An exception on the tick path
fails every outstanding request and resets the pool (the reference's
`surgical_recovery=False` behaviour).

PyTorch in place of JAX: the programs write the pool in place and run
eagerly on one CUDA stream, whose ordering replaces JAX's donation chain.
Token vectors stay on the device; a `_TokRef` starts an asynchronous copy
into pinned host memory when it is created and materializes on first host
need, so neither admission nor steady decode blocks on a host round trip.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nos_tpu_torch import constants
from nos_tpu_torch.device import resolve
from nos_tpu_torch.models.decode import (
    init_paged_cache,
    paged_decode_step,
    paged_prefill_chunk,
    paged_prefill_window,
)
from nos_tpu_torch.models.gpt import GPTConfig
from nos_tpu_torch.runtime.block_manager import BlockManager
from nos_tpu_torch.runtime.staging import HostStage, SyncLedger, TickState

logger = logging.getLogger(__name__)


class _TokRef:
    """One dispatched step's token vector (or a wave's first-token vector);
    materializes to numpy once, on first host need. A CUDA tensor is copied
    into pinned host memory asynchronously at construction, behind a
    recorded event that `is_ready` queries; `np()` waits on that event.
    Tensor-backed refs count into the engine's `blocking_syncs` ledger when
    they materialize. The engine never writes a tensor it has handed to a
    ref."""

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
    # step's row of its macro window [K, n_slots].
    refs: List[Tuple[_TokRef, int, Optional[int]]] = field(default_factory=list)
    eos_scanned: int = 0
    future: Optional[Future] = None


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
        burst_windows: int = 1,
        block_size: int = 32,
        total_blocks: Optional[int] = None,
        spec_k: int = 0,
        spec_ngram: int = 3,
        spec_sync: bool = False,
        spec_tree_drafts: bool = True,
        prefill_budget_tokens: Optional[int] = None,
        prefix_cache: bool = True,
        radix_cache: bool = False,
        spill_blocks: Optional[int] = 0,
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
        "cpu" runs the kernels' plain versions, as the tests do.

        `steps_per_dispatch` (K) runs K decode steps per macro dispatch;
        `prefill_budget_tokens` bounds the prompt tokens one tick may
        dispatch (None = the largest bucket, 0 = unbudgeted);
        `prefix_cache` maps cached full prompt blocks into a new slot's
        page table instead of recomputing them. Greedy outputs are
        identical for any K, budget and prefix-cache setting."""
        if kv_dtype not in constants.KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of {constants.KV_DTYPES}: {kv_dtype!r}")
        # (armed?, what it arms, its item in ROADMAP.md queue A)
        armed = [
            (float(temperature) > 0.0, "temperature sampling", "The threefry sampler"),
            (int(burst_windows) > 1, "fused bursts", "Fused bursts"),
            (int(spec_k) > 0, "speculation", "Speculation"),
            (bool(radix_cache) and bool(prefix_cache), "the radix cache",
             "Radix COW and the spill tier"),
            (spill_blocks is None or int(spill_blocks) > 0, "the spill tier",
             "Radix COW and the spill tier"),
            (kv_dtype == constants.KV_DTYPE_INT8, "the int8 pool", "The int8 engine"),
            (mesh is not None, "a tensor-parallel mesh", "Tensor parallelism"),
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
        self.device = resolve(device, "DecodeServer")
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
        self.cache = init_paged_cache(
            cfg, self.total_blocks, self.block_size, device=self.device
        )
        self._stage = HostStage(self.device)
        self._syncs = SyncLedger()
        self._tick_state = TickState(self._stage, n_slots, self.max_pages)
        self._table_np = np.zeros((n_slots, self.max_pages), dtype=np.int32)
        self.prefix_cache = bool(prefix_cache)
        self._block_mgr = BlockManager(self.total_blocks, self.block_size, n_slots)
        self._waiting: Deque[_Request] = deque()
        self._queue: "queue.Queue" = queue.Queue()
        self._slots = [_Slot() for _ in range(n_slots)]
        self._last_dev = torch.zeros((n_slots,), dtype=torch.int32, device=self.device)
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
        self.steps_run = 0
        self.macro_dispatches = 0
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
        # Per-slot request serials ride in the packed tick state (the
        # sampling identity the temperature sampler will read).
        self._slot_serial = np.zeros((n_slots,), dtype=np.int64)
        self._next_serial = 1
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))

    # -- the programs ----------------------------------------------------------
    def _greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """The LOWEST index among the exact maxima, not argmax: argmax's
        tie-break is not stable across program shapes (decode_server.py:999)."""
        top = logits.max(dim=-1, keepdim=True).values
        idx = torch.arange(self.cfg.vocab, dtype=torch.int32, device=logits.device)
        return torch.where(logits == top, idx, self.cfg.vocab).min(dim=-1).values

    def _macro(self, token, table, pos0, active, step0, steps_left):
        """K ragged decode steps (decode_server.py:1067). Per step k a lane
        takes part iff it is active, still owes tokens (k < steps_left) and
        stays inside the cache window; lanes that finish mid-window coast
        (their writes go to the scratch page, token held). Returns the last
        tokens, the [K, n_slots] token window and the advanced pos / step /
        steps_left, the same arithmetic the host bookkeeping mirrors."""
        K = self.steps_per_dispatch
        toks = []
        for k in range(K):
            pos_k = pos0 + k
            mask = active & (k < steps_left) & (pos_k < self.max_len)
            logits, _ = paged_decode_step(
                self.params, token, self.cfg, self.cache, table, pos_k, mask,
                self.block_size,
            )
            nxt = self._greedy(logits)
            token = torch.where(mask, nxt, token)
            toks.append(torch.where(mask, nxt, 0))
        execd = torch.where(
            active,
            torch.clamp(torch.minimum(steps_left, self.max_len - pos0), 0, K),
            0,
        ).to(pos0.dtype)
        return token, torch.stack(toks), pos0 + execd, step0 + execd, steps_left - execd

    def _prefill_chunk(self, tokens, table_row, start: int, length: int) -> None:
        paged_prefill_chunk(
            self.params, tokens, self.cfg, self.cache, table_row, start, length,
            self.block_size, with_logits=False,
        )

    def _prefill_last(self, tokens, table_row, start: int, length: int, slot: int) -> None:
        """The final chunk: sample the first token at the true last prompt
        position and scatter it into the step-feed vector and into this
        wave's first-token vector (cloned per wave by the caller: earlier
        waves' refs still hold the previous one)."""
        logits, _ = paged_prefill_chunk(
            self.params, tokens, self.cfg, self.cache, table_row, start, length,
            self.block_size,
        )
        first = self._greedy(logits[length - 1][None, :])[0]
        self._last_dev[slot] = first
        self._first_dev[slot] = first

    def _prefill_window(self, tokens, table, pos, lengths, active) -> None:
        paged_prefill_window(
            self.params, tokens, self.cfg, self.cache, table, pos, lengths, active,
            self.block_size,
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
        and clear its lane."""
        self._block_mgr.release(idx)
        self._slots[idx] = _Slot()
        self._tick_state.mark_table_dirty()

    def _reset_device_state(self) -> None:
        """After an engine error the pool is untrustworthy: reallocate it."""
        self.cache = init_paged_cache(
            self.cfg, self.total_blocks, self.block_size, device=self.device
        )
        self._table_np[:] = 0
        self._tick_state.mark_table_dirty()
        self._block_mgr.reset()
        self._last_dev = torch.zeros((self.n_slots,), dtype=torch.int32, device=self.device)
        self._first_dev = torch.zeros((self.n_slots,), dtype=torch.int32, device=self.device)

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
            slot.pending_prompt = prompt
            # Prefix hits are already in the page table: the cursor starts
            # at the first miss (always below the last-token block).
            slot.prefill_cursor = n_hit * self.block_size
            slot.t_submit = req.t_submit
            slot.pos = slot.prefill_cursor
            slot.remaining = req.max_new - 1
            slot.refs = []
            slot.eos_scanned = 0
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
            for idx in order:
                slot = self._slots[idx]
                if slot.phase not in ("reserved", "prefilling"):
                    continue  # finished in an earlier wave of this tick
                start = slot.prefill_cursor
                piece = slot.pending_prompt[start : start + chunk]
                if budget and spent and spent + len(piece) > budget:
                    exhausted = True
                    break
                wave.append((idx, start, piece))
                spent += len(piece)
            if not wave:
                break
            dispatches += self._dispatch_prefill_wave(wave)
            if budget and spent >= budget:
                break
        return dispatches

    def _dispatch_prefill_wave(self, wave: List[Tuple[int, int, list]]) -> int:
        """Dispatch one wave. Mid-prompt chunks sharing a bucket go through
        the batched multi-slot window program; a singleton mid chunk keeps
        the batch-1 program. Final chunks always go through the per-slot
        `_prefill_last`, which samples the first token."""
        self._sync_tick_state(for_table_only=True)
        table = self._tick_state.table
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
                    self._stage.to_device(padded), table[idx], start, len(piece)
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
                self._stage.to_device(padded), table[idx], start, len(piece), idx
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
            slot.future.set_result(out)
            self._release_slot(idx)

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
                    slot.future.set_result(self._finalize(slot))
                    self._release_slot(idx)
                    break

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
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.tick_phase_s[name] += time.perf_counter() - t0

    def _tick(self) -> None:
        """One engine iteration (decode_server.py:3610, :3639): (1)
        admission reserves slots and pages, (2) the prefill budget
        dispatches bounded chunk waves, (3) every decoding slot gets the
        K-step macro program. All of it is ordered on one stream over
        disjoint page sets."""
        if self._engine_idle and self._queue.empty():
            # The previous tick proved the engine empty; only a submit can
            # change that.
            with self._phase(constants.TICK_PHASE_IDLE):
                self._stop.wait(0.005)
            return
        self._engine_idle = False
        with self._phase(constants.TICK_PHASE_ADMIT):
            self._admit()
        with self._phase(constants.TICK_PHASE_EOS_SCAN):
            self._scan_eos()
        if not any(s.active for s in self._slots):
            self._engine_idle = not self._waiting and self._queue.empty()
            with self._phase(constants.TICK_PHASE_IDLE):
                self._stop.wait(0.005)
            return
        with self._phase(constants.TICK_PHASE_PUMP_PREFILL):
            n_prefill = self._pump_prefill()
        macro = [
            i for i, s in enumerate(self._slots) if s.active and s.phase == "decoding"
        ]
        if macro:
            with self._phase(constants.TICK_PHASE_DISPATCH_MACRO):
                self._dispatch_macro(macro)
        if n_prefill and macro:
            self.ticks_with_prefill_and_macro += 1

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
            packed[i, P + 1] = int(s.active and s.phase == "decoding")
            packed[i, P + 2] = self._slot_serial[i]
            packed[i, P + 3] = len(s.refs)
            packed[i, P + 4] = s.remaining if s.active else 0
        st.sync(packed)

    def _dispatch_macro(self, idxs: List[int]) -> None:
        """One K-step macro dispatch for the decoding slots. Inputs come
        from the device-resident TickState; the program advances pos / step
        / steps_left on the device, so steady-state dispatches upload
        nothing."""
        self._sync_tick_state()
        st = self._tick_state
        K = self.steps_per_dispatch
        last, toks, pos, step, steps_left = self._macro(
            self._last_dev, st.table, st.pos, st.mask, st.step, st.steps_left
        )
        self._last_dev = last
        st.advance(pos, step, steps_left)
        ref = _TokRef(toks, self._syncs)
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
        # Backpressure: bound the dispatch queue; materializing the oldest
        # in-flight window is (amortized) already-complete work.
        while len(self._inflight) > self.pipeline_depth:
            self._inflight.popleft().np()

    # -- counters ----------------------------------------------------------------
    @property
    def prefix_hit_tokens(self) -> int:
        """Prompt tokens served from cached blocks instead of prefill."""
        return self._block_mgr.hit_tokens

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
