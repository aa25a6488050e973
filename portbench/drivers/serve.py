"""Serve a cell's traffic through `nos_tpu_torch`'s DecodeServer.

Set-up: from the configuration's architecture (`arch/<arch>.py`) the
serving path's kernel libraries (built on a checkout's first run only),
the weights on the card from the seed and the engine's model config; the
engine with the cell's settings; and warm requests that run each program
shape the cell's traffic will use: a final prefill chunk at every prompt bucket
up to the longest prompt, a mid chunk where prompts outrun the largest
bucket, decode windows and fused bursts, and a prefix hit with a
copy-on-write. The window opens with the first request of the traffic:
nothing was sent before it, so every kernel a `--trace 1` run records
serves a request of the window. Requests are sent through
`DecodeServer.submit` on their schedule (`drive`); a request due or sent
before the window closes is followed to completion, at most `max_drain_s`
past the close. Then the engine stops, the device's peak memory is read,
the engine's state is freed, and `check.py` compares a sample of the
served tokens with the plain reference.
"""

from __future__ import annotations

import gc
import heapq
import queue
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from portbench.gen import Stream


@dataclass
class Record:
    """One request as its client saw it; times in seconds from the window's
    opening."""
    stream: int
    turn: int
    due: float
    sent: float
    prompt: np.ndarray
    max_new: int
    done: Optional[float] = None
    out: Optional[np.ndarray] = None
    error: Optional[str] = None

    @property
    def latency(self) -> float:
        return float("inf") if self.done is None or self.error else self.done - self.due

    @property
    def n_out(self) -> int:
        return 0 if self.out is None else len(self.out)


@dataclass
class Served:
    """What a window produced, for the readers."""
    records: List[Record]
    seconds: float
    end_s: float
    lateness_s: List[float] = field(default_factory=list)


def max_prompt(streams: List[Stream]) -> int:
    best = 0
    for st in streams:
        total = 0
        for t in st.turns:
            total = total + len(t.new) if st.history and not t.fresh else len(t.new)
            best = max(best, total)
            if st.history:
                total += t.max_new
    return best


def engine_kwargs(cell: Dict) -> Dict:
    e = dict(cell["engine"])
    e["prompt_buckets"] = tuple(e["prompt_buckets"])
    return e


def warm(engine, cell: Dict, longest: int, vocab: int, seed: int) -> int:
    """Run the program shapes the cell's traffic uses; returns the number of
    warm requests. Token ids come from a stream of the seed that the
    traffic does not use."""
    rng = np.random.default_rng([int(seed), 1])
    e = cell["engine"]
    buckets = sorted(e["prompt_buckets"])
    window = int(e.get("steps_per_dispatch", 1)) * int(e.get("burst_windows", 4))
    lengths = [b for b in buckets if b <= longest] or buckets[:1]
    if longest > buckets[-1]:
        lengths.append(min(longest, buckets[-1] + buckets[0]))
    block = int(e.get("block_size", 32))
    first = [rng.integers(0, vocab, size=n).tolist() for n in lengths]
    futs = [engine.submit(p, 2 * window + 3) for p in first]
    for f in futs:
        f.result(timeout=600)
    # A prefix hit and a mid-block divergence (copy-on-write) on the
    # first warm prompt's blocks.
    base = first[-1]
    cut = min(len(base) - 1, 2 * block + block // 2)
    again = [base[:cut] + rng.integers(0, vocab, size=block).tolist()]
    futs = [engine.submit(p, window + 2) for p in again]
    for f in futs:
        f.result(timeout=600)
    return len(first) + len(again)


def drive(engine, streams: List[Stream], seconds: float, max_drain_s: float,
          on_open=None) -> Served:
    """Send each stream's turns on schedule for `seconds`, then follow what
    was sent to completion. A turn is due at its stream's start or when the
    reply to the turn before it arrives; it is sent when due (lateness is
    recorded), and only if due before the window closes."""
    done_q: "queue.Queue" = queue.Queue()
    due = [(st.start_s, i, 0) for i, st in enumerate(streams) if st.turns]
    heapq.heapify(due)
    hist: Dict[int, np.ndarray] = {}
    records: List[Record] = []
    lateness: List[float] = []
    outstanding = 0
    if on_open is not None:
        on_open()
    t0 = time.monotonic()

    def finished(fut, rec):
        done_q.put((rec, fut, time.monotonic() - t0))

    while True:
        now = time.monotonic() - t0
        while due and due[0][0] <= now and due[0][0] < seconds:
            at, i, k = heapq.heappop(due)
            st = streams[i]
            turn = st.turns[k]
            fresh = not st.history or k == 0 or turn.fresh
            prompt = turn.new if fresh else np.concatenate([hist[i], turn.new])
            rec = Record(i, k, at, time.monotonic() - t0, prompt, turn.max_new)
            records.append(rec)
            lateness.append(rec.sent - at)
            fut = engine.submit(prompt.tolist(), turn.max_new)
            outstanding += 1
            fut.add_done_callback(lambda f, r=rec: finished(f, r))
        if due and due[0][0] >= seconds:
            due = []
        now = time.monotonic() - t0
        if now >= seconds and (outstanding == 0 or now >= seconds + max_drain_s):
            break
        wait = 0.05 if not due else min(0.05, max(0.0, due[0][0] - now))
        try:
            item = done_q.get(timeout=wait)
        except queue.Empty:
            continue
        while item is not None:
            rec, fut, at = item
            outstanding -= 1
            rec.done = at
            exc = fut.exception()
            if exc is not None:
                rec.error = repr(exc)
            else:
                rec.out = np.asarray(fut.result(), dtype=np.int64)
                st = streams[rec.stream]
                if st.history:
                    hist[rec.stream] = np.concatenate([rec.prompt, rec.out]).astype(np.int32)
                if rec.turn + 1 < len(st.turns) and at < seconds:
                    heapq.heappush(due, (at, rec.stream, rec.turn + 1))
            try:
                item = done_q.get_nowait()
            except queue.Empty:
                item = None
    return Served(records, seconds, time.monotonic() - t0, lateness)


def run(ctx) -> None:
    """Fill `ctx` (a `harness.Run`) with the window's results."""
    import torch

    from nos_tpu_torch.runtime.decode_server import DecodeServer
    from nos_tpu_torch.tracing import EngineTracing

    cell, config, arch = ctx.cell, ctx.config, ctx.arch
    device = torch.device(run_device(ctx))
    marks = [("imports", time.monotonic())]
    if device.type == "cuda":
        from nos_tpu_torch.ops import _build

        # The serving path's kernel libraries, built by nvcc on a checkout's
        # first run only; timed apart from the rest of the set-up.
        for lib in arch.KERNEL_LIBRARIES:
            _build.build(lib)
    marks.append(("kernels", time.monotonic()))
    params = arch.make_params(config, ctx.seed, device)
    sync(device)
    marks.append(("weights", time.monotonic()))
    cfg = arch.engine_config(config)
    streams = ctx.make_traffic()
    engine = DecodeServer(params, cfg, device=device, temperature=0.0, seed=0,
                          tracing=EngineTracing() if ctx.trace else None,
                          **engine_kwargs(cell))
    engine.start()
    marks.append(("engine", time.monotonic()))
    ctx.warm_requests = warm(engine, cell, max_prompt(streams), ctx.shape.vocab, ctx.seed)
    sync(device)
    marks.append(("warm", time.monotonic()))
    t = ctx.t_process
    for name, at in marks:
        ctx.setup_parts[name] = at - t
        t = at
    before = counters(engine)
    trace = None

    def on_open():
        nonlocal trace
        ctx.open_window()
        if ctx.trace:
            from portbench.trace import Trace
            trace = Trace().collect()

    served = drive(engine, streams, ctx.seconds, float(cell.get("max_drain_s", 60)), on_open)
    if trace is not None:
        trace.stop()
    after = counters(engine)
    engine.stop()
    sync(device)
    if device.type == "cuda":
        ctx.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    ctx.served, ctx.trace_data = served, trace
    ctx.counters = (before, after)
    del engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ctx.params = params


def run_device(ctx) -> str:
    return "cuda:0" if str(ctx.device) == "cuda" else str(ctx.device)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def counters(engine) -> Dict:
    """The engine's own counters and samples, read between ticks' worth of
    host work (the lists are only appended to)."""
    return {
        "tick_host_overhead_s": engine.tick_host_overhead_s,
        "ticks_profiled": engine.ticks_profiled,
        "tick_wall_s": engine.tick_wall_s,
        "prefix_hit_tokens": engine.prefix_hit_tokens,
        "prefix_cow_tokens": engine.prefix_cow_tokens,
        "prefill_tokens": engine.prefill_tokens,
        "queue_wait_n": len(engine.queue_wait_s),
        "queue_wait_s": list(engine.queue_wait_s),
        "graph_replays": engine.graph_replays,
    }
