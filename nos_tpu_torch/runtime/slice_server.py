"""SliceServer: a dynamic micro-batching executor for a shared accelerator.

Port of `nos_tpu/runtime/slice_server.py` (:32-294). When several
inference workloads share one card, the server batches their concurrent
requests into single executions instead of time-slicing them: each client
sees a latency close to one inference instead of N of them. One executor
thread drains a request queue, stacks up to `max_batch` requests (padded up
to fixed bucket sizes), runs the batched function and hands the results to
waiting futures; with `pipeline_fetch` a second thread copies results to
the host while the next batch runs.

The constructor and its semantics are the reference's: buckets and padding,
`stack_in_program`, `pipeline_fetch` (at most 2 batches in flight),
`adaptive_wait` with its EMAs, `max_retries` with the seeded jittered
backoff, POISON faults (`runtime/faults.py::classify_fault`) skipping the
retry, the counters `batches_run`, `requests_served`, `retries` and
`fetch_retries`. Where JAX jits a program per bucket, the port runs each
bucket's program eagerly: `stack_in_program` keeps one program a bucket
(the stack and the batched function), built once (`warmup` builds and runs
every bucket, so serving builds nothing new); without it, a program is made
per batch. `jax.device_get` becomes one copy to the host per batch on the
fetch thread; an output that is a tree (a tuple, list or dict of tensors,
as the detector's) is split per request as `jax.tree.map(lambda o: o[i],
out)` splits it, into views of the host copy.
"""

from __future__ import annotations

import logging
import queue
import random
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence

import torch

from nos_tpu_torch.models.data import map_arrays
from nos_tpu_torch.runtime.faults import FAULT_POISON, classify_fault

logger = logging.getLogger(__name__)


def _to_host(out):
    """One copy of every tensor of `out` to the host (waits for it)."""
    return map_arrays(lambda o: o.detach().cpu() if isinstance(o, torch.Tensor) else o, out)


class SliceServer:
    def __init__(
        self,
        batched_fn: Callable,
        max_batch: int = 8,
        max_wait_s: float = 0.002,
        buckets: Optional[Sequence[int]] = None,
        stack_in_program: bool = True,
        pipeline_fetch: bool = True,
        adaptive_wait: bool = True,
        max_retries: int = 2,
        retry_backoff_s: float = 0.01,
        retry_seed: int = 0,
    ):
        """`batched_fn(batch_input)` must accept a leading batch dimension.
        `buckets` are the batch sizes programs are built for (requests
        padded up).

        With `stack_in_program` (default), each bucket has one program
        that stacks the per-request inputs and runs `batched_fn`, built
        once and kept.

        With `pipeline_fetch` (default), the device->host copy of a batch's
        results happens on a dedicated thread: batch k+1 is collected and
        dispatched while batch k's results come down. Bounded to 2
        in-flight batches for backpressure.

        With `adaptive_wait` (default), the batching window scales itself
        to the observed service time: when several clients are in
        closed-loop flight, waiting ~1/4 of a batch cycle to coalesce them
        into one full batch saves a whole extra round trip per request.
        With a single client the window stays at `max_wait_s`.

        `max_retries` bounds in-place retries of a failed batch execution
        or result fetch (jittered exponential backoff from
        `retry_backoff_s`, deterministic via `retry_seed`), so one
        transient failure does not fail every coalesced client. Faults
        that classify POISON (runtime/faults.py) skip the retry. Only after
        the budget is exhausted do the batch's futures fail."""
        self._fn = batched_fn
        self.stack_in_program = stack_in_program
        self._bucket_fns = {}
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        if buckets is None:
            buckets = []
            b = 1
            while b < max_batch:
                buckets.append(b)
                b *= 2
            buckets.append(max_batch)
        self.buckets = sorted(set(buckets))
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.pipeline_fetch = pipeline_fetch
        self._fetch_queue: "queue.Queue" = queue.Queue(maxsize=2)
        self._fetch_thread: Optional[threading.Thread] = None
        self.batches_run = 0
        self.requests_served = 0
        self.adaptive_wait = adaptive_wait
        self._cycle_ema: Optional[float] = None  # dispatch -> results on the host
        self._concurrency_ema: float = 1.0  # requests coalesced per batch
        # Bounded transient-failure retry (executor and fetch threads each
        # call _call_with_retry; the counters witness it in tests).
        self.max_retries = max(0, int(max_retries))
        self.retry_backoff_s = float(retry_backoff_s)
        self._retry_rng = random.Random(retry_seed)
        self.retries = 0
        self.fetch_retries = 0

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "SliceServer":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        if self.pipeline_fetch:
            self._fetch_thread = threading.Thread(target=self._run_fetch, daemon=True)
            self._fetch_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._fetch_thread is not None:
            self._fetch_thread.join(timeout=5)

    def _get_bucket_fn(self, bucket: int) -> Callable:
        if not self.stack_in_program:
            return lambda *xs: self._fn(torch.stack(xs))
        fn = self._bucket_fns.get(bucket)
        if fn is None:
            fn = self._bucket_fns[bucket] = lambda *xs: self._fn(torch.stack(xs))
        return fn

    def warmup(self, example_input) -> None:
        """Build and run every bucket's program once (first-call latency
        off the serving path), waiting for each result."""
        for b in self.buckets:
            _to_host(self._get_bucket_fn(b)(*((example_input,) * b)))

    # -- client side ---------------------------------------------------------
    def submit(self, x) -> Future:
        """Queue one request (a single un-batched input). Returns a Future
        resolving to the un-batched output."""
        fut: Future = Future()
        self._queue.put((x, fut))
        return fut

    def infer(self, x, timeout: Optional[float] = None):
        return self.submit(x).result(timeout=timeout)

    # -- executor ------------------------------------------------------------
    def _call_with_retry(self, step: str, counter: str, fn):
        """Run `fn` with up to `max_retries` in-place retries on transient
        failure (jittered exponential backoff; the jitter RNG is seeded so
        tests replay). POISON-classified faults re-raise at once."""
        attempt = 0
        while True:
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 — classified + re-raised
                if (
                    classify_fault(e) == FAULT_POISON
                    or attempt >= self.max_retries
                    or self._stop.is_set()
                ):
                    raise
                attempt += 1
                setattr(self, counter, getattr(self, counter) + 1)
                delay = (
                    self.retry_backoff_s
                    * (2 ** (attempt - 1))
                    * (0.5 + self._retry_rng.random())
                )
                logger.warning(
                    "%s failed (%s: %s); retry %d/%d in %.3fs",
                    step, type(e).__name__, e, attempt, self.max_retries, delay,
                )
                self._stop.wait(delay)

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            batch: List = [first]
            deadline = time.perf_counter() + self._effective_wait_s()
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            inputs = [x for x, _ in batch]
            futures = [f for _, f in batch]
            try:
                n = len(inputs)
                bucket = self._bucket_for(n)
                # Pad by repeating the first input; padded rows are dropped.
                args = tuple(inputs) + (inputs[0],) * (bucket - n)
                dispatched_at = time.perf_counter()
                out = self._call_with_retry(
                    "batched execution",
                    "retries",
                    lambda: self._get_bucket_fn(bucket)(*args),
                )
                self._concurrency_ema = 0.7 * self._concurrency_ema + 0.3 * n
                if self.pipeline_fetch:
                    # Launched: hand the result on the device to the fetch
                    # thread and collect the next batch at once.
                    self._fetch_queue.put((out, futures, n, dispatched_at))
                else:
                    self._fetch(out, futures, n, dispatched_at)
            except Exception as e:  # noqa: BLE001
                # Retries exhausted (or poison): fail the waiting clients,
                # and log, since futures already done (timed-out callers)
                # would hide the error.
                logger.warning(
                    "batched execution failed (%s): %s",
                    classify_fault(e), e, exc_info=True,
                )
                for fut in futures:
                    if not fut.done():
                        fut.set_exception(e)
        if self.pipeline_fetch:
            self._fetch_queue.put(None)  # drain sentinel

    def _run_fetch(self) -> None:
        while True:
            item = self._fetch_queue.get()
            if item is None:
                return
            out, futures, n, dispatched_at = item
            try:
                self._call_with_retry(
                    "result fetch",
                    "fetch_retries",
                    lambda: self._fetch(out, futures, n, dispatched_at),
                )
            except Exception as e:  # noqa: BLE001
                logger.warning(
                    "result fetch failed (%s): %s",
                    classify_fault(e), e, exc_info=True,
                )
                for fut in futures:
                    if not fut.done():
                        fut.set_exception(e)

    def _fetch(self, out, futures, n, dispatched_at: float) -> None:
        # One device->host copy per batch; per-request results are then
        # views of the host copy.
        out = _to_host(out)
        cycle = time.perf_counter() - dispatched_at
        self._cycle_ema = (
            cycle if self._cycle_ema is None else 0.7 * self._cycle_ema + 0.3 * cycle
        )
        self.batches_run += 1
        self.requests_served += n
        for i, fut in enumerate(futures):
            fut.set_result(map_arrays(lambda o: o[i], out))

    def _effective_wait_s(self) -> float:
        """Batching window for the batch being collected. Adaptive mode waits
        up to a quarter of the observed batch cycle, but only when recent
        batches actually coalesced several clients."""
        if (
            not self.adaptive_wait
            or self._cycle_ema is None
            or self._concurrency_ema < 1.5
        ):
            return self.max_wait_s
        return max(self.max_wait_s, min(0.25 * self._cycle_ema, 0.1))
