"""The port's SliceServer (nos_tpu_torch/runtime/slice_server.py) on every
scenario of tests/test_slice_server.py, over torch callables on the CPU.

Where a scenario counts retries (transient and poison failures, batch and
fetch), the reference's server runs the same seeded failure schedule and
the counters must be equal. One case serves the same images through both
servers' `vit_detect` and holds them to test_torch_vit.py's bounds."""

import concurrent.futures
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.runtime.faults import PoisonRequestError as JPoison
from nos_tpu.runtime.slice_server import SliceServer as JSliceServer
from nos_tpu_torch.runtime.faults import PoisonRequestError
from nos_tpu_torch.runtime.slice_server import SliceServer


def make_server(**kw):
    return SliceServer(lambda x: x * 2.0 + 1.0, **kw)


def full(value, n=2):
    return torch.full((n,), float(value))


def test_single_request_roundtrip():
    server = make_server(max_batch=4).start()
    try:
        out = server.infer(torch.ones(3), timeout=5)
        assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
        np.testing.assert_allclose(out.numpy(), np.full(3, 3.0))
        assert server.requests_served == 1
    finally:
        server.stop()


def test_concurrent_requests_batched():
    server = make_server(max_batch=8, max_wait_s=0.05).start()
    try:
        results = {}

        def client(i):
            results[i] = server.infer(full(i), timeout=10).numpy()

        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=20)
            assert not t.is_alive()
        for i in range(8):
            np.testing.assert_allclose(results[i], np.full(2, 2.0 * i + 1.0))
        assert server.requests_served == 8
        assert server.batches_run < 8
    finally:
        server.stop()


def test_bucket_padding_returns_correct_rows():
    shapes = []
    server = SliceServer(lambda x: shapes.append(tuple(x.shape)) or x * 2.0 + 1.0,
                         max_batch=8, max_wait_s=0.03).start()
    try:
        futs = [server.submit(full(i)) for i in range(3)]
        for i, f in enumerate(futs):
            np.testing.assert_allclose(f.result(timeout=10).numpy(), np.full(2, 2.0 * i + 1.0))
        assert all(s[0] in server.buckets for s in shapes)  # padded up to a bucket
    finally:
        server.stop()


def _pair(fn_torch, fn_jax, **kw):
    return SliceServer(fn_torch, **kw), JSliceServer(fn_jax, **kw)


def test_error_propagates_to_futures():
    def bad(x):
        raise RuntimeError("boom")

    counts = []
    for server, x in zip(_pair(bad, bad, max_batch=2, retry_backoff_s=0.001),
                         (torch.ones(1), jnp.ones((1,)))):
        server.start()
        try:
            with pytest.raises(RuntimeError, match="boom"):
                server.submit(x).result(timeout=5)
            counts.append((server.retries, server.fetch_retries, server.requests_served))
        finally:
            server.stop()
    assert counts[0] == counts[1] == (2, 0, 0)  # the budget spent, as the reference


def _flaky(base, fails, message):
    calls = {"n": 0}

    def fn(x):
        calls["n"] += 1
        if calls["n"] <= fails:
            raise RuntimeError(message)
        return base(x)

    return fn, calls


def test_flaky_batch_execution_retries_then_succeeds():
    """Two transient failures within max_retries: the client gets its
    result, no future sees the error, the counters equal the reference's."""
    msg = "remote_compile: read body: response body closed"
    tfn, tcalls = _flaky(lambda x: x * 2.0 + 1.0, 2, msg)
    jfn, jcalls = _flaky(jax.jit(lambda x: x * 2.0 + 1.0), 2, msg)
    kw = dict(max_batch=4, max_retries=2, retry_backoff_s=0.001, stack_in_program=False,
              pipeline_fetch=False)
    outs, counts = [], []
    for server, x in zip(_pair(tfn, jfn, **kw), (full(3.0), jnp.full((2,), 3.0))):
        server.start()
        try:
            outs.append(np.asarray(server.infer(x, timeout=10)))
            counts.append((server.retries, server.fetch_retries, server.requests_served))
        finally:
            server.stop()
    np.testing.assert_allclose(outs[0], np.full(2, 7.0))
    assert np.array_equal(outs[0], outs[1])
    assert counts[0] == counts[1] == (2, 0, 1)
    assert tcalls["n"] == jcalls["n"] == 3


def test_flaky_fetch_retries_then_succeeds(monkeypatch):
    """A transient failure of the copy to the host retries on the fetch
    thread with its own counter, as in the reference."""
    counts = []
    for server, x in zip(_pair(lambda x: x + 1.0, jax.jit(lambda x: x + 1.0), max_batch=2,
                               max_retries=2, retry_backoff_s=0.001, pipeline_fetch=True),
                         (torch.zeros(2), jnp.zeros((2,)))):
        real_fetch = server._fetch
        calls = {"n": 0}

        def flaky_fetch(out, futures, n, dispatched_at, real_fetch=real_fetch, calls=calls):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("connection reset by peer")
            return real_fetch(out, futures, n, dispatched_at)

        monkeypatch.setattr(server, "_fetch", flaky_fetch)
        server.start()
        try:
            np.testing.assert_allclose(np.asarray(server.infer(x, timeout=10)), np.ones(2))
            counts.append((server.retries, server.fetch_retries))
        finally:
            server.stop()
    assert counts[0] == counts[1] == (0, 1)


def test_poison_classified_failure_skips_the_retry_budget():
    """A PoisonRequestError (the request data is the problem) fails the
    batch at once: one call, no retry, on both servers."""
    calls = {"torch": 0, "jax": 0}

    def poisoned(kind, exc):
        def fn(x):
            calls[kind] += 1
            raise exc("bad request payload")
        return fn

    kw = dict(max_batch=2, max_retries=3, retry_backoff_s=0.001, stack_in_program=False,
              pipeline_fetch=False)
    servers = (SliceServer(poisoned("torch", PoisonRequestError), **kw),
               JSliceServer(poisoned("jax", JPoison), **kw))
    for server, x, exc in zip(servers, (torch.ones(1), jnp.ones((1,))),
                              (PoisonRequestError, JPoison)):
        server.start()
        try:
            with pytest.raises(exc):
                server.submit(x).result(timeout=5)
            assert server.retries == 0
        finally:
            server.stop()
    assert calls == {"torch": 1, "jax": 1}


def test_pytree_outputs():
    server = SliceServer(lambda x: {"a": x + 1, "b": (x * 2, x - 1)}, max_batch=4).start()
    try:
        out = server.infer(torch.zeros(2), timeout=5)
        np.testing.assert_allclose(out["a"].numpy(), np.ones(2))
        assert isinstance(out["b"], tuple)
        np.testing.assert_allclose(out["b"][0].numpy(), np.zeros(2))
        np.testing.assert_allclose(out["b"][1].numpy(), -np.ones(2))
    finally:
        server.stop()


def test_pipelined_fetch_preserves_results_under_load():
    server = SliceServer(lambda x: x * 10.0, max_batch=4, max_wait_s=0.001,
                         pipeline_fetch=True).start()
    try:
        def one(i):
            return i, server.infer(full(i), timeout=30).numpy()

        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
            for i, out in ex.map(one, range(40)):
                np.testing.assert_allclose(out, np.full(2, 10.0 * i))
        assert server.requests_served == 40
    finally:
        server.stop()


def test_warmup_builds_every_bucket_and_serves_without_building():
    """warmup builds (and runs) one program per bucket; serving reuses them
    and builds nothing new."""
    shapes = []
    server = SliceServer(lambda x: shapes.append(tuple(x.shape)) or x + 1.0, max_batch=4,
                         buckets=(1, 2, 4))
    server.warmup(torch.zeros(3))
    assert sorted(s[0] for s in shapes) == [1, 2, 4]
    programs = dict(server._bucket_fns)
    assert sorted(programs) == [1, 2, 4]
    server.start()
    try:
        np.testing.assert_allclose(server.infer(torch.ones(3), timeout=10).numpy(),
                                   np.full(3, 2.0))
        assert server._bucket_fns == programs  # the same program objects
    finally:
        server.stop()


def test_adaptive_wait_stays_at_floor_for_single_client():
    server = make_server(max_batch=8, max_wait_s=0.002, adaptive_wait=True).start()
    try:
        for i in range(12):
            server.infer(full(i), timeout=10)
        assert server._effective_wait_s() == pytest.approx(0.002)
    finally:
        server.stop()


def test_adaptive_wait_grows_with_observed_concurrency():
    """The window formula, floor and ceiling, from set EMAs, equal to the
    reference's at every point."""
    kw = dict(max_batch=8, max_wait_s=0.002, adaptive_wait=True)
    servers = (make_server(**kw), JSliceServer(lambda x: x, **kw))
    for concurrency, cycle, want in ((4.0, 0.08, 0.02), (4.0, 1.0, 0.1), (4.0, 0.001, 0.002),
                                     (1.2, 1.0, 0.002)):
        got = []
        for server in servers:
            server._concurrency_ema, server._cycle_ema = concurrency, cycle
            got.append(server._effective_wait_s())
        assert got[0] == got[1] == pytest.approx(want)


def test_eager_stacking_mode_matches_in_program_stacking():
    results = {}
    for mode in (True, False):
        server = SliceServer(lambda x: x * 3.0, max_batch=4, stack_in_program=mode).start()
        try:
            futs = [server.submit(full(i)) for i in range(4)]
            results[mode] = [f.result(timeout=10).numpy() for f in futs]
        finally:
            server.stop()
    for a, b in zip(results[True], results[False]):
        assert np.array_equal(a, b)


def test_oversized_burst_is_served_across_batches():
    server = make_server(max_batch=4, max_wait_s=0.02).start()
    try:
        futs = [server.submit(full(i)) for i in range(11)]
        for i, f in enumerate(futs):
            np.testing.assert_allclose(f.result(timeout=10).numpy(), np.full(2, 2.0 * i + 1.0))
        assert server.batches_run >= 3
    finally:
        server.stop()


def test_stop_then_submit_leaves_future_unresolved_not_crashed():
    server = make_server(max_batch=2).start()
    server.stop()
    fut = server.submit(torch.ones(1))
    with pytest.raises(Exception):
        fut.result(timeout=0.2)


def test_default_buckets_match_reference():
    for max_batch in (1, 2, 7, 8, 9):
        assert make_server(max_batch=max_batch).buckets == JSliceServer(
            lambda x: x, max_batch=max_batch).buckets


def test_vit_detect_served_by_both_servers_agrees():
    """The same seven images through the JAX server's and the port's
    `vit_detect` (bench.py's server settings, f32 tiny config): each
    request's labels equal, scores and boxes within test_torch_vit.py's
    bounds."""
    from test_torch_vit import BOX_ATOL, LOGIT_ATOL, SHORT, _case, _tcfg

    from nos_tpu.models import vit as jvit
    from nos_tpu_torch.models import vit as tvit

    jparams, tparams, images = _case(SHORT, 7, 4)
    tcfg = _tcfg(SHORT)
    kw = dict(max_batch=7, max_wait_s=0.003, buckets=(1, 2, 4, 7))
    jserver = JSliceServer(jax.jit(lambda im: jvit.vit_detect(jparams, im, SHORT)), **kw)
    tserver = SliceServer(lambda im: tvit.vit_detect(tparams, im, tcfg), **kw)
    jserver.warmup(jnp.asarray(images[0]))
    tserver.warmup(torch.from_numpy(images[0]))
    outs = {}
    for name, server, conv in (("jax", jserver, jnp.asarray), ("torch", tserver,
                                                              torch.from_numpy)):
        server.start()
        try:
            futs = [server.submit(conv(im)) for im in images]
            outs[name] = [tuple(np.asarray(o) for o in f.result(timeout=30)) for f in futs]
        finally:
            server.stop()
        assert server.requests_served == 7
    for (jl, js, jb), (tl, ts, tb) in zip(outs["jax"], outs["torch"]):
        assert tl.dtype == np.int32 and np.array_equal(tl, jl)
        np.testing.assert_allclose(ts, js, atol=LOGIT_ATOL, rtol=0)
        np.testing.assert_allclose(tb, jb, atol=BOX_ATOL, rtol=0)
