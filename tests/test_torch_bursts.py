"""Fused bursts in the port's DecodeServer (nos_tpu_torch/runtime/
decode_server.py: `_burst_plan`, `_dispatch_burst`, the fixed window state),
on the CPU, mirroring the reference's tests/test_burst_decode.py:

  - burst-on equals burst-off token for token (greedy, temperature 0.8,
    staggered lane lengths that finish mid-burst, an eos mid-burst), and
    equals the JAX engine with the same burst_windows, dispatch counters
    included;
  - the steady-state budget, counter-gated: at most one packed staging
    upload per burst, none and no blocking read on a clean burst, fewer
    engine dispatches than burst-off;
  - `_burst_plan` degrades to per-tick dispatch while a request is queued
    or waiting, a prefill is pending, or the engine is stopping, and caps
    the window count at the work left;
  - tp=2 on a CPU mesh with an eos mid-burst equals tp=1;
  - the window's device state stays at fixed addresses, and the window
    makes no host copy (what a CUDA graph capture needs; the capture and
    its replay are held against the eager window on the card, in
    tests/test_torch_kernels.py).

The reference file's fault-injection cases are in tests/test_torch_faults.py,
its quota and preemption cases (the per-window quota fold, a preemption
mid-burst, the idle fast path) in tests/test_torch_quota.py; its drain case
in tests/test_torch_serving_cluster.py
(`test_drain_migrate_after_bursts_is_bit_identical`)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from nos_tpu.runtime.decode_server import DecodeServer as JaxServer
from nos_tpu_torch import DecodeServer, GPTConfig, from_numpy_params
from nos_tpu_torch.ops import paged_attention as tpa
from nos_tpu_torch.parallel import build_mesh
from nos_tpu_torch.runtime import decode_server as ds
from nos_tpu_torch.tracing import EngineTracing

from conftest import serving_test_config, serving_test_params


# tests/test_burst_decode.py's prompts. Its eos, 5, is in none of the
# tiny model's greedy streams; 13 is, at output 8 of the first stream
# (inside the first burst at K=4) and in no other.
PROMPTS = [
    [3, 11, 42, 7, 19, 5, 23, 2, 61, 13],
    [8, 8, 31, 4, 90, 17, 6, 44, 9, 28],
    [55, 1, 2, 3, 70, 70, 12, 39, 80, 10],
]
EOS = 13
COUNTERS = ("burst_dispatches", "burst_windows_run", "macro_dispatches", "steps_run",
            "prefill_dispatches", "h2d_uploads", "staging_syncs")


@pytest.fixture(scope="module")
def model():
    jcfg, jparams = serving_test_config(), serving_test_params()
    tcfg = GPTConfig(**dataclasses.asdict(jcfg))
    tparams = from_numpy_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def _settings(**kw):
    defaults = dict(n_slots=3, max_len=96, prompt_buckets=(8, 16), block_size=8,
                    steps_per_dispatch=4)
    defaults.update(kw)
    return defaults


def engine(model, burst_windows, mesh=None, **kw):
    _, _, tcfg, tparams = model
    device = None if mesh is not None else "cpu"
    return DecodeServer(tparams, tcfg, burst_windows=burst_windows, mesh=mesh,
                        device=device, **_settings(**kw))


def drive(server, reqs):
    """Submit everything, then tick to completion on this thread."""
    futs = [server.submit(p, max_new=n) for p, n in reqs]
    for _ in range(4000):
        if all(f.done() for f in futs):
            break
        server._tick()
    return [f.result(timeout=5) for f in futs]


def steady(server, reqs):
    """Submit and tick until every slot decodes and nothing waits."""
    futs = [server.submit(p, max_new=n) for p, n in reqs]
    for _ in range(50):
        server._tick()
        active = [s for s in server._slots if s.active]
        if len(active) == min(len(reqs), server.n_slots) and not server._waiting \
                and server._queue.empty() and all(s.phase == "decoding" for s in active):
            return futs
    raise AssertionError("never reached a steady decode state")


def finish(server, futs):
    for f in futs:
        f.cancel()
    server.stop()


# -- exactness -------------------------------------------------------------------
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_burst_outputs_identical_greedy_and_temperature(model, temperature):
    """Staggered max_new, so lanes finish mid-burst and coast: burst-on
    equals burst-off, and equals the JAX engine at the same burst_windows
    with the same dispatch counters."""
    jcfg, jparams, _, _ = model
    reqs = [(p, 20 + 7 * i) for i, p in enumerate(PROMPTS)]
    off = engine(model, 1, temperature=temperature)
    outs_off = drive(off, reqs)
    on = engine(model, 6, temperature=temperature)
    assert drive(on, reqs) == outs_off
    assert on.burst_dispatches > 0, "steady state never fused"
    assert on.burst_windows_run >= 2 * on.burst_dispatches
    # A burst counts as ONE engine dispatch.
    assert on.steps_run < off.steps_run
    jsrv = JaxServer(jparams, jcfg, burst_windows=6, temperature=temperature,
                     **_settings())
    assert drive(jsrv, reqs) == outs_off
    assert {c: getattr(on, c) for c in COUNTERS} == {c: getattr(jsrv, c) for c in COUNTERS}


def test_burst_outputs_identical_with_eos(model):
    """A lane that samples its eos mid-burst coasts on the scratch page; the
    output still truncates at the first eos as per-tick detection does."""
    jcfg, jparams, _, _ = model
    reqs = [(p, 30) for p in PROMPTS]
    outs_off = drive(engine(model, 1, eos_id=EOS), reqs)
    on = engine(model, 6, eos_id=EOS)
    outs_on = drive(on, reqs)
    assert outs_on == outs_off
    assert on.burst_dispatches > 0
    assert [len(o) for o in outs_on] == [9, 30, 30] and outs_on[0][-1] == EOS
    jsrv = JaxServer(jparams, jcfg, burst_windows=6, eos_id=EOS, **_settings())
    assert drive(jsrv, reqs) == outs_on


def _window_state(server):
    st = server._tick_state
    return (st.pos, st.step, st.steps_left, server._last_dev)


def test_eos_carry_coasts_the_lane(model):
    """Inside one dispatch a lane that sampled its eos writes nothing more:
    its later rows are 0, its token holds the eos and `_finished` marks it,
    while pos / step / steps_left advance as the host bookkeeping does."""
    server = engine(model, 1, steps_per_dispatch=8)
    futs = steady(server, [(PROMPTS[0], 40)])
    server._sync_tick_state()
    saved = [t.clone() for t in _window_state(server)]
    free = server._macro()[:, 0].tolist()  # no eos_id: all 8 steps run
    advanced = [t.clone() for t in _window_state(server)]
    for t, v in zip(_window_state(server), saved):
        t.copy_(v)
    eos = free[2]
    cut = free.index(eos) + 1
    server.eos_id = eos
    server._finished.zero_()
    carried = server._macro()[:, 0].tolist()
    assert carried[:cut] == free[:cut] and carried[cut:] == [0] * (8 - cut)
    assert bool(server._finished[0]) and int(server._last_dev[0]) == eos
    for t, v in zip(_window_state(server)[:3], advanced[:3]):
        assert torch.equal(t, v)
    finish(server, futs)


# -- the steady-state host-sync budget (counter-gated) ----------------------------
def test_steady_state_budget_one_staging_upload_per_burst(model):
    server = engine(model, 4, steps_per_dispatch=2)
    futs = steady(server, [(p, 40) for p in PROMPTS])
    b0, s0, u0 = server.burst_dispatches, server.staging_syncs, server.h2d_uploads
    server._tick()
    assert server.burst_dispatches == b0 + 1, "steady tick did not burst"
    # At most one packed sync per burst, and the sync is the only upload.
    assert server.staging_syncs - s0 <= 1
    assert server.h2d_uploads - u0 == server.staging_syncs - s0
    # A second burst runs from the device-advanced state: no upload, no read.
    b1, u1, bl1 = server.burst_dispatches, server.h2d_uploads, server.blocking_syncs
    server._tick()
    assert server.burst_dispatches == b1 + 1
    assert server.h2d_uploads == u1
    assert server.blocking_syncs == bl1
    finish(server, futs)


def test_per_tick_macro_uploads_nothing_when_state_clean(model):
    server = engine(model, 1, steps_per_dispatch=2)
    futs = steady(server, [(p, 40) for p in PROMPTS])
    server._tick()  # absorb any pending host event into one sync
    u0, m0 = server.h2d_uploads, server.macro_dispatches
    for _ in range(3):
        server._tick()
    assert server.macro_dispatches == m0 + 3
    assert server.h2d_uploads == u0
    assert server.burst_dispatches == 0
    finish(server, futs)


# -- the plan's degrade rules -------------------------------------------------------
def test_burst_plan_degrades_and_caps(model):
    server = engine(model, 4, steps_per_dispatch=4)
    futs = steady(server, [(p, 40) for p in PROMPTS])
    macro = [i for i, s in enumerate(server._slots) if s.phase == "decoding"]
    rem = max(min(s.remaining, server.max_len - s.pos) for s in server._slots)
    assert server._burst_plan(macro, 0) == min(4, -(-rem // 4)) >= 2
    assert server._burst_plan(macro, 1) == 0  # a prefill dispatched this tick
    assert server._burst_plan(macro[:-1], 0) == 0  # an active slot not decoding
    queued = server.submit(PROMPTS[0], max_new=4)
    assert server._burst_plan(macro, 0) == 0  # a queued request
    server._drain_queue()
    assert server._waiting and server._burst_plan(macro, 0) == 0  # a waiting one
    server._waiting.clear()
    assert server._burst_plan(macro, 0) >= 2
    for s in server._slots:  # one window of work left: no burst
        s.remaining = min(s.remaining, 4)
    assert server._burst_plan(macro, 0) == 0
    server._slots[0].remaining = 9  # ceil(9 / 4) = 3 windows
    assert server._burst_plan(macro, 0) == 3
    server._closed.set()  # draining or stopping
    assert server._burst_plan(macro, 0) == 0
    assert engine(model, 1)._burst_plan(macro, 0) == 0
    queued.cancel()
    finish(server, futs)


def test_default_engine_bursts_with_four_windows(model):
    _, _, tcfg, tparams = model
    # The tick phases are timed by the profiler a tracing bundle arms.
    server = DecodeServer(tparams, tcfg, device="cpu", n_slots=2, max_len=64,
                          tracing=EngineTracing())
    assert server.burst_windows == 4
    out = drive(server, [(PROMPTS[0], 30)])[0]
    assert len(out) == 30
    assert server.burst_dispatches > 0 and server.burst_windows_run <= 4 * server.burst_dispatches
    assert server.tick_phase_s["dispatch_burst"] > 0.0
    assert server.graph_captures == server.graph_replays == 0  # the CPU runs eagerly


# -- tensor parallelism ----------------------------------------------------------------
def test_sharded_eos_bursts_identical(model):
    """The reference's test_sharded_eos_bursts_bit_identical on the port:
    the eos carry inside a burst, at tp=2 on a CPU mesh, equals tp=1."""
    reqs = [(p, 30) for p in PROMPTS]
    outs_ref = drive(engine(model, 6, eos_id=EOS), reqs)
    shd = engine(model, 6, mesh=build_mesh({"tp": 2}, devices=["cpu", "cpu"]), eos_id=EOS)
    assert drive(shd, reqs) == outs_ref
    assert shd.burst_dispatches > 0


# -- what a CUDA graph needs, checked on the CPU ------------------------------------------
def _addresses(server):
    st = server._tick_state
    fixed = [st.table, st.pos, st.mask, st.serial, st.step, st.steps_left,
             server._last_dev, server._finished]
    fixed += [t for layer in server.cache.values() for t in layer.values()]
    return [t.data_ptr() for t in fixed]


@pytest.mark.parametrize("kv_dtype", ["fp16", "int8"])
def test_window_state_stays_at_fixed_addresses(model, kv_dtype):
    """Syncs, windows, bursts and an error reset write the window's state in
    place: every buffer keeps its address, as a captured graph requires (an
    int8 pool's scale leaves too)."""
    server = engine(model, 4, steps_per_dispatch=2, kv_dtype=kv_dtype)
    assert len(server.cache["0"]) == (4 if kv_dtype == "int8" else 2)
    before = _addresses(server)
    drive(server, [(p, 12 + 5 * i) for i, p in enumerate(PROMPTS)])
    assert server.burst_dispatches > 0 and server.macro_dispatches > 0
    assert _addresses(server) == before
    server._reset_device_state()
    assert _addresses(server) == before
    assert not server._last_dev.any()
    assert all(not t.any() for layer in server.cache.values() for t in layer.values())
    # After the reset the engine serves the same tokens as a fresh one.
    assert drive(server, [(PROMPTS[1], 9)]) == drive(
        engine(model, 4, steps_per_dispatch=2, kv_dtype=kv_dtype), [(PROMPTS[1], 9)])


@pytest.mark.parametrize("kv_dtype", ["fp16", "int8"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_window_makes_no_host_copy(model, monkeypatch, temperature, kv_dtype):
    """A window builds no tensor from host data (stream capture refuses a
    copy from pageable memory): with torch.tensor and torch.as_tensor
    refusing, a window still runs and gives the same tokens (over an int8
    pool, with the write funnel inside)."""
    # An eos id, so the carry's ops run too (96: not reached before the check).
    server = engine(model, 1, temperature=temperature, eos_id=96, kv_dtype=kv_dtype)
    futs = steady(server, [(p, 40) for p in PROMPTS])
    server._sync_tick_state()
    saved = [t.clone() for t in _window_state(server)]
    want = server._macro()
    for t, v in zip(_window_state(server), saved):
        t.copy_(v)

    def refuse(*args, **kw):
        raise AssertionError("a host tensor built inside the window")

    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", refuse)
    server._finished.zero_()
    got = server._macro()
    monkeypatch.undo()
    assert torch.equal(got, want)
    finish(server, futs)


def test_launch_count_delta_round_trip():
    """The graph's launch bookkeeping: a delta taken from `_launch_counts`
    and added back keeps LAUNCHES the sum of ROUTE_LAUNCHES."""
    before = ds._launch_counts()
    delta = {(tpa, "paged_decode_attention", "split"): 3,
             (tpa, "paged_window_attention", "mma"): 2}
    ds._add_launches(delta)
    after = ds._launch_counts()
    assert {k: n - before[k] for k, n in after.items() if n != before[k]} == delta
    assert tpa.LAUNCHES["paged_decode_attention"] == sum(
        tpa.ROUTE_LAUNCHES["paged_decode_attention"].values())
    ds._add_launches({k: -n for k, n in delta.items()})
    assert ds._launch_counts() == before
