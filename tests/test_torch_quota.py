"""Elastic tenant quotas and preemption in the port's DecodeServer
(nos_tpu_torch/runtime/quota.py; decode_server.py: `_admit_scan`,
`_enforce_quota`, `_preempt_slot`, `_note_quota_tick`, the burst's
per-window fold, `tenant_probe`) against the JAX engine, on the CPU,
mirroring the reference's tests/test_quota_serving.py, the quota cases of
tests/test_burst_decode.py (:193, :264, :301), the tenant pin of
tests/test_quantized_kv.py (:379, :406) and the preemption at tp=2 of
tests/test_sharded_decode.py (:293).

Both engines serve the shared float32 test model (the JAX init carried
across with `from_numpy_params`), each with its own QuotaPolicy built
from the same shares, and are driven tick by tick through `_tick()` on the
same traffic. Every case holds the port to the JAX engine: equal tokens,
equal `preemptions`, `borrowed_ticks`, spills, revives and dispatch
counters, equal quota window entries (tick by tick) and equal
`tenant_probe()` rows; then each side to the reference's own oracle
(preempted streams equal their uninterrupted runs, the pool conserved).
The reference's overload smoke (:434, wall-clock and `slow`) runs here
scaled down and tick by tick, so its preemption is deterministic."""

import dataclasses

import jax
import numpy as np
import pytest

from nos_tpu.parallel.mesh import build_mesh as jax_build_mesh
from nos_tpu.runtime import quota as jquota
from nos_tpu.runtime.decode_server import DecodeServer as JaxServer
from nos_tpu.runtime.faults import DeviceLostError as JaxDeviceLost
from nos_tpu_torch import DecodeServer, GPTConfig, from_numpy_params
from nos_tpu_torch.parallel import build_mesh
from nos_tpu_torch.runtime import quota as tquota
from nos_tpu_torch.runtime.faults import DeviceLostError

from conftest import serving_test_config, serving_test_params

# The counters both engines must agree on after the same traffic.
FLEET = ("preemptions", "borrowed_ticks", "spills", "revives", "spill_host_bytes",
         "recoveries", "slots_restored", "replay_tokens", "steps_run", "macro_dispatches",
         "burst_dispatches", "burst_windows_run", "prefill_dispatches", "prefill_tokens",
         "blocking_syncs", "idle_ticks")
# tests/test_burst_decode.py's prompts.
BURST_PROMPTS = [
    [3, 11, 42, 7, 19, 5, 23, 2, 61, 13],
    [8, 8, 31, 4, 90, 17, 6, 44, 9, 28],
    [55, 1, 2, 3, 70, 70, 12, 39, 80, 10],
]


@pytest.fixture(scope="module")
def model():
    jcfg, jparams = serving_test_config(), serving_test_params()
    tcfg = GPTConfig(**dataclasses.asdict(jcfg))
    tparams = from_numpy_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def policies(shares, window_ticks):
    """The same QuotaPolicy in each package; `shares` maps a tenant to
    TenantShare arguments."""
    return tuple(mod.QuotaPolicy({t: mod.TenantShare(*a) for t, a in shares.items()},
                                 window_ticks=window_ticks)
                 for mod in (jquota, tquota))


def pair(model, shares=None, window_ticks=32, mesh=None, jmesh=None, **kw):
    """The JAX engine and the port's, from the same arguments, each with
    its own policy."""
    jcfg, jparams, tcfg, tparams = model
    jq, tq = policies(shares, window_ticks) if shares else (None, None)
    jsrv = JaxServer(jparams, jcfg, quota=jq, mesh=jmesh, **kw)
    tsrv = DecodeServer(tparams, tcfg, quota=tq, mesh=mesh,
                        device=None if mesh is not None else "cpu", **kw)
    return jsrv, tsrv


def drive(server, pred, n=400):
    for _ in range(n):
        server._tick()
        if pred():
            return True
    return False


def window(server):
    return [dict(e) for e in server._quota._window]


def same_fleet(jsrv, tsrv):
    """The port's fleet state is the JAX engine's."""
    assert {c: getattr(tsrv, c) for c in FLEET} == {c: getattr(jsrv, c) for c in FLEET}
    assert tsrv.tokens_by_tenant == jsrv.tokens_by_tenant
    assert tsrv.admissions_by_tenant == jsrv.admissions_by_tenant
    assert tsrv.tenant_probe() == jsrv.tenant_probe()
    if jsrv._quota is not None:
        assert tsrv._quota.ticks == jsrv._quota.ticks
        assert window(tsrv) == window(jsrv)
        assert tsrv._quota._totals == jsrv._quota._totals


def both(model, scenario, **kw):
    """Run `scenario(server)` on each engine; returns (JAX, port) engines
    and outputs, after holding the port's outputs and fleet state to the
    JAX engine's."""
    jsrv, tsrv = pair(model, **kw)
    jout, tout = scenario(jsrv), scenario(tsrv)
    assert tout == jout
    same_fleet(jsrv, tsrv)
    assert tsrv._block_mgr.conserved()
    return jsrv, tsrv, jout


# -- QuotaPolicy units (test_quota_serving.py:56-103), against the JAX policy ----------------
def test_tenant_share_validates():
    for mod in (jquota, tquota):
        mod.TenantShare(0.2, 0.8)
        with pytest.raises(ValueError, match="min_share"):
            mod.TenantShare(0.8, 0.2)
        with pytest.raises(ValueError, match="min_share"):
            mod.TenantShare(-0.1, 0.5)
        with pytest.raises(ValueError, match="window_ticks"):
            mod.QuotaPolicy({}, window_ticks=0)
        with pytest.raises(ValueError):
            mod.TenantShare(0.0, 1.0, kv_dtype="int4")
    assert tquota.DEFAULT_TENANT == jquota.DEFAULT_TENANT


def _labels(policy, tenants):
    return [(t, policy.usage(t), policy.is_borrower(t), policy.is_starved(t),
             policy.over_ceiling(t), policy.admission_blocked(t, True),
             policy.admission_blocked(t, False)) for t in tenants]


@pytest.mark.parametrize("shares, ticks", [
    ({"g": (0.5, 1.0), "b": (0.0, 0.8)},
     [{"b": 30, "g": 10}] + [{"g": 10}] * 4),
    ({"c": (0.0, 0.3)}, [{"c": 10}, {"": 5}, {}, {"c": 3, "x": 4}]),
    ({"g": (0.5, 1.0), "b1": (0.0, 1.0), "b2": (0.0, 1.0)},
     [{"b1": 60, "b2": 30, "g": 10}, {}, {"g": 1, "x": 99}] * 3),
], ids=["window_slides", "ceiling", "victims"])
def test_policy_matches_the_jax_policy_tick_by_tick(shares, ticks):
    """test_policy_window_shares_and_labels, _ceiling_and_admission_blocking
    and _victim_selection on the same tick sequences: usage, labels,
    admission blocking, borrowed ticks, the window and the victim agree
    with the JAX policy after every tick, idle folds included."""
    jp, tp = policies(shares, window_ticks=4)
    tenants = list(shares) + ["", "x", None]
    candidates = [(i, t, s) for i, (t, s) in enumerate(
        [(t, 3 * k + 1) for k, t in enumerate(list(shares) + [None])])]
    for entry in ticks:
        for p in (jp, tp):
            if entry:
                p.observe_tick(entry)
            else:
                p.observe_idle_tick()
        assert _labels(tp, tenants) == _labels(jp, tenants)
        assert (tp.borrowed_ticks, tp.ticks) == (jp.borrowed_ticks, jp.ticks)
        assert window(type("S", (), {"_quota": tp})) == window(type("S", (), {"_quota": jp}))
        for protect in tenants:
            assert tp.select_victim(candidates, protect) == jp.select_victim(candidates, protect)


def test_policy_units_as_in_the_reference():
    """The reference's literal assertions on the port's policy."""
    P, S = tquota.QuotaPolicy, tquota.TenantShare
    policy = P({"g": S(0.5, 1.0), "b": S(0.0, 0.8)}, window_ticks=4)
    assert policy.usage("g") == 0.0 and policy.is_starved("g") and policy.is_borrower("b")
    policy.observe_tick({"b": 30, "g": 10})
    assert policy.usage("b") == 0.75 and policy.usage("g") == 0.25
    for _ in range(4):
        policy.observe_tick({"g": 10})
    assert policy.usage("b") == 0.0 and policy.usage("g") == 1.0
    assert not policy.is_starved("g") and policy.borrowed_ticks >= 1
    capped = P({"c": S(0.0, 0.3)}, window_ticks=8)
    capped.observe_tick({"c": 10})
    assert capped.over_ceiling("c") and capped.admission_blocked("c", starved_waiting=False)
    assert not capped.over_ceiling("unknown")
    assert capped.admission_blocked("unknown", starved_waiting=True)
    assert not capped.admission_blocked("unknown", starved_waiting=False)
    capped.observe_tick({tquota.DEFAULT_TENANT: 5})
    assert capped.usage(None) == capped.usage(tquota.DEFAULT_TENANT) > 0
    victims = P({"g": S(0.5, 1.0), "b1": S(0.0, 1.0), "b2": S(0.0, 1.0)}, window_ticks=8)
    victims.observe_tick({"b1": 60, "b2": 30, "g": 10})
    assert victims.select_victim([(0, "b1", 1), (1, "b1", 4), (2, "b2", 2), (3, "g", 3)],
                                 "g") == 1
    assert victims.select_victim([(3, "g", 3)], "g") is None


# -- preemption exactness (test_quota_serving.py:226, :265) ---------------------------------
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_preempted_stream_is_identical_to_uninterrupted(model, temperature):
    prompt = [4, 9, 2, 33]
    kw = dict(n_slots=2, max_len=64, prompt_buckets=(8,), block_size=8,
              temperature=temperature, seed=11)

    def solo(server):
        fut = server.submit(prompt, max_new=12)
        assert drive(server, fut.done)
        return fut.result(timeout=5)

    _, _, want = both(model, solo, **kw)

    def preempted(server):
        fut = server.submit(prompt, max_new=12)
        assert drive(server, lambda: server._slots[0].active
                     and server._slots[0].phase == "decoding"
                     and 2 <= len(server._slots[0].refs) < 12, n=64)
        server._preempt_slot(0)
        assert server.preemptions == 1 and len(server._waiting) == 1
        assert server._waiting[0].serial is not None
        assert drive(server, fut.done)
        return fut.result(timeout=5)

    _, tsrv, got = both(model, preempted, **kw)
    assert got == want
    assert tsrv.preemptions == 1 and tsrv.replay_tokens > 0


def test_device_lost_interleaves_with_waiting_preempted_slot_by_serial(model):
    prompts = [[5, 11, 3, 42], [1, 2, 3, 4, 5, 6, 7], [9, 8, 7]]
    kw = dict(n_slots=3, max_len=64, prompt_buckets=(8,), block_size=8)

    def solo(server):
        outs = []
        for p in prompts:
            fut = server.submit(p, max_new=10)
            assert drive(server, fut.done)
            outs.append(fut.result(timeout=5))
        return outs

    _, _, want = both(model, solo, **kw)

    def run(server):
        lost = JaxDeviceLost if isinstance(server, JaxServer) else DeviceLostError
        futs = [server.submit(p, max_new=10) for p in prompts]
        assert drive(server, lambda: all(
            s.active and s.phase == "decoding" and 0 < len(s.refs) < 10
            for s in server._slots), n=64)
        server._preempt_slot(1)
        assert [r.serial for r in server._waiting] == [2]
        server._recover(lost("mid-flight"))
        assert [r.serial for r in server._waiting] == [1, 2, 3]
        assert drive(server, lambda: all(f.done() for f in futs))
        return [f.result(timeout=5) for f in futs]

    _, _, got = both(model, run, **kw)
    assert got == want


# -- elastic quotas end to end (test_quota_serving.py:306, :353, :376) ----------------------
QUOTA_KW = dict(shares={"g": (0.6, 1.0), "b": (0.0, 1.0)}, window_ticks=32, n_slots=2,
                max_len=64, prompt_buckets=(8,), block_size=8, total_blocks=1 + 7)
BP, GP = [5, 11, 3, 42, 7, 9, 2, 1], [40, 41, 42]


def test_guaranteed_tenant_preempts_borrower_and_both_finish_exact(model):
    def run(server):
        fb = server.submit(BP, max_new=40, tenant="b")  # 6 of 7 blocks
        assert drive(server, lambda: any(
            s.active and s.phase == "decoding" and len(s.refs) >= 4 for s in server._slots),
            n=64)
        fg = server.submit(GP, max_new=10, tenant="g")  # needs 2: cannot fit
        assert drive(server, lambda: fg.done() and fb.done())
        return [fg.result(5), fb.result(5)]

    _, tsrv, got = both(model, run, **QUOTA_KW)
    assert tsrv.preemptions >= 1 and tsrv.borrowed_ticks > 0

    def solo(server):
        outs = []
        for p, n in ((BP, 40), (GP, 10)):
            fut = server.submit(p, max_new=n)
            assert drive(server, fut.done)
            outs.append(fut.result(5))
        return outs[::-1]

    _, _, want = both(model, solo, n_slots=2, max_len=64, prompt_buckets=(8,), block_size=8)
    assert got == want


def test_ceiling_blocked_tenant_is_skipped_in_place(model):
    def run(server):
        for _ in range(2):
            server._quota.observe_tick({"c": 50})  # c is at its ceiling
        fc = server.submit([1, 2, 3], max_new=4, tenant="c")
        fd = server.submit([4, 5, 6], max_new=4)
        server._tick()
        # The single slot went to the later, unblocked request.
        assert server._slots[0].active and server._slots[0].tenant is None
        assert len(server._waiting) == 1
        assert drive(server, lambda: fc.done() and fd.done())
        return [fc.result(5), fd.result(5)]

    _, _, got = both(model, run, shares={"c": (0.0, 0.3)}, window_ticks=4, n_slots=1,
                     max_len=64, prompt_buckets=(8,), block_size=8)
    assert all(got)


def test_preemption_restores_preserve_tenant_accounting(model):
    def run(server):
        fb = server.submit(BP, max_new=40, tenant="b")
        assert drive(server, lambda: any(s.active and len(s.refs) >= 4
                                         for s in server._slots), n=64)
        fg = server.submit(GP, max_new=10, tenant="g")
        assert drive(server, lambda: server.preemptions >= 1, n=64)
        assert any(r.tenant == "b" for r in server._waiting)
        rows = server.tenant_probe()
        assert rows["b"]["waiting"] == 1
        assert drive(server, lambda: fg.done() and fb.done())
        return [fg.result(5), fb.result(5)]

    _, tsrv, _ = both(model, run, **QUOTA_KW)
    # Decode tokens bill their own tenant; the restore's first token comes
    # from its replayed prefill, not a decode window.
    assert tsrv.tokens_by_tenant["g"] == 9 and tsrv.tokens_by_tenant["b"] == 38


def test_overload_smoke_guaranteed_tenant_is_protected(model):
    """test_quota_serving.py:434 scaled down and tick by tick: three
    borrowers of 16 tokens x 24 new fill both slots and the whole pool;
    with the quota armed the guaranteed tenant lands through preemption
    and its output equals the quota-off run's; without it the guarantee
    waits out a borrower."""
    borrower = [[((i * 7 + s) % 91) + 1 for i in range(16)] for s in range(3)]
    gp = [40, 41, 42, 43]
    kw = dict(n_slots=2, max_len=64, prompt_buckets=(8, 16), block_size=8,
              total_blocks=1 + 10)

    def run(server):
        fbs = [server.submit(p, max_new=24, tenant="b") for p in borrower]
        for _ in range(6):  # the borrowers occupy the engine
            server._tick()
        fg = server.submit(gp, max_new=8, tenant="g")
        ticks = 0
        while not fg.done():
            server._tick()
            ticks += 1
            assert ticks < 2000
        assert drive(server, lambda: all(f.done() for f in fbs), n=2000)
        return [fg.result(5), ticks] + [f.result(5) for f in fbs]

    _, on, got_on = both(model, run, shares={"g": (0.5, 1.0), "b": (0.0, 1.0)},
                         window_ticks=64, **kw)
    _, off, got_off = both(model, run, **kw)
    assert got_on[0] == got_off[0] and got_on[2:] == got_off[2:]
    assert on.preemptions >= 1 and on.borrowed_ticks > 0 and off.preemptions == 0
    assert got_on[1] < got_off[1]  # the guarantee finished in fewer ticks
    assert on._block_mgr.conserved()


# -- bursts (test_burst_decode.py:193, :264, :301) --------------------------------------------
def test_mid_burst_preemption_is_identical(model):
    """A preemption landing while a burst's refs are in flight: the
    checkpoint materializes through them, the spill copies follow the
    windows, and the borrower's replayed stream equals the uninterrupted
    one."""
    kw = dict(shares={"gold": (0.6, 1.0), "free": (0.0, 1.0)}, window_ticks=32, n_slots=2,
              total_blocks=8, max_len=48, prompt_buckets=(8, 16), block_size=8,
              steps_per_dispatch=4, burst_windows=6)

    def run(interfere):
        def scenario(server):
            fut = server.submit(BURST_PROMPTS[0], max_new=36, tenant="free")
            gold = None
            for i in range(3000):
                server._tick()
                if i == 1 and interfere:
                    assert server.burst_dispatches > 0 and server._inflight
                    gold = server.submit(BURST_PROMPTS[1], max_new=8, tenant="gold")
                if fut.done() and (gold is None or gold.done()):
                    break
            return [fut.result(5)] + ([gold.result(5)] if gold else [])
        return scenario

    _, s_solo, solo = both(model, run(False), **kw)
    _, s_pre, pre = both(model, run(True), **kw)
    assert pre[0] == solo[0]
    assert s_pre.preemptions >= 1 and s_solo.burst_dispatches > 0


def test_burst_folds_quota_window_per_fused_window(model):
    """The window clock advances once per fused window, from the counts the
    windows wrote on the device, in agreement with the host's nominal
    bookkeeping; the counts cost one blocking read per quota-armed burst,
    and none without a quota."""
    kw = dict(n_slots=3, max_len=96, prompt_buckets=(8, 16), block_size=8,
              steps_per_dispatch=2, burst_windows=4)

    def run(server):
        fut = server.submit(BURST_PROMPTS[0], max_new=32, tenant="t")
        syncs = []
        for _ in range(50):
            before = server.blocking_syncs
            server._tick()
            syncs.append(server.blocking_syncs - before)
            if server.burst_dispatches:
                break
        assert server.burst_dispatches == 1
        n = server.burst_windows_run
        assert n >= 2
        out = [n, syncs[-1]]
        if server._quota is not None:
            folded = window(server)[-n:]
            assert sum(e.get("t", 0) for e in folded) == n * server.steps_per_dispatch
            out.append(folded)
        fut.cancel()
        return out

    _, tsrv, on = both(model, run, shares={"t": (0.2, 1.0)}, window_ticks=64, **kw)
    _, _, off = both(model, run, **kw)
    assert on[1] == off[1] + 1  # the burst's one counts read
    # The port's counts buffer holds each window's executed steps per lane.
    assert tsrv._burst_counts[: on[0], 0].tolist() == [2] * on[0]


def test_idle_ticks_are_o1_and_allocation_free(model):
    class Counting:
        def __init__(self):
            self.calls = 0

        def inc(self, name, value=1, **kw):
            self.calls += 1

        def set_gauge(self, name, value, **kw):
            self.calls += 1

        def observe(self, name, value, **kw):
            self.calls += 1

    def run(server):
        fut = server.submit(BURST_PROMPTS[0], max_new=6, tenant="t")
        assert drive(server, fut.done)
        server._tick()
        server._tick()
        assert server._engine_idle
        calls0, idle0, ticks0 = server.metrics.calls, server.idle_ticks, server._quota.ticks
        for _ in range(20):
            server._tick()
        assert server.idle_ticks == idle0 + 20
        assert server._quota.ticks == ticks0 + 20
        assert server.metrics.calls == calls0  # nothing published while idle
        entries = list(server._quota._window)
        assert len({id(e) for e in entries[-20:]}) == 1 and not entries[-1]
        fut2 = server.submit(BURST_PROMPTS[1], max_new=4, tenant="t")
        assert drive(server, fut2.done)
        return [fut.result(5), fut2.result(5)]

    jsrv, tsrv = pair(model, shares={"t": (0.5, 1.0)}, window_ticks=8, n_slots=3, max_len=96,
                      prompt_buckets=(8, 16), block_size=8, steps_per_dispatch=4)
    jsrv.metrics, tsrv.metrics = Counting(), Counting()
    assert run(tsrv) == run(jsrv)
    same_fleet(jsrv, tsrv)
    assert tsrv.metrics.calls == jsrv.metrics.calls


# -- the tenant pin (test_quantized_kv.py:379, :406) ------------------------------------------
def test_tenant_pin_rejected_at_engine_ingress(model):
    shares = {"exact": (0.0, 1.0, "fp16"), "cheap": (0.0, 1.0, "int8"), "any": (0.0, 1.0)}

    def run(server):
        with pytest.raises(ValueError, match="pinned to kv_dtype"):
            server.submit(BURST_PROMPTS[0], max_new=2, tenant="exact")
        futs = [server.submit(BURST_PROMPTS[0], max_new=2, tenant="cheap"),
                server.submit(BURST_PROMPTS[1], max_new=2, tenant="any")]
        assert drive(server, lambda: all(f.done() for f in futs), n=2000)
        return [f.result(5) for f in futs]

    _, _, got = both(model, run, shares=shares, window_ticks=8, kv_dtype="int8",
                     n_slots=2, max_len=64, prompt_buckets=(8, 16), block_size=8)
    assert all(len(o) == 2 for o in got)


# -- preemption over an int8 pool, and at tp=2 (test_sharded_decode.py:293) ------------------
def _gold_run(server, prompt, gold_prompt, max_new=36):
    fut = server.submit(prompt, max_new=max_new, tenant="free")
    gold = None
    for i in range(3000):
        server._tick()
        if i == 1:
            gold = server.submit(gold_prompt, max_new=6, tenant="gold")
        if fut.done() and gold.done():
            break
    return [fut.result(5), gold.result(5)]


GOLD_KW = dict(shares={"gold": (0.6, 1.0), "free": (0.0, 1.0)}, window_ticks=32, n_slots=2,
               total_blocks=8, max_len=48, prompt_buckets=(8, 16), block_size=8,
               steps_per_dispatch=4, burst_windows=6)


def test_preemption_over_an_int8_pool(model):
    """The int8 pool's preemption spills tagged 5-tuple payloads and
    revives them: the port equals the JAX int8 engine, and its preempted
    stream equals its own uninterrupted run."""
    def run(server):
        return _gold_run(server, BURST_PROMPTS[2], BURST_PROMPTS[1][:8])

    _, tsrv, got = both(model, run, kv_dtype="int8", **GOLD_KW)
    assert tsrv.preemptions >= 1 and tsrv.spills > 0 and tsrv.revives > 0
    payload, nbytes = tsrv._extract_block(1)  # the spill tier's reader
    assert payload[0] == "int8" and len(payload) == 5
    assert nbytes == tsrv._bytes_per_block

    def solo(server):
        fut = server.submit(BURST_PROMPTS[2], max_new=36, tenant="free")
        assert drive(server, fut.done, n=3000)
        return fut.result(5)

    _, _, want = both(model, solo, kv_dtype="int8", **GOLD_KW)
    assert got[0] == want


def test_preemption_spill_bytes_pool_logical_at_tp2(model):
    """Quota preemption at tp=2 on a CPU mesh: the spilled payloads are
    full-width gathers, so spills, host bytes and revives equal tp=1's (and
    the JAX engine's at tp=1 and tp=2), and the preempted stream is
    identical."""
    def run(server):
        return _gold_run(server, BURST_PROMPTS[2], BURST_PROMPTS[1][:8])

    jsrv, one, out1 = both(model, run, **GOLD_KW)
    mesh = build_mesh({"tp": 2}, devices=["cpu", "cpu"])
    jmesh = jax_build_mesh({"tp": 2}, devices=jax.devices()[:2])
    j2, two, out2 = both(model, run, mesh=mesh, jmesh=jmesh, **GOLD_KW)
    assert out2 == out1
    assert two.preemptions >= 1 and two.preemptions == one.preemptions
    assert one.spills > 0 and two.spills == one.spills
    assert two.spill_host_bytes == one.spill_host_bytes == jsrv.spill_host_bytes
    assert two.revives == one.revives
