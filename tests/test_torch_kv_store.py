"""The port's fleet KV store (nos_tpu_torch/serving/kv_store.py) and the
engine hooks it drives (decode_server.py: `kv_store=`, the write-through
publish, `prewarm_from_store`/`_pump_prewarm`, store revives, failover
revives, the store counters) against the JAX package, on the CPU,
mirroring tests/test_kv_store.py and the fleet-store case of
tests/test_quantized_kv.py:504.

The store and tier unit tests run on both packages' classes. The engine
cases run one scenario on each side (tests/test_torch_fleet_parity.py) and hold the
port to the JAX engine: equal tokens, equal `collect_serving` counters,
equal store entries, bytes, pins and keys, equal router snapshots; then
each side to the reference's own oracles (a shared-store hit equals a
cold run, the store conserved with no leaked pin)."""

import random
import threading

import numpy as np
import pytest
import torch

import test_torch_fleet_parity as fp
from test_block_manager import check_invariants

from nos_tpu.runtime import block_manager as jbm
from nos_tpu.serving import kv_store as jkv
from nos_tpu_torch.runtime import block_manager as tbm
from nos_tpu_torch.serving import kv_store as tkv

KV = pytest.mark.parametrize("kv", [jkv, tkv], ids=["jax", "torch"])
KV_BM = pytest.mark.parametrize("kv, bm", [(jkv, jbm), (tkv, tbm)], ids=["jax", "torch"])

# 24 tokens / block_size 8: cacheable_block_cap(24, 8) == 2 store-hittable
# blocks plus the always-recomputed last-token block.
DONOR = [((i * 5) % 91) + 1 for i in range(24)]
STORE_ENGINE = dict(total_blocks=1 + 8)


@pytest.fixture(scope="module")
def both():
    return fp.sides()


def store_engine(side, store=None, **kw):
    return fp.engine(side, store=store, **dict(STORE_ENGINE, **kw))


# -- FleetKVStore units (test_kv_store.py:89-230) -----------------------------------
@KV
def test_store_put_get_dedup_and_counters(kv):
    store = kv.FleetKVStore(capacity_bytes=1 << 10)
    assert store.put("a", "pa", 16, parent="", tokens=(1, 2)) == kv.PUT_STORED
    assert store.put("b", "pb", 16, parent="a", tokens=(3, 4)) == kv.PUT_STORED
    assert "a" in store and len(store) == 2
    assert store.get("a") == "pa"
    assert store.meta("b") == ("a", (3, 4))
    assert store.meta("zz") is None
    assert store.put("a", "pa", 16) == kv.PUT_DEDUP
    assert store.entries == 2 and store.host_bytes == 32
    assert store.puts == 3 and store.dedup_hits == 1
    assert store.conserved()
    with pytest.raises(ValueError, match="capacity_bytes"):
        kv.FleetKVStore(capacity_bytes=0)
    assert (kv.PUT_STORED, kv.PUT_DEDUP, kv.PUT_REFUSED) == (
        jkv.PUT_STORED, jkv.PUT_DEDUP, jkv.PUT_REFUSED)


@KV
def test_store_overwrite_byte_balance(kv):
    store = kv.FleetKVStore(capacity_bytes=1 << 10)
    store.put("k", "small", 16)
    assert store.host_bytes == 16
    store.put("k", "large", 48)
    assert store.host_bytes == 48 and store.entries == 1
    store.put("k", "tiny", 8)
    assert store.host_bytes == 8 and store.entries == 1
    assert store.conserved()
    store.pin("k")
    assert store.put("k", "huge", 1 << 11) == kv.PUT_REFUSED
    assert "k" not in store and store.host_bytes == 0
    assert store.pinned_entries == 0
    assert store.conserved()


@pytest.mark.parametrize("spill", ["jax", "torch"])
def test_spill_tier_overwrite_byte_balance(both, spill):
    side = both[0] if spill == "jax" else both[1]
    tier = side.SpillTier(capacity_bytes=1 << 10)
    tier.put("k", "small", 16)
    tier.put("k", "large", 48)
    assert tier.host_bytes == 48 and len(tier) == 1
    tier.put("k", "tiny", 8)
    assert tier.host_bytes == 8 and len(tier) == 1
    assert tier.conserved()
    tier.put("m", "pm", 16, parent="k", tokens=(1, 2, 3))
    assert tier.host_bytes == 24
    assert tier.is_shared is False
    tier.stage(["k"])
    tier.unstage(["k"])
    tier.unstage_all()
    assert tier.conserved()


@KV
def test_store_lru_retirement_skips_pins(kv):
    store = kv.FleetKVStore(capacity_bytes=48)
    store.put("a", "pa", 16)
    store.put("b", "pb", 16)
    store.put("c", "pc", 16)
    assert store.pin("b")
    store.put("d", "pd", 16)
    assert "a" not in store and "b" in store
    assert store.drops == 1 and store.conserved()
    store.put("e", "pe", 16)
    assert "b" in store and "c" not in store
    assert store.conserved()
    for k in ("d", "e"):
        assert store.pin(k)
    store.put("f", "pf", 16)
    assert "f" not in store and store.host_bytes == 48
    assert store.conserved()
    store.put("b", "pb2", 32)
    assert store.host_bytes == 64 > store.capacity_bytes
    assert store.conserved()
    for k in ("b", "d", "e"):
        store.unpin(k)
    store.put("i", "pi", 16)
    assert store.host_bytes <= store.capacity_bytes
    assert store.conserved()


@KV
def test_store_pin_discard_unpin_reset(kv):
    store = kv.FleetKVStore(capacity_bytes=1 << 10)
    store.put("a", "pa", 16)
    assert not store.pin("missing")
    assert store.pin("a") and store.pin("a")
    store.discard("a")
    assert "a" in store
    store.unpin("a")
    store.discard("a")
    assert "a" in store
    store.unpin("a")
    store.unpin("a")
    store.discard("a")
    assert "a" not in store and store.host_bytes == 0
    assert store.take_pinned("a") is None and store.misses == 1
    store.put("b", "pb", 16)
    assert store.take_pinned("b") == "pb" and store.hits == 1
    assert store.pinned_entries == 1
    store.reset()
    assert store.entries == 0 and store.pinned_entries == 0
    assert store.host_bytes == 0 and store.conserved()


@KV
def test_store_hot_keys_are_mru_first_and_ancestor_closed(kv):
    store = kv.FleetKVStore(capacity_bytes=1 << 10)
    store.put("r0", "p", 16, parent="", tokens=(1,))
    store.put("r1", "p", 16, parent="r0", tokens=(2,))
    store.put("r2", "p", 16, parent="r1", tokens=(3,))
    store.put("x1", "p", 16, parent="x0", tokens=(9,))
    assert store.hot_keys() == ["r2", "r1", "r0"]
    assert store.hot_keys(limit=2) == ["r2", "r1"]
    store.take_pinned("r0")
    store.unpin("r0")
    assert store.hot_keys()[0] == "r0"


@KV
def test_store_conserved_detects_violations(kv):
    store = kv.FleetKVStore(capacity_bytes=1 << 10)
    store.put("a", "pa", 16)
    assert store.conserved()
    store._store_bytes += 1
    assert not store.conserved()
    store._store_bytes -= 1
    store._pins["ghost"] = 1
    assert not store.conserved()
    del store._pins["ghost"]
    assert store.conserved()


# -- StoreTier (test_kv_store.py:235-312) --------------------------------------------
@KV
def test_store_tier_take_reads_without_removing(kv):
    store = kv.FleetKVStore(capacity_bytes=1 << 10)
    t1, t2 = kv.StoreTier(store), kv.StoreTier(store)
    t1.put("a", "pa", 16, parent="", tokens=(1,))
    assert t1.spills == 1 and t1.store_puts == 1
    t2.put("a", "pa", 16)
    assert t2.store_dedup_hits == 1 and store.entries == 1
    assert t1.take("a") == "pa"
    assert t2.take("a") == "pa"
    assert "a" in store and store.pinned_entries == 0
    assert t1.revives == 1 and t1.store_hits == 1
    assert t2.take("zz") is None and t2.store_misses == 1
    t1.put("big", "pb", 1 << 11)
    assert t1.drops == 1
    assert t1.conserved() and t2.conserved()


@KV
def test_store_tier_take_returns_readonly_views(kv):
    """The reference's rule on numpy payloads, unchanged in the port:
    zero-copy read-only views, the accounting untouched."""
    store = kv.FleetKVStore(capacity_bytes=1 << 12)
    t1, t2 = kv.StoreTier(store), kv.StoreTier(store)
    k = np.arange(32, dtype=np.float32).reshape(2, 16)
    v = -np.arange(32, dtype=np.float32).reshape(2, 16)
    t1.put("kv", (k, v), k.nbytes + v.nbytes, parent="", tokens=(1, 2))
    gk, gv = t1.take("kv")
    assert np.shares_memory(gk, k) and np.shares_memory(gv, v)
    assert np.array_equal(gk, k) and np.array_equal(gv, v)
    with pytest.raises(ValueError, match="read-only"):
        gk[0, 0] = 99.0
    own = gk.copy()
    own[0, 0] = 99.0
    assert store.get("kv")[0][0, 0] == 0.0
    assert store.entries == 1 and store.host_bytes == k.nbytes + v.nbytes
    assert store.pinned_entries == 0
    t2.put("kv", (k, v), k.nbytes + v.nbytes)
    assert t2.store_dedup_hits == 1 and store.entries == 1
    assert np.shares_memory(t2.take("kv")[0], k)
    assert t1.revives == 1 and t1.store_hits == 1
    assert t1.conserved() and t2.conserved() and store.conserved()
    t1.put("s", "plain", 8)
    assert t1.take("s") == "plain"


def test_store_tier_take_passes_tensor_payloads_through():
    """The port's payloads are CPU tensors, which have no read-only flag:
    `take` returns the stored tensors themselves (the same storage, no
    copy) for every reader, the tagged int8 tuple's tag included."""
    store = tkv.FleetKVStore(capacity_bytes=1 << 12)
    t1, t2 = tkv.StoreTier(store), tkv.StoreTier(store)
    k = torch.arange(32, dtype=torch.bfloat16).reshape(2, 16)
    v = -k
    t1.put("kv", (k, v), 128, parent="", tokens=(1, 2))
    for tier in (t1, t2):
        gk, gv = tier.take("kv")
        assert gk.data_ptr() == k.data_ptr() and gv.data_ptr() == v.data_ptr()
    q = torch.zeros((2, 16), dtype=torch.int8)
    s = torch.ones((2,), dtype=torch.float32)
    t1.put("q", ("int8", q, q, s, s), 80)
    got = t2.take("q")
    assert got[0] == "int8" and got[1].data_ptr() == q.data_ptr()
    assert store.pinned_entries == 0 and store.conserved()


@KV
def test_store_tier_stage_discard_reset_release_only_own_pins(kv):
    store = kv.FleetKVStore(capacity_bytes=1 << 10)
    t1, t2 = kv.StoreTier(store), kv.StoreTier(store)
    t1.put("a", "pa", 16)
    t1.put("b", "pb", 16)
    t1.stage(["a", "b", "missing"])
    t2.stage(["a"])
    assert t1.staged_pins == 2 and t2.staged_pins == 1
    assert store.pinned_entries == 2
    t1.discard("a")
    assert "a" in store and t1.staged_pins == 1
    assert store.pinned_entries == 2
    assert t1.take("b") == "pb"
    assert t1.staged_pins == 0 and store.pinned_entries == 1
    t2.reset()
    assert store.pinned_entries == 0
    assert "a" in store and "b" in store
    assert store.conserved()


# -- concurrency: the seeded hammer (test_kv_store.py:318-377) ------------------------
@KV
def test_store_hammer_conserves_under_thread_chaos(kv):
    store = kv.FleetKVStore(capacity_bytes=24 * 16)
    keys = [f"k{i:02d}" for i in range(40)]

    def payload_of(key):
        return ("pay-" + key) * 3

    errors = []

    def worker(seed):
        rng = random.Random(seed)
        try:
            for step in range(400):
                key = rng.choice(keys)
                op = rng.random()
                if op < 0.5:
                    store.put(key, payload_of(key), 16)
                elif op < 0.85:
                    payload = store.take_pinned(key)
                    if payload is not None:
                        assert payload == payload_of(key)
                        if rng.random() < 0.3:
                            other = rng.choice(keys)
                            store.put(other, payload_of(other), 16)
                        assert key in store
                        store.unpin(key)
                else:
                    store.discard(key)
                if step % 50 == 0:
                    assert store.conserved()
        except Exception as exc:  # surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert store.conserved()
    assert store.pinned_entries == 0
    assert store.host_bytes <= store.capacity_bytes
    assert store.hits > 0 and store.drops > 0


@KV
def test_store_hammer_put_payload_is_key_correct(kv):
    store = kv.FleetKVStore(capacity_bytes=1 << 10)
    store.put("k01", ("pay-" + "k01") * 3, 16)
    assert store.get("k01") == "pay-k01pay-k01pay-k01"


# -- two BlockManagers over one store (test_kv_store.py:383-475) ----------------------
BS = 4


def n_blocks_for(prompt_len, max_new):
    return -(-(prompt_len + max_new) // BS)


def mk_shared_pair(kv, bm, total=1 + 8, n_slots=2, capacity_bytes=1 << 12):
    store = kv.FleetKVStore(capacity_bytes)
    mgrs = []
    for _ in range(2):
        mgr = bm.BlockManager(total, BS, n_slots)
        mgr.attach_spill(kv.StoreTier(store), lambda block: (f"kv-{block}", 16))
        mgrs.append(mgr)
    return store, mgrs


@KV_BM
def test_shared_tier_dedup_and_cross_manager_hits(kv, bm):
    store, (m1, m2) = mk_shared_pair(kv, bm)
    donor = list(range(12))
    m1.admit(0, donor, n_blocks_for(12, 4))
    m1.note_progress(0, 12)
    keys = m1.prompt_keys(donor)
    assert m1.publish_to_tier() == 3
    assert m1.counts()["cached"] == 0 and m1.counts()["in_use"] == 4
    assert store.entries == 3
    blocks, n_hit = m2.admit(0, donor, n_blocks_for(12, 4))
    assert n_hit == 0
    revives = m2.claim_revives(0)
    assert [k for _, _, k in revives] == keys[:2]
    assert m2.spill_hit_blocks == 2
    assert store.pinned_entries == 2
    for _, _, key in revives:
        assert m2._spill.take(key) is not None
    assert store.pinned_entries == 0
    assert store.entries == 3
    m2.note_progress(0, 12)
    assert m2.publish_to_tier() == 0
    assert store.entries == 3
    check_invariants(m1)
    check_invariants(m2)
    assert store.conserved()


def _two_manager_traffic(kv, bm):
    rng = random.Random(20160807)
    store, mgrs = mk_shared_pair(kv, bm, total=1 + 10, n_slots=3)
    pool = [list(range(n)) for n in (8, 10, 13)] + [
        [7] * 9, [1, 2, 3, 4, 9, 9, 9, 9, 5, 5, 5, 5]]
    trace = []
    for _ in range(60):
        mgr = mgrs[rng.randrange(2)]
        slot = rng.randrange(3)
        if mgr._slot_blocks[slot]:
            mgr.release(slot, spill=rng.random() < 0.5)
        else:
            prompt = rng.choice(pool)
            got = mgr.admit(slot, prompt, n_blocks_for(len(prompt), 4))
            if got is not None:
                for _, _, key in mgr.claim_revives(slot):
                    mgr._spill.take(key)
                mgr.note_progress(slot, len(prompt))
                if rng.random() < 0.4:
                    mgr.publish_to_tier(rng.randrange(0, 3))
        if rng.random() < 0.15:
            mgr.reset()
        for m in mgrs:
            check_invariants(m)
        assert store.conserved()
        if all(not m._slot_blocks[s] for m in mgrs for s in range(3)):
            assert store.pinned_entries == 0
        trace.append((fp.store_state(store), [m.counts() for m in mgrs]))
    for m in mgrs:
        for s in range(3):
            if m._slot_blocks[s]:
                m.release(s)
        m.reset()
        check_invariants(m)
    assert store.pinned_entries == 0
    assert store.conserved()
    return trace


def test_randomized_two_manager_pool_conserves():
    """The seeded two-manager traffic over one store: the invariants on
    each package, and the port's store and pools step for step the JAX
    package's."""
    assert _two_manager_traffic(tkv, tbm) == _two_manager_traffic(jkv, jbm)


# -- the engine datapath (test_kv_store.py:481-590) ------------------------------------
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_shared_store_hit_bit_identical_to_cold(both, temperature):
    def scenario(side):
        store = side.kv_store.FleetKVStore(capacity_bytes=1 << 24)
        a = store_engine(side, store, temperature=temperature)
        (out_a,) = fp.run(a, [DONOR])
        a.stop()
        assert a.store_published_blocks > 0
        assert store.entries >= side.block_manager.cacheable_block_cap(len(DONOR), 8)
        cold = store_engine(side, temperature=temperature)
        (out_cold,) = fp.run(cold, [DONOR])
        cold.stop()
        b = store_engine(side, store, temperature=temperature)
        (out_b,) = fp.run(b, [DONOR])
        b.stop()
        assert out_b == out_cold == out_a
        assert b.store_hits == 2 and b.revives == b.store_hits
        assert store.conserved() and store.pinned_entries == 0
        return (out_a, out_b, fp.counters(side, a), fp.counters(side, b),
                fp.store_state(store))

    fp.twin(both, scenario)


def test_revives_by_several_engines_leave_the_stored_bytes(both):
    """Trouble spot of the port's payloads (CPU tensors, no read-only flag):
    after three engines revived from one store, every stored tensor holds
    the bytes that were put, and `take` hands out the stored storage."""
    side = both[1]
    store = tkv.FleetKVStore(capacity_bytes=1 << 24)
    a = store_engine(side, store)
    want = fp.run(a, [DONOR])
    a.stop()
    snapshot = {k: tuple(t.clone() for t in store.get(k)) for k in store.keys()}
    for _ in range(3):
        b = store_engine(side, store)
        assert fp.run(b, [DONOR]) == want
        assert b.store_hits == 2
        b.stop()
    for k, saved in snapshot.items():
        payload = store.get(k)
        assert all(torch.equal(t, s) for t, s in zip(payload, saved)), k
        tier = tkv.StoreTier(store)
        assert [t.data_ptr() for t in tier.take(k)] == [t.data_ptr() for t in payload]
    assert store.conserved() and store.pinned_entries == 0


def test_prewarm_from_store_warms_turn_one(both):
    def scenario(side):
        store = side.kv_store.FleetKVStore(capacity_bytes=1 << 24)
        a = store_engine(side, store)
        (out_a,) = fp.run(a, [DONOR])
        a.stop()
        c = store_engine(side, store)
        queued = c.prewarm_from_store()
        assert queued >= 2
        pending = [list(e[1]) for e in c._pending_prewarm]
        for _ in range(50):
            if not c._pending_prewarm:
                break
            c._tick()
        assert not c._pending_prewarm
        assert c.prewarm_tokens == queued * 8
        warm_hits = c.store_hits
        assert warm_hits == queued
        (out_c,) = fp.run(c, [DONOR])
        c.stop()
        assert out_c == out_a
        assert c.prefix_hit_tokens >= 16
        assert c.store_hits == warm_hits
        assert store.conserved() and store.pinned_entries == 0
        assert c._block_mgr.conserved()
        return out_c, queued, pending, fp.counters(side, c), fp.store_state(store)

    fp.twin(both, scenario)


def test_replica_set_add_prewarms_from_store(both):
    def scenario(side):
        store = side.kv_store.FleetKVStore(capacity_bytes=1 << 24)
        a = store_engine(side, store)
        fp.run(a, [DONOR])
        a.stop()
        rs = side.replica.ReplicaSet([a])
        fresh = store_engine(side, store)
        rs.add(fresh)
        queued = len(fresh._pending_prewarm)
        assert queued >= 2
        cold = store_engine(side, store)
        rs.add(cold, prewarm=False)
        assert len(cold._pending_prewarm) == 0
        pins = store.pinned_entries
        assert pins >= 2
        fresh._block_mgr._spill.unstage_all()
        assert store.pinned_entries == 0
        return queued, pins, [h.replica_id for h in rs.handles]

    fp.twin(both, scenario)


def test_cross_width_store_roundtrip_bit_identical(both):
    """A chain written by a tp=2 engine revives on a tp=1 engine unchanged
    (full-width payloads): the tp=1 reader equals a cold tp=1 run."""
    def scenario(side):
        store = side.kv_store.FleetKVStore(capacity_bytes=1 << 24)
        wide = store_engine(side, store, mesh=side.mesh2())
        (out_wide,) = fp.run(wide, [DONOR])
        wide.stop()
        assert wide.store_published_blocks > 0
        cold = store_engine(side)
        (out_cold,) = fp.run(cold, [DONOR])
        cold.stop()
        narrow = store_engine(side, store)
        (out_narrow,) = fp.run(narrow, [DONOR])
        narrow.stop()
        assert narrow.store_hits == 2
        assert out_narrow == out_cold == out_wide
        assert store.conserved() and store.pinned_entries == 0
        return (out_narrow, fp.counters(side, wide), fp.counters(side, narrow),
                fp.store_state(store))

    fp.twin(both, scenario)


# -- failover: a dead replica's cache outlives it (test_kv_store.py:597) -------------
def test_failover_revives_from_store_and_cuts_replay(both):
    prompts = [DONOR, [((i * 7) % 89) + 2 for i in range(24)]]
    max_new = 6

    def scenario(side):
        ref = store_engine(side)
        want = fp.run(ref, prompts, max_new=max_new)
        ref.stop()

        def failover_run(store):
            rs = side.replica.ReplicaSet([store_engine(side, store) for _ in range(2)])
            router = side.router.PrefixRouter(rs)
            inj = side.supervisor.ReplicaFaultInjector()
            sup = side.supervisor.FleetSupervisor(
                rs, router, suspect_after=2, dead_after=3, recover_after=3,
                sleep=lambda s: None, fault_injector=inj)
            futs = [sup.submit(p, max_new=max_new) for p in prompts]
            vid = rs.handles[0].replica_id
            victim_futs = [s.future for s in sup._streams.get(vid, {}).values()]
            assert victim_futs
            assert fp.drive_fleet(side, rs, lambda: all(
                len(ck.generated) >= 2 for ck in sup._checkpoints.get(vid, {}).values())
                and len(sup._checkpoints.get(vid, {})) >= len(victim_futs), sup=sup)
            inj.kill(vid)
            assert fp.drive_fleet(side, rs, lambda: all(f.done() for f in futs),
                                  downed={vid}, sup=sup)
            got = [f.result(timeout=5) for f in futs]
            survivors = [h for h in rs.handles if h.replica_id != vid]
            for h in survivors:
                assert h.engine._block_mgr.conserved()
                check_invariants(h.engine._block_mgr)
            obs = (got, [fp.counters(side, h.engine) for h in survivors],
                   fp.report(sup.report(), drop=("failover_latency_p50_s",
                                                 "failover_latency_p95_s",
                                                 "failover_latency_samples")))
            rs.stop()
            return (got, sum(h.engine.replay_tokens for h in survivors),
                    sum(h.engine.failover_revive_tokens for h in survivors), obs)

        got_cold, replay_cold, revived_cold, obs_cold = failover_run(None)
        assert got_cold == want and revived_cold == 0
        store = side.kv_store.FleetKVStore(capacity_bytes=1 << 24)
        got_store, replay_store, revived_store, obs_store = failover_run(store)
        assert got_store == want
        assert revived_store > 0
        assert replay_store < replay_cold
        assert store.conserved() and store.pinned_entries == 0
        return obs_cold, obs_store, replay_cold, replay_store, revived_store

    fp.twin(both, scenario)


# -- telemetry, metrics, billing (test_kv_store.py:681-749) --------------------------
def test_store_counters_flow_through_report_metrics_and_merge(both):
    def scenario(side):
        store = side.kv_store.FleetKVStore(capacity_bytes=1 << 24)
        registry = side.Metrics()
        a = store_engine(side, store)
        fp.run(a, [DONOR])
        rep_a = side.telemetry.collect_serving(a)
        a.stop()
        assert rep_a.store_puts == a.store_puts > 0
        assert rep_a.store_published_blocks == a.store_published_blocks > 0
        b = store_engine(side, store, metrics=registry)
        fp.run(b, [DONOR])
        rep = side.telemetry.collect_serving(b)
        b.stop()
        assert rep.store_hits == b.store_hits > 0
        assert rep.store_puts == b.store_puts == 0
        assert rep.store_dedup_hits == b.store_dedup_hits
        assert rep.store_bytes == store.host_bytes > 0
        assert rep.store_entries == store.entries > 0
        assert registry.get("nos_tpu_fleet_kv_store_hits") == float(b.store_hits)
        assert registry.get("nos_tpu_fleet_kv_store_puts") == float(b.store_puts)
        assert registry.get("nos_tpu_fleet_kv_store_bytes") == float(store.host_bytes)
        assert registry.get("nos_tpu_fleet_kv_store_entries") == float(store.entries)
        merged = side.telemetry.ServingReport.merge([rep, rep])
        assert merged.store_hits == 2 * rep.store_hits and merged.replicas == 2
        c = store_engine(side, store, metrics=side.Metrics())
        c.prewarm_from_store()
        for _ in range(50):
            if not c._pending_prewarm:
                break
            c._tick()
        rep_c = side.telemetry.collect_serving(c)
        c.stop()
        assert rep_c.prewarm_tokens == c.prewarm_tokens > 0
        return (fp.counters(side, a), fp.counters(side, b), fp.counters(side, c),
                dict(registry._counters), merged.store_hits)

    fp.twin(both, scenario)


def test_cost_ledger_prices_store_revives(both):
    def scenario(side):
        store = side.kv_store.FleetKVStore(capacity_bytes=1 << 24)
        a = store_engine(side, store)
        fp.run(a, [DONOR])
        a.stop()
        led = side.CostLedger()
        b = store_engine(side, store, cost_ledger=led)
        fp.run(b, [DONOR], tenant="acme")
        b.stop()
        totals = led.tenant_totals()["acme"]
        c = side.constants
        assert b.store_hits == 2
        assert totals[c.COST_SPILL_BYTES] == b.store_hits * b._bytes_per_block
        assert totals[c.COST_PREFILL_CACHED] >= b.store_hits * 8
        return {k: v for k, v in totals.items()
                if k not in (c.COST_SLOT_SECONDS, c.COST_CHIP_MS)}

    fp.twin(both, scenario)


# -- the router's store scoring (test_kv_store.py:756-813) ---------------------------
def test_router_scores_store_continuation(both):
    def scenario(side):
        store = side.kv_store.FleetKVStore(capacity_bytes=1 << 24)
        a = store_engine(side, store)
        fp.run(a, [DONOR])
        a.stop()
        rs = side.replica.ReplicaSet([store_engine(side, store) for _ in range(2)])
        router = side.router.PrefixRouter(rs, kv_store=store)
        fut = router.submit(DONOR, max_new=2)
        assert router.store_routed == 1 and router.prefix_routed == 0
        assert router.predicted_store_tokens == 16
        snap = router.snapshot()
        assert snap["store_routed"] == 1 and snap["predicted_store_tokens"] == 16
        assert fp.drive_fleet(side, rs, fut.done, n=2000)
        out = fut.result(timeout=5)
        rs.stop()
        rs2 = side.replica.ReplicaSet([store_engine(side) for _ in range(2)])
        router2 = side.router.PrefixRouter(rs2)
        router2.submit(DONOR, max_new=1)
        assert router2.store_routed == 0 and router2.rr_routed == 1
        snap2 = router2.snapshot()
        rs2.stop()
        return out, snap, snap2

    fp.twin(both, scenario)


def test_router_store_weight_keeps_device_hits_on_top(both):
    for side in both:
        assert 0.0 < side.constants.ROUTER_STORE_HIT_WEIGHT < 1.0
        assert 16 > side.constants.ROUTER_STORE_HIT_WEIGHT * 16


def test_prompt_chain_keys_are_the_store_address_space(both):
    """Two computations of one prompt give the same chain keys, a different
    prefix forks the chain, and the port's keys are the JAX package's, so
    the two packages address one store alike."""
    jside, tside = both
    bs = 8
    k1 = tside.radix_tree.prompt_chain_keys(DONOR, bs)
    assert k1 == tside.radix_tree.prompt_chain_keys(list(DONOR), bs) and len(k1) == 3
    assert k1 == jside.radix_tree.prompt_chain_keys(DONOR, bs)
    other = [DONOR[0] + 1] + DONOR[1:]
    assert tside.radix_tree.prompt_chain_keys(other, bs)[0] != k1[0]
    assert tside.radix_tree.prompt_chain_keys(other, bs)[2] != k1[2]


# -- two pool dtypes over one store (test_quantized_kv.py:504) -----------------------
def _fp16_payload():
    k = np.zeros((2, 2, 8, 8), np.float16)
    return (k, k), 2 * k.nbytes


def _int8_payload():
    q = np.zeros((2, 2, 8, 8), np.int8)
    s = np.ones((2,), np.float32)
    return ("int8", q, q, s, s), 2 * q.nbytes + 2 * s.nbytes


@KV
def test_fleet_store_mixed_dtype_byte_balance(kv):
    store = kv.FleetKVStore(capacity_bytes=1 << 16)
    pf, nf = _fp16_payload()
    pq, nq = _int8_payload()
    store.put("fp16-chain", pf, nf, parent="", tokens=(1,))
    store.put("int8:chain", pq, nq, parent="", tokens=(1,))
    assert store.host_bytes == nf + nq and store.conserved()
    store.discard("fp16-chain")
    assert store.host_bytes == nq and store.conserved()
    store.put("int8:chain", pf, nf, parent="", tokens=(1,))
    assert store.host_bytes == nf and store.conserved()


def test_int8_and_native_replicas_share_one_store(both):
    """An int8 and a native replica over one store: their chain keys differ
    by the int8 salt, so neither hits the other's blocks, and a foreign
    payload handed to the int8 engine (an explicit prewarm of a native
    key) is refused and counted in `kv_quant_payload_rejected`."""
    def scenario(side):
        store = side.kv_store.FleetKVStore(capacity_bytes=1 << 24)
        native = store_engine(side, store)
        out_n = fp.run(native, [DONOR])
        native.stop()
        native_keys = sorted(store.keys())
        quant = store_engine(side, store, kv_dtype=side.constants.KV_DTYPE_INT8)
        out_q = fp.run(quant, [DONOR])
        assert quant.store_hits == 0
        assert set(native_keys) < set(store.keys())
        queued = quant.prewarm_from_store(keys=native_keys[:1])
        assert queued >= 1
        for _ in range(8):
            quant._tick()
        assert quant.kv_quant_payload_rejected == queued and quant.prewarm_tokens == 0
        quant.stop()
        assert store.conserved() and store.pinned_entries == 0
        return out_n, out_q, queued, fp.counters(side, quant), fp.store_state(store)

    fp.twin(both, scenario)


@pytest.mark.parametrize("pool", ["native", "int8", "tp2"])
def test_one_pass_block_read_equals_per_block_copies(both, pool):
    """The publish paths' one-pass read (`_read_blocks`, taken on the card)
    gives each block's payload and nbytes byte for byte as `_extract_block`
    does, native, int8 and at tp=2, with one counted blocking read for the
    batch; a CPU pool keeps the per-block reads (and counts), as the
    reference does."""
    side = both[1]
    kw = {"native": {}, "int8": {"kv_dtype": "int8"},
          "tp2": {"mesh": side.mesh2()}}[pool]
    server = fp.engine(side, store=side.kv_store.FleetKVStore(1 << 22), **kw)
    gen = torch.Generator().manual_seed(5)
    for shard in (server.cache if pool == "tp2" else [server.cache]):
        for layer in shard.values():
            for t in layer.values():
                if t.dtype == torch.int8:
                    t.copy_(torch.randint(-127, 128, t.shape, generator=gen, dtype=torch.int8))
                else:
                    t.copy_(torch.rand(t.shape, generator=gen) + 0.5)

    def same(got, want):
        for (gp, gn), (wp, wn) in zip(got, want, strict=True):
            assert gn == wn and len(gp) == len(wp)
            for g, w in zip(gp, wp):
                if isinstance(w, str):
                    assert g == w
                    continue
                assert g.dtype == w.dtype and g.shape == w.shape and g.is_contiguous()
                assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))

    blocks = [3, 1, 4]
    syncs = server.blocking_syncs
    want = [server._extract_block(b) for b in blocks]
    assert server.blocking_syncs - syncs == 3
    same(server._extract_blocks(blocks), want)  # a CPU pool: block by block
    assert server.blocking_syncs - syncs == 6
    same(server._read_blocks(blocks), want)
    assert server.blocking_syncs - syncs == 7
