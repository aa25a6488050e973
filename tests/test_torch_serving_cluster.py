"""The port's cluster serving plane (nos_tpu_torch/serving/replica.py,
router.py, drain.py; the engine's `probe`, `transfer_in_request`,
`transfer_in_checkpoint`, `drain_extract`, `reopen`) against the JAX
package, on the CPU, mirroring tests/test_serving_cluster.py, the drain
after bursts of tests/test_burst_decode.py:234, the cross-tp drain and
migrate of tests/test_sharded_decode.py:254 (on CPU meshes) and the
router's tenant pin filter of tests/test_quantized_kv.py:413-445.

Each case runs one scenario on each side (tests/test_torch_fleet_parity.py) and holds
the port to the JAX package: equal tokens, equal `collect_serving`
counters, equal `probe()` rows, equal `DrainReport`s and router
snapshots; then each side to the reference's own oracles (outputs
independent of the routing policy and of a mid-decode drain, pools
conserved on source and destination)."""

import pytest

import test_torch_fleet_parity as fp
from test_block_manager import check_invariants

PROMPTS = {
    "a": [4, 9, 2, 33, 7, 1, 8, 5],
    "b": [40, 41, 42, 43, 44, 45, 46, 47],
    "c": [9, 8, 7, 6, 5, 4, 3, 2],
}
DONOR = [((i * 5) % 91) + 1 for i in range(24)]


@pytest.fixture(scope="module")
def both():
    return fp.sides()


def router_view(router):
    snap = router.snapshot()
    return snap, {t: r for t, r in router._sticky.items()}


# -- registry and construction (test_serving_cluster.py:79-108) ----------------------
@pytest.mark.parametrize("which", [0, 1], ids=["jax", "torch"])
def test_replica_set_validates_block_sizes(both, which):
    side = both[which]
    with pytest.raises(ValueError, match="block_size"):
        side.replica.ReplicaSet([fp.engine(side, block_size=8), fp.engine(side, block_size=16)])
    with pytest.raises(ValueError, match="at least one"):
        side.replica.ReplicaSet([])
    rs = fp.fleet(side, 2)
    with pytest.raises(ValueError, match="block_size"):
        rs.add(fp.engine(side, block_size=16))
    with pytest.raises(ValueError, match="policy"):
        side.router.PrefixRouter(rs, policy="coin-flip")
    with pytest.raises(ValueError, match="role"):
        side.replica.ReplicaHandle("replica-9", rs.handles[0].engine, role="oracle")


def test_replica_ids_states_and_probe_rows(both):
    def scenario(side):
        c = side.constants
        rs = fp.fleet(side, 2)
        assert [h.replica_id for h in rs.handles] == [
            f"{c.REPLICA_ID_PREFIX}0", f"{c.REPLICA_ID_PREFIX}1"]
        fut = rs.handles[0].engine.submit(DONOR, max_new=4)
        rs.handles[0].engine._tick()
        rows = rs.snapshot()
        assert all(r[c.REPLICA_KEY_STATE] == c.REPLICA_STATE_ACTIVE for r in rows)
        assert c.PROBE_KEY_ACTIVE_SLOTS in rows[0]
        probe = rs.handles[0].probe()
        load = rs.handles[0].load()
        assert fp.drive_fleet(side, rs, fut.done)
        rs.stop()
        return rows, probe, load, fut.result(1)

    fp.twin(both, scenario)


# -- routing (test_serving_cluster.py:112-217) ---------------------------------------
def test_round_robin_policy_rotates(both):
    def scenario(side):
        rs = fp.fleet(side, 3)
        router = side.router.PrefixRouter(rs, policy=side.constants.ROUTER_POLICY_ROUND_ROBIN)
        picks = [router.select(PROMPTS["a"], tenant=None).replica_id for _ in range(6)]
        assert picks == ["replica-0", "replica-1", "replica-2"] * 2
        assert router.rr_routed == 6 and router.prefix_routed == 0
        return picks, router_view(router)

    fp.twin(both, scenario)


def test_prefix_routing_follows_the_shadow(both):
    def scenario(side):
        rs = fp.fleet(side, 2)
        router = side.router.PrefixRouter(rs)
        f1 = router.submit(DONOR, max_new=4)
        assert fp.drive_fleet(side, rs, f1.done)
        f2 = router.submit(DONOR, max_new=4)
        assert fp.drive_fleet(side, rs, f2.done)
        assert f1.result(1) == f2.result(1)
        assert rs.handles[0].routed_requests == 2
        assert router.prefix_routed >= 1 and router.predicted_hit_tokens > 0
        assert rs.handles[0].engine.prefix_hit_blocks >= 2
        return f1.result(1), router_view(router), fp.counters(side, rs.handles[0].engine)

    fp.twin(both, scenario)


def test_deepest_match_routing_sees_partial_prefix(both):
    def scenario(side):
        rs = fp.fleet(side, 2)
        router = side.router.PrefixRouter(rs)
        donor = DONOR[:16]
        f1 = router.submit(donor, max_new=4)
        assert fp.drive_fleet(side, rs, f1.done)
        partial = donor[:6] + [((i * 13) % 91) + 3 for i in range(10)]
        f2 = router.submit(partial, max_new=4)
        assert fp.drive_fleet(side, rs, f2.done)
        assert f1.result(1) and f2.result(1)
        assert rs.handles[0].routed_requests == 2
        assert router.prefix_routed >= 1 and router.predicted_hit_tokens > 0
        assert rs.handles[0].engine.prefix_cow_hits >= 1
        router.reconcile()
        holder = rs.handles[0]
        assert all(k in holder.shadow for k in holder.shadow_tree._nodes)
        return (f1.result(1), f2.result(1), router_view(router), sorted(holder.shadow),
                fp.counters(side, holder.engine))

    fp.twin(both, scenario)


def test_load_penalty_sticky_tenants_and_no_admitting_replica(both):
    def scenario(side):
        c = side.constants
        rs = fp.fleet(side, 2)
        router = side.router.PrefixRouter(rs)
        first = router.select(PROMPTS["a"])
        second = router.select(PROMPTS["b"])
        assert first.replica_id != second.replica_id
        h1 = router.select(PROMPTS["a"], tenant="t")
        h2 = router.select(PROMPTS["b"], tenant="t")
        assert h2 is h1 and router.sticky_routed == 1
        h1.state = c.REPLICA_STATE_DRAINING
        h3 = router.select(PROMPTS["c"], tenant="t")
        assert h3 is not h1 and h3.admitting
        one = fp.fleet(side, 1)
        one.handles[0].state = c.REPLICA_STATE_RETIRED
        with pytest.raises(RuntimeError, match="no admitting replica"):
            side.router.PrefixRouter(one).select(PROMPTS["a"])
        return [first.replica_id, second.replica_id, h1.replica_id, h3.replica_id], \
            router_view(router)

    fp.twin(both, scenario)


def test_reconcile_replaces_optimistic_shadow_with_engine_truth(both):
    def scenario(side):
        rs = fp.fleet(side, 2)
        router = side.router.PrefixRouter(rs)
        f = router.submit(DONOR, max_new=4)
        assert fp.drive_fleet(side, rs, f.done)
        holder = rs.handles[0]
        holder.shadow.add("bogus-key-that-was-never-indexed")
        router.reconcile()
        assert holder.shadow == set(holder.engine.prefix_keys())
        assert "bogus-key-that-was-never-indexed" not in holder.shadow
        return sorted(holder.shadow), router.dissolve_pins("replica-0")

    fp.twin(both, scenario)


# -- the placement-independence oracle (test_serving_cluster.py:222) ----------------
def test_outputs_bit_identical_across_routing_policies(both):
    sys_a = [((i * 5) % 91) + 1 for i in range(16)]
    sys_b = [((i * 7) % 91) + 2 for i in range(16)]
    warm = [("a", sys_a + [60]), ("b", sys_b + [70])]
    burst = [("a", sys_a + [61]), ("a", sys_a + [62]), ("b", sys_b + [71]), ("b", sys_b + [72])]

    def scenario(side):
        def run(policy):
            rs = fp.fleet(side, 2, total_blocks=1 + 16)
            router = side.router.PrefixRouter(rs, policy=policy)
            outs = []
            for t, p in warm:
                f = router.submit(p, max_new=4, tenant=t)
                assert fp.drive_fleet(side, rs, f.done)
                outs.append(f.result(1))
            futs = [router.submit(p, max_new=4, tenant=t) for t, p in burst]
            assert fp.drive_fleet(side, rs, lambda: all(f.done() for f in futs))
            outs.extend(f.result(1) for f in futs)
            report = rs.fleet_report()
            for h in rs.handles:
                assert h.engine._block_mgr.conserved()
                check_invariants(h.engine._block_mgr)
            return outs, report, router_view(router)

        c = side.constants
        outs_p, rep_p, view_p = run(c.ROUTER_POLICY_PREFIX)
        outs_r, rep_r, view_r = run(c.ROUTER_POLICY_ROUND_ROBIN)
        assert outs_p == outs_r
        assert rep_p.prefix_hit_blocks > rep_r.prefix_hit_blocks
        assert rep_p.prefill_tokens < rep_r.prefill_tokens
        assert rep_p.replicas == rep_r.replicas == 2
        fields = side.telemetry.report_counter_fields()
        return (outs_p, view_p, view_r, {f: getattr(rep_p, f) for f in fields},
                {f: getattr(rep_r, f) for f in fields})

    fp.twin(both, scenario)


# -- drain and migrate (test_serving_cluster.py:267-369) -----------------------------
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_drain_rehomes_mid_decode_streams_bit_identical(both, temperature):
    prompts = [PROMPTS["a"], PROMPTS["b"], PROMPTS["c"]]

    def scenario(side):
        rs_ref = fp.fleet(side, 2, temperature=temperature)
        router_ref = side.router.PrefixRouter(rs_ref)
        futs = [router_ref.submit(p, max_new=10) for p in prompts]
        assert fp.drive_fleet(side, rs_ref, lambda: all(f.done() for f in futs))
        want = [f.result(1) for f in futs]
        rs_ref.stop()

        rs = fp.fleet(side, 2, temperature=temperature)
        router = side.router.PrefixRouter(rs)
        futs = [router.submit(p, max_new=10) for p in prompts]
        src = rs.handles[0].engine
        assert fp.drive_fleet(side, rs, lambda: any(
            s.active and s.phase == "decoding" and 2 <= len(s.refs) < 10 for s in src._slots),
            n=64)
        report = side.drain.drain_replica(rs, router, "replica-0")
        assert report.slots_migrated >= 1
        assert rs.handles[0].state == side.constants.REPLICA_STATE_RETIRED
        assert src._block_mgr.conserved()
        check_invariants(src._block_mgr)
        assert fp.drive_fleet(side, rs, lambda: all(f.done() for f in futs))
        got = [f.result(1) for f in futs]
        assert got == want
        dst = rs.handles[1].engine
        assert dst._block_mgr.conserved()
        check_invariants(dst._block_mgr)
        assert dst.replay_tokens > 0
        obs = (got, fp.report(report), fp.counters(side, src), fp.counters(side, dst),
               router_view(router))
        rs.stop()
        return obs

    fp.twin(both, scenario)


def test_drain_preserves_queued_request_futures(both):
    def scenario(side):
        rs = fp.fleet(side, 2, n_slots=1)
        router = side.router.PrefixRouter(rs)
        futs = [router.submit(PROMPTS[k], max_new=6, tenant="t") for k in ("a", "b", "c")]
        pinned = router.select(PROMPTS["a"], tenant="t")
        assert fp.drive_fleet(side, rs, lambda: any(s.active for s in pinned.engine._slots),
                              n=64)
        report = side.drain.drain_replica(rs, router, pinned.replica_id)
        assert report.slots_migrated + report.requests_migrated == 3
        assert report.requests_migrated >= 1
        assert fp.drive_fleet(side, rs, lambda: all(f.done() for f in futs))
        outs = [f.result(1) for f in futs]
        assert all(len(o) == 6 for o in outs)
        obs = outs, fp.report(report), [fp.counters(side, h.engine) for h in rs.handles]
        rs.stop()
        return obs

    fp.twin(both, scenario)


def test_drain_refuses_without_a_destination(both):
    def scenario(side):
        rs = fp.fleet(side, 1)
        router = side.router.PrefixRouter(rs)
        fut = router.submit(PROMPTS["a"], max_new=4)
        with pytest.raises(RuntimeError, match="no admitting replica"):
            side.drain.drain_replica(rs, router, "replica-0")
        assert rs.handles[0].state == side.constants.REPLICA_STATE_ACTIVE
        assert fp.drive_fleet(side, rs, fut.done)
        out = fut.result(1)
        rs.stop()
        return out

    fp.twin(both, scenario)


def test_migrate_replica_is_create_then_drain_then_delete(both):
    def scenario(side):
        c = side.constants
        rs = fp.fleet(side, 1)
        router = side.router.PrefixRouter(rs)
        futs = [router.submit(PROMPTS[k], max_new=8) for k in ("a", "b")]
        src = rs.handles[0].engine
        assert fp.drive_fleet(side, rs, lambda: any(s.active for s in src._slots), n=64)
        new_handle, report = side.drain.migrate_replica(
            rs, router, "replica-0", fp.engine(side), start=False)
        assert new_handle.replica_id == "replica-1"
        assert rs.handles[0].state == c.REPLICA_STATE_RETIRED
        assert new_handle.state == c.REPLICA_STATE_ACTIVE
        assert set(report.destinations) == {"replica-1"}
        assert fp.drive_fleet(side, rs, lambda: all(f.done() for f in futs))
        outs = [f.result(1) for f in futs]
        assert all(outs)
        obs = outs, fp.report(report), fp.counters(side, new_handle.engine)
        rs.stop()
        return obs

    fp.twin(both, scenario)


def test_drain_migrate_after_bursts_is_bit_identical(both):
    """tests/test_burst_decode.py:234: drain an engine mid-stream after
    bursts ran, re-home by hand; the streams finish as undrained."""
    prompts = [[3, 11, 42, 7, 19, 5, 23, 2, 61, 13], [8, 8, 31, 4, 90, 17, 6, 44, 9, 28],
               [55, 1, 2, 3, 70, 70, 12, 39, 80, 10]]
    kw = dict(n_slots=4, max_len=64, prompt_buckets=(16,), steps_per_dispatch=6)

    def scenario(side):
        base = fp.engine(side, **kw)
        baseline = fp.run(base, prompts, max_new=32, idle_ticks=0, n=3000)
        src = fp.engine(side, **kw)
        futs = [src.submit(p, max_new=32) for p in prompts]
        for _ in range(10):
            src._tick()
        assert src.burst_dispatches > 0
        checkpoints, pending = src.drain_extract()
        assert src._block_mgr.conserved()
        dst = fp.engine(side, **kw)
        for ck in checkpoints:
            dst.transfer_in_checkpoint(ck)
        for req in pending:
            dst.transfer_in_request(req.prompt, req.max_new, future=req.future,
                                    t_submit=req.t_submit)
        for _ in range(3000):
            if all(f.done() for f in futs):
                break
            dst._tick()
        got = [f.result(timeout=5) for f in futs]
        assert got == baseline
        assert dst._block_mgr.conserved()
        return (got, [(ck.serial, ck.generated) for ck in checkpoints], len(pending),
                fp.counters(side, src), fp.counters(side, dst))

    fp.twin(both, scenario)


def test_cross_tp_drain_migrate_roundtrip(both):
    """tests/test_sharded_decode.py:254 on CPU meshes: streams move from a
    tp=2 replica to a tp=1 replica and back to a fresh tp=2 one through
    drain_replica and migrate_replica, and finish as an undrained run."""
    reqs = [([5, 11, 3, 42, 7, 9, 2, 1], 40), ([9, 8, 7, 6, 5, 4, 3, 2, 1], 34)]

    def scenario(side):
        base = fp.engine(side)
        futs = [base.submit(p, max_new=n) for p, n in reqs]
        for _ in range(3000):
            if all(f.done() for f in futs):
                break
            base._tick()
        baseline = [f.result(5) for f in futs]
        src = fp.engine(side, mesh=side.mesh2())
        mid = fp.engine(side)
        rs = side.replica.ReplicaSet([src, mid])
        router = side.router.PrefixRouter(rs)
        futs = [src.submit(p, max_new=n) for p, n in reqs]
        for _ in range(4):
            src._tick()
        report = side.drain.drain_replica(rs, router, "replica-0")
        assert report.slots_migrated + report.requests_migrated == len(reqs)
        assert src._block_mgr.conserved()
        for _ in range(4):
            mid._tick()
        back = fp.engine(side, mesh=side.mesh2())
        _, report2 = side.drain.migrate_replica(rs, router, "replica-1", back, start=False)
        assert mid._block_mgr.conserved()
        for _ in range(3000):
            if all(f.done() for f in futs):
                break
            back._tick()
        got = [f.result(timeout=5) for f in futs]
        assert got == baseline
        assert back._block_mgr.conserved() and back.replay_tokens > 0
        obs = (got, fp.report(report), fp.report(report2), fp.counters(side, src),
               fp.counters(side, mid), fp.counters(side, back))
        rs.stop()
        return obs

    fp.twin(both, scenario)


# -- the router's tenant pin filter (test_quantized_kv.py:413-445) -------------------
def test_router_filters_replicas_by_tenant_pin(both):
    prompts = [[5, 11, 3, 42, 7, 9, 2, 1], [40, 41, 42], [9, 8, 7, 6, 5, 4, 3, 2, 1]]

    def scenario(side):
        q = side.quota
        policy = q.QuotaPolicy({"exact": q.TenantShare(0.0, 1.0, kv_dtype="fp16"),
                                "cheap": q.TenantShare(0.0, 1.0, kv_dtype="int8")},
                               window_ticks=8)
        engines = [fp.engine(side, quota=policy),
                   fp.engine(side, kv_dtype=side.constants.KV_DTYPE_INT8, quota=policy)]
        rs = side.replica.ReplicaSet(engines)
        router = side.router.PrefixRouter(rs, quota=policy, sticky_tenants=False)
        outs = []
        for tenant in ("exact", "cheap"):
            for i in range(3):
                fut = router.submit(prompts[i], max_new=1, tenant=tenant)
                assert fp.drive_fleet(side, rs, fut.done, n=2000)
                outs.append(fut.result(timeout=5))
        assert [h.routed_requests for h in rs.handles] == [3, 3]
        assert engines[0].admissions_by_tenant == {"exact": 3}
        assert engines[1].admissions_by_tenant == {"cheap": 3}
        rs.stop()
        only_int8 = side.replica.ReplicaSet(
            [fp.engine(side, kv_dtype="int8", quota=policy)])
        with pytest.raises(RuntimeError, match="kv_dtype"):
            side.router.PrefixRouter(only_int8, quota=policy).submit(
                prompts[0], max_new=1, tenant="exact")
        only_int8.stop()
        return outs, router_view(router)

    fp.twin(both, scenario)


# -- DecodeServer.stop(drain=True) and submit after stop (test_serving_cluster.py:374-403)
def test_stop_drain_finishes_queued_and_inflight(both):
    def scenario(side):
        server = fp.engine(side, n_slots=1).start()
        futs = [server.submit(PROMPTS[k], max_new=6) for k in ("a", "b", "c")]
        server.stop(drain=True, drain_timeout_s=120)
        assert all(f.done() and not f.exception() for f in futs)
        outs = [f.result(0) for f in futs]
        assert all(len(o) == 6 for o in outs)
        manual = fp.engine(side, n_slots=1)
        mfuts = [manual.submit(PROMPTS[k], max_new=4) for k in ("a", "b")]
        manual.stop(drain=True, drain_timeout_s=120)
        return outs, [f.result(0) for f in mfuts]

    fp.twin(both, scenario)


@pytest.mark.parametrize("which", [0, 1], ids=["jax", "torch"])
def test_submit_after_stop_raises_instead_of_stranding(both, which):
    side = both[which]
    server = fp.engine(side).start()
    server.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        server.submit(PROMPTS["a"], max_new=4)
    with pytest.raises(RuntimeError, match="stopped"):
        server.transfer_in_request(PROMPTS["a"], max_new=4)
    drained = fp.engine(side)
    drained.stop(drain=True, drain_timeout_s=10)
    with pytest.raises(RuntimeError, match="stopped"):
        drained.submit(PROMPTS["a"], max_new=4)


# -- fleet telemetry (test_serving_cluster.py:407-473) -------------------------------
@pytest.mark.parametrize("which", [0, 1], ids=["jax", "torch"])
def test_merge_sums_counters_pools_percentiles_and_handles_empty(both, which):
    tel = both[which].telemetry
    r0 = tel.ServingReport(steps_run=10, prefill_tokens=100, prefix_hit_blocks=4,
                           kv_blocks_free=7, macro_tokens_by_slot={"0": 5, "1": 3})
    r1 = tel.ServingReport(steps_run=32, prefill_tokens=50, prefix_hit_blocks=1,
                           kv_blocks_free=2, macro_tokens_by_slot={"0": 9})
    m = tel.ServingReport.merge([r0, r1])
    assert (m.steps_run, m.prefill_tokens, m.prefix_hit_blocks, m.kv_blocks_free) == (
        42, 150, 5, 9)
    assert m.replicas == 2 and m.macro_tokens_by_slot == {"0:0": 5, "0:1": 3, "1:0": 9}
    fast, slow = [0.01] * 19, [10.0]
    ra = tel.ServingReport(ttft_p95_s=tel.percentile(fast, 95), ttft_samples=list(fast),
                           queue_wait_samples=[0.001] * 19)
    rb = tel.ServingReport(ttft_p95_s=tel.percentile(slow, 95), ttft_samples=list(slow),
                           queue_wait_samples=[2.0] * 5)
    m = tel.ServingReport.merge([ra, rb])
    assert m.ttft_samples == fast + slow
    assert m.ttft_p95_s == pytest.approx(0.01)
    assert m.queue_wait_p95_s == pytest.approx(2.0)
    assert m.queue_wait_p50_s == pytest.approx(0.001)
    assert tel.ServingReport.merge([]).replicas == 0
    m = tel.ServingReport.merge([tel.ServingReport(steps_run=3), tel.ServingReport()])
    assert m.steps_run == 3 and m.ttft_p95_s == 0.0


def test_fleet_report_pools_engine_samples(both):
    def scenario(side):
        rs = fp.fleet(side, 2)
        router = side.router.PrefixRouter(rs, policy=side.constants.ROUTER_POLICY_ROUND_ROBIN)
        futs = [router.submit(PROMPTS[k], max_new=4) for k in ("a", "b", "c")]
        assert fp.drive_fleet(side, rs, lambda: all(f.done() for f in futs))
        per_replica = [side.telemetry.collect_serving(h.engine) for h in rs.handles]
        fleet = rs.fleet_report()
        assert fleet.replicas == 2 and len(fleet.ttft_samples) == 3
        assert fleet.steps_run == sum(r.steps_run for r in per_replica)
        assert fleet.ttft_p95_s == side.telemetry.percentile(fleet.ttft_samples, 95)
        fields = side.telemetry.report_counter_fields()
        obs = [f.result(1) for f in futs], {f: getattr(fleet, f) for f in fields}
        rs.stop()
        return obs

    fp.twin(both, scenario)
