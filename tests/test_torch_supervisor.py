"""The port's fleet supervisor (nos_tpu_torch/serving/supervisor.py; the
engine's `checkpoint_snapshot`, `set_checkpoint_hook`, `forsake`,
`reopen`) against the JAX package, on the CPU, mirroring
tests/test_supervisor.py, with the fleet chaos gate (:709) on three seeds.

Two substrates, as in the reference: stub engines (the duck-typed probe
and submit surface) for the wrapper, the health machine and the injector,
on both packages' classes; real engine fleets, ticked by hand (a killed
replica is simply no longer ticked), for the failover oracles. Each real
case runs one scenario on each side (tests/test_torch_fleet_parity.py) and holds the
port to the JAX package: equal tokens, equal `FailoverReport` and
`DrainReport` fields, equal supervisor snapshots and reports (wall-clock
fields aside) and equal `collect_serving` counters; then each side to the
reference's oracles (every checkpointed stream bit-identical to the
fault-free run, every other one a classified ReplicaLostError carrying
its request, no selection of a dead replica, pools conserved)."""

import random
import threading
import time
from concurrent.futures import Future

import pytest

import test_torch_fleet_parity as fp
from test_block_manager import check_invariants

PROMPTS = [
    [4, 9, 2, 33, 7, 1, 8, 5],
    [40, 41, 42, 43, 44, 45, 46, 47],
    [9, 8, 7, 6, 5, 4, 3, 2],
    [11, 3, 11, 3, 11, 3, 11, 3],
]
SIDE = pytest.mark.parametrize("which", [0, 1], ids=["jax", "torch"])


@pytest.fixture(scope="module")
def both():
    return fp.sides()


# -- the stub substrate (test_supervisor.py:74-127) ----------------------------------
class StubEngine:
    """A duck-typed replica engine for the supervisor's mechanics."""

    block_size = 8

    def __init__(self, constants):
        self.c = constants
        self.submitted = []
        self.transfers = []
        self.stopped = False

    def probe(self):
        c = self.c
        return {c.PROBE_KEY_ACTIVE_SLOTS: 0, c.PROBE_KEY_QUEUED_REQUESTS: 0,
                c.PROBE_KEY_PREFILL_BACKLOG: 0, c.PROBE_KEY_DRAINING: False,
                c.PROBE_KEY_TP_DEVICES: 1, c.PROBE_KEY_SLOTS_TOTAL: 2,
                c.PROBE_KEY_KV_BLOCKS_TOTAL: 15}

    def prefix_keys(self):
        return frozenset()

    def submit(self, prompt, max_new, tenant=None, trace_id=None):
        fut = Future()
        self.submitted.append((list(prompt), max_new, tenant))
        return fut

    def transfer_in_checkpoint(self, ck, t_restore=None):
        self.transfers.append(ck)

    def drain_extract(self):
        return [], []

    def stop(self, **kw):
        self.stopped = True


def stub_fleet(side, n=3):
    rs = side.replica.ReplicaSet([StubEngine(side.constants) for _ in range(n)])
    return rs, side.router.PrefixRouter(rs)


def supervisor(side, rs, router, **kw):
    args = dict(suspect_after=2, dead_after=4, recover_after=3, sleep=lambda s: None)
    args.update(kw)
    return side.supervisor.FleetSupervisor(rs, router, **args)


def events(sup):
    return [{k: v for k, v in e.items() if k != "t"} for e in sup.events]


def sup_view(sup):
    snap = sup.snapshot()
    snap["events"] = events(sup)
    rep = fp.report(sup.report(), drop=("failover_latency_p50_s", "failover_latency_p95_s",
                                        "failover_latency_samples"))
    return snap, rep


# -- ReplicaFaultSpec / ReplicaFaultInjector (test_supervisor.py:133-186) ------------
@SIDE
def test_replica_fault_spec_validation(both, which):
    sv, f = both[which].supervisor, both[which].faults
    with pytest.raises(ValueError, match="site"):
        sv.ReplicaFaultSpec("replica-0", "tickle", 1)
    with pytest.raises(ValueError, match="kind"):
        sv.ReplicaFaultSpec("replica-0", sv.SITE_PROBE, 1, kind="poison")
    with pytest.raises(ValueError, match="1-based"):
        sv.ReplicaFaultSpec("replica-0", sv.SITE_PROBE, 0)
    with pytest.raises(ValueError, match="persistent"):
        sv.ReplicaFaultSpec("replica-0", sv.SITE_PROBE, 1, kind=f.FAULT_TRANSIENT,
                            persistent=True)
    assert sv.REPLICA_SITES == both[0].supervisor.REPLICA_SITES == (
        "probe", "submit", "transfer_in", "drain_extract", "handoff_publish",
        "handoff_revive")


@SIDE
def test_injector_fires_on_occurrence_and_persists_host_death(both, which):
    sv, f = both[which].supervisor, both[which].faults
    inj = sv.ReplicaFaultInjector(schedule=[
        sv.ReplicaFaultSpec("replica-1", sv.SITE_PROBE, 2, persistent=True),
        sv.ReplicaFaultSpec("replica-0", sv.SITE_SUBMIT, 1, kind=f.FAULT_TRANSIENT)])
    inj.check("replica-1", sv.SITE_PROBE)
    with pytest.raises(f.TransientDispatchError):
        inj.check("replica-0", sv.SITE_SUBMIT)
    with pytest.raises(f.ReplicaUnreachableError):
        inj.check("replica-1", sv.SITE_PROBE)
    with pytest.raises(f.ReplicaUnreachableError):
        inj.check("replica-1", sv.SITE_SUBMIT)
    inj.check("replica-0", sv.SITE_PROBE)
    inj.revive("replica-1")
    inj.check("replica-1", sv.SITE_PROBE)
    assert inj.visits("replica-1", sv.SITE_PROBE) == 3
    assert len(inj.fired) == 2


def test_injector_seeded_is_reproducible_and_the_jax_packages(both):
    rids = ["replica-0", "replica-1", "replica-2"]
    jsv, tsv = both[0].supervisor, both[1].supervisor
    a = tsv.ReplicaFaultInjector.seeded(7, rids)
    assert a.schedule == tsv.ReplicaFaultInjector.seeded(7, rids).schedule
    kills = [s for s in a.schedule if s.persistent]
    assert len(kills) == 1 and kills[0].kind == both[1].faults.FAULT_REPLICA_UNREACHABLE
    assert tsv.ReplicaFaultInjector.seeded(8, rids).schedule != a.schedule
    for seed in range(6):
        got = tsv.ReplicaFaultInjector.seeded(seed, rids).schedule
        want = jsv.ReplicaFaultInjector.seeded(seed, rids).schedule
        assert [tuple(vars(s).values()) for s in got] == [tuple(vars(s).values()) for s in want]


# -- the supervised call wrapper (test_supervisor.py:192-266) ------------------------
@SIDE
def test_supervised_call_retries_transient_with_capped_jittered_backoff(both, which):
    side = both[which]
    rs, router = stub_fleet(side, 2)
    delays = []
    sup = supervisor(side, rs, router, max_call_retries=3, backoff_base_s=0.01,
                     backoff_cap_s=0.02, sleep=delays.append)
    calls = {"n": 0}

    def flaky(faults=side.faults):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise faults.TransientDispatchError("tunnel flake")
        return "ok"

    assert sup.supervised_call(rs.handles[0], side.supervisor.SITE_PROBE, flaky) == "ok"
    assert calls["n"] == 3 and sup.supervised_retries == 2
    assert len(delays) == 2 and all(0.0 < d <= 0.02 for d in delays)
    delays2 = []
    sup2 = supervisor(side, rs, router, max_call_retries=3, backoff_base_s=0.01,
                      backoff_cap_s=0.02, sleep=delays2.append)
    calls["n"] = 0
    sup2.supervised_call(rs.handles[0], side.supervisor.SITE_PROBE, flaky)
    assert delays2 == delays[:2]
    if which == 1:  # the port's jitter is the JAX package's, draw for draw
        jdelays = []
        jside = both[0]
        jrs, jrouter = stub_fleet(jside, 2)
        jsup = supervisor(jside, jrs, jrouter, max_call_retries=3, backoff_base_s=0.01,
                          backoff_cap_s=0.02, sleep=jdelays.append)
        calls["n"] = 0
        jsup.supervised_call(jrs.handles[0], jside.supervisor.SITE_PROBE, flaky,
                             faults=jside.faults)
        assert jdelays == delays[:2]


@SIDE
def test_supervised_call_escalates_to_replica_unreachable(both, which):
    side = both[which]
    f = side.faults
    rs, router = stub_fleet(side, 2)
    sup = supervisor(side, rs, router, max_call_retries=1)

    def always_flaky():
        raise f.TransientDispatchError("connection reset")

    with pytest.raises(f.ReplicaUnreachableError) as exc_info:
        sup.supervised_call(rs.handles[0], side.supervisor.SITE_SUBMIT, always_flaky)
    err = exc_info.value
    assert err.replica == "replica-0" and err.site == side.supervisor.SITE_SUBMIT
    assert f.classify_fault(err) == f.FAULT_REPLICA_UNREACHABLE
    assert isinstance(err.__cause__, f.TransientDispatchError)
    calls = {"n": 0}

    def hard():
        calls["n"] += 1
        raise ValueError("schema corrupt")

    with pytest.raises(f.ReplicaUnreachableError):
        sup.supervised_call(rs.handles[0], side.supervisor.SITE_PROBE, hard)
    assert calls["n"] == 1


@SIDE
def test_supervised_call_timeout_classifies_unreachable(both, which):
    side = both[which]
    rs, router = stub_fleet(side, 2)
    sup = supervisor(side, rs, router, call_timeout_s=0.05, max_call_retries=0)

    def hung():
        time.sleep(1.0)
        return "too late"

    t0 = time.monotonic()
    with pytest.raises(side.faults.ReplicaUnreachableError):
        sup.supervised_call(rs.handles[0], side.supervisor.SITE_PROBE, hung)
    assert time.monotonic() - t0 < 0.8


# -- the health machine (test_supervisor.py:272-410) ---------------------------------
def test_point_blips_never_demote(both):
    def scenario(side):
        rs, router = stub_fleet(side, 2)
        inj = side.supervisor.ReplicaFaultInjector()
        sup = supervisor(side, rs, router, fault_injector=inj)
        for occurrence in (1, 3, 5, 7):
            inj.add(side.supervisor.ReplicaFaultSpec("replica-0", side.supervisor.SITE_PROBE,
                                                     occurrence))
        health = [sup.probe() for _ in range(8)]
        assert rs.handles[0].health == side.constants.REPLICA_HEALTH_ACTIVE
        assert sup.replica_suspects == 0
        return health, sup_view(sup)

    fp.twin(both, scenario)


def test_health_machine_suspect_excludes_then_dead_fails_over(both):
    def scenario(side):
        c, f = side.constants, side.faults
        rs, router = stub_fleet(side, 3)
        inj = side.supervisor.ReplicaFaultInjector()
        sup = supervisor(side, rs, router, fault_injector=inj)
        fut = sup.submit([1, 2, 3, 4, 5, 6, 7, 8], max_new=4, tenant="t")
        pinned = router._sticky["t"]
        inj.kill(pinned)
        sup.probe()
        assert rs.get(pinned).health == c.REPLICA_HEALTH_ACTIVE
        sup.probe()
        assert rs.get(pinned).health == c.REPLICA_HEALTH_SUSPECT
        assert not rs.get(pinned).admitting
        picks = [router.select([9, 9, 9], tenant="t").replica_id for _ in range(6)]
        assert pinned not in picks
        sup.probe()
        sup.probe()
        handle = rs.get(pinned)
        assert handle.health == c.REPLICA_HEALTH_DEAD
        assert handle.state == c.REPLICA_STATE_RETIRED
        assert sup.replica_suspects == 1 and sup.replica_deaths == 1
        err = fut.exception()
        assert isinstance(err, f.ReplicaLostError)
        assert f.classify_fault(err) == f.FAULT_REPLICA_LOST
        assert (err.prompt, err.max_new, err.tenant, err.replica) == (
            [1, 2, 3, 4, 5, 6, 7, 8], 4, "t", pinned)
        assert sup.futures_errored == 1
        assert handle.shadow == set() and router._sticky.get("t") != pinned
        assert [e["event"] for e in sup.events] == [
            c.FLEET_EV_SUSPECT, c.FLEET_EV_DEATH, c.FLEET_EV_FAILOVER]
        after = [router.select([5, 5, 5]).replica_id for _ in range(6)]
        assert pinned not in after
        return pinned, picks, after, sup_view(sup)

    fp.twin(both, scenario)


def test_suspect_recovery_requires_full_healthy_window(both):
    def scenario(side):
        c = side.constants
        rs, router = stub_fleet(side, 2)
        inj = side.supervisor.ReplicaFaultInjector()
        sup = supervisor(side, rs, router, dead_after=10, recover_after=3, fault_injector=inj)
        inj.kill("replica-1")
        sup.probe()
        sup.probe()
        assert rs.handles[1].health == c.REPLICA_HEALTH_SUSPECT
        inj.revive("replica-1")
        sup.probe()
        assert rs.handles[1].health == c.REPLICA_HEALTH_SUSPECT
        assert all(router.select([i, i]).replica_id == "replica-0" for i in range(4))
        sup.probe()
        sup.probe()
        assert rs.handles[1].health == c.REPLICA_HEALTH_ACTIVE
        picked = {router.select([7, 7, 7 + i]).replica_id for i in range(6)}
        assert "replica-1" in picked
        assert [e["event"] for e in sup.events] == [c.FLEET_EV_SUSPECT, c.FLEET_EV_RECOVERED]
        inj.kill("replica-1")
        sup.probe()
        inj.revive("replica-1")
        sup.probe()
        assert rs.handles[1].health == c.REPLICA_HEALTH_ACTIVE
        return sorted(picked), sup_view(sup)

    fp.twin(both, scenario)


def test_submit_retries_next_replica_on_unreachable(both):
    def scenario(side):
        rs, router = stub_fleet(side, 3)
        inj = side.supervisor.ReplicaFaultInjector()
        sup = supervisor(side, rs, router, fault_injector=inj)
        prompt = list(range(1, 18))
        first = router.select(prompt)
        inj.kill(first.replica_id)
        fut = sup.submit(prompt, max_new=4)
        assert isinstance(fut, Future) and not fut.done()
        assert sum(len(h.engine.submitted) for h in rs.handles) == 1
        assert rs.get(first.replica_id).engine.submitted == []
        assert sup._health[first.replica_id].fail_streak == 1
        return first.replica_id, [h.engine.submitted for h in rs.handles], sup_view(sup)

    fp.twin(both, scenario)


@SIDE
def test_submit_racing_replica_death_resolves_future(both, which):
    side = both[which]
    rs, router = stub_fleet(side, 1)
    sup = supervisor(side, rs, router)
    victim = rs.handles[0]
    orig_submit = victim.engine.submit

    def racing_submit(prompt, max_new, tenant=None, trace_id=None):
        fut = orig_submit(prompt, max_new, tenant=tenant, trace_id=trace_id)
        sup.mark_dead(victim.replica_id)
        return fut

    victim.engine.submit = racing_submit
    fut = sup.submit([1, 2, 3], max_new=4, tenant="t")
    assert fut.done()
    err = fut.exception()
    assert isinstance(err, side.faults.ReplicaLostError)
    assert (err.prompt, err.max_new, err.tenant, err.replica) == (
        [1, 2, 3], 4, "t", victim.replica_id)
    assert sup.futures_errored == 1
    assert not sup._streams.get(victim.replica_id)


@SIDE
def test_probe_releases_state_lock_during_supervised_calls(both, which):
    side = both[which]
    rs, router = stub_fleet(side, 2)
    sup = supervisor(side, rs, router)
    entered, release = threading.Event(), threading.Event()
    orig_probe = rs.handles[0].engine.probe

    def slow_probe():
        # Only the sweep's call blocks; the router's load probe during the
        # submit below answers at once.
        if not entered.is_set():
            entered.set()
            assert release.wait(10)
        return orig_probe()

    rs.handles[0].engine.probe = slow_probe
    t = threading.Thread(target=sup.probe, daemon=True)
    t.start()
    assert entered.wait(10)
    try:
        assert sup._lock.acquire(timeout=2)
        sup._lock.release()
        assert isinstance(sup.submit([1, 2, 3], max_new=4), Future)
    finally:
        release.set()
    t.join(10)
    assert not t.is_alive()
    assert sum(len(v) for v in sup._streams.values()) == 1


def test_tracked_streams_pruned_after_completion(both):
    def scenario(side):
        rs, router = stub_fleet(side, 2)
        sup = supervisor(side, rs, router)
        futs = [sup.submit([1, 2, i], max_new=4) for i in range(6)]
        counts = [sum(len(v) for v in sup._streams.values())]
        for f in futs[:4]:
            f.set_result([0])
        sup.probe()
        counts.append(sum(len(v) for v in sup._streams.values()))
        for f in futs[4:]:
            f.set_result([0])
        sup.probe()
        counts.append(sum(len(v) for v in sup._streams.values()))
        assert counts == [6, 2, 0]
        assert sum(len(v) for v in sup._checkpoints.values()) == 0
        return counts, sup_view(sup)

    fp.twin(both, scenario)


def test_supervised_drain_routes_sites_through_wrapper(both):
    def scenario(side):
        sv = side.supervisor
        rs, router = stub_fleet(side, 2)
        inj = sv.ReplicaFaultInjector(schedule=[sv.ReplicaFaultSpec(
            "replica-0", sv.SITE_DRAIN_EXTRACT, 1, kind=side.faults.FAULT_TRANSIENT)])
        sup = supervisor(side, rs, router, fault_injector=inj)
        report = side.drain.drain_replica(rs, router, "replica-0", supervisor=sup)
        assert report.rolled_back == 0
        assert rs.handles[0].state == side.constants.REPLICA_STATE_RETIRED
        assert inj.visits("replica-0", sv.SITE_DRAIN_EXTRACT) == 2
        assert sup.supervised_retries == 1
        return fp.report(report), sup_view(sup)

    fp.twin(both, scenario)


def test_failover_rides_the_streams_existing_trace(both):
    def scenario(side):
        c = side.constants
        tracer = side.Tracer()
        rs = side.replica.ReplicaSet([StubEngine(c) for _ in range(2)])
        router = side.router.PrefixRouter(rs, tracer=tracer)
        sup = supervisor(side, rs, router)
        fut = sup.submit([1, 2, 3], max_new=6)
        rid = next(r for r, streams in sup._streams.items() if streams)
        (stream,) = sup._streams[rid].values()
        assert stream.trace_id is not None
        sup._checkpoints.setdefault(rid, {})[id(fut)] = side.checkpoint.SlotCheckpoint(
            prompt=[1, 2, 3], generated=[7, 8], max_new=6, serial=1,
            trace_id=stream.trace_id, future=fut)
        report = sup.mark_dead(rid)
        assert report.failed_over == 1
        names = [e["name"] for e in tracer.trace(stream.trace_id)]
        assert c.TRACE_EV_ROUTER_SELECT in names and c.TRACE_EV_FAILOVER in names
        edge = next(e for e in tracer.trace(stream.trace_id)
                    if e["name"] == c.TRACE_EV_FAILOVER)
        assert edge["attrs"]["src"] == rid and edge["attrs"]["dst"] != rid
        assert edge["attrs"]["replayed"] == 2
        assert len(tracer.trace_ids()) == 1
        return names, edge["attrs"], fp.report(report), sup_view(sup)

    fp.twin(both, scenario)


def test_supervisor_report_pools_into_fleet_merge(both):
    def scenario(side):
        rs, router = stub_fleet(side, 2)
        inj = side.supervisor.ReplicaFaultInjector()
        sup = supervisor(side, rs, router, fault_injector=inj)
        fut = sup.submit([1, 2, 3], max_new=4, tenant="t")
        inj.kill(router._sticky["t"])
        for _ in range(4):
            sup.probe()
        assert fut.done()
        rep = sup.report()
        assert rep.replicas == 0 and rep.replica_deaths == 1 and rep.replica_suspects == 1
        assert rep.futures_errored == 1 and len(rep.failover_latency_samples) == 1
        merged = side.telemetry.ServingReport.merge(
            [side.telemetry.ServingReport(steps_run=5), rep])
        assert merged.replica_deaths == 1 and merged.futures_errored == 1
        assert merged.steps_run == 5 and merged.replicas == 1
        assert merged.failover_latency_p95_s == rep.failover_latency_p95_s
        return sup_view(sup)

    fp.twin(both, scenario)


# -- real engines (test_supervisor.py:554-786) ---------------------------------------
def fleet_reference(side, temperature, prompts, max_new, n=3, **engine_kw):
    """The fault-free oracle: the same fleet shape, router and submission
    order, so each stream's placement and sampling serial match the
    faulted run up to the kill."""
    key = (side.name, temperature, tuple(map(tuple, prompts)), max_new, n,
           tuple(sorted(engine_kw.items())))
    if key not in _REFERENCE:
        rs = fp.fleet(side, n, temperature=temperature, **engine_kw)
        router = side.router.PrefixRouter(rs)
        futs = [router.submit(p, max_new=max_new) for p in prompts]
        assert fp.drive_fleet(side, rs, lambda: all(f.done() for f in futs))
        _REFERENCE[key] = [f.result(1) for f in futs]
        rs.stop()
    return _REFERENCE[key]


_REFERENCE = {}


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_failover_replays_checkpoint_bit_identical(both, temperature):
    max_new = 10

    def scenario(side):
        want = fleet_reference(side, temperature, PROMPTS, max_new)
        rs = fp.fleet(side, 3, temperature=temperature)
        router = side.router.PrefixRouter(rs)
        inj = side.supervisor.ReplicaFaultInjector()
        sup = supervisor(side, rs, router, suspect_after=2, dead_after=3, fault_injector=inj)
        futs = [sup.submit(p, max_new=max_new) for p in PROMPTS]
        victim = rs.handles[0]
        vid = victim.replica_id
        victim_futs = [s.future for s in sup._streams.get(vid, {}).values()]
        assert victim_futs
        assert fp.drive_fleet(side, rs, lambda: all(
            len(ck.generated) >= 1
            for ck in [sup._checkpoints.get(vid, {}).get(id(f)) for f in victim_futs]
            if ck is not None) and len(sup._checkpoints.get(vid, {})) >= len(victim_futs),
            sup=sup, n=64)
        inj.kill(vid)
        assert fp.drive_fleet(side, rs, lambda: all(f.done() for f in futs),
                              downed={vid}, sup=sup)
        assert victim.state == side.constants.REPLICA_STATE_RETIRED
        got = [f.result(1) for f in futs]
        assert got == want
        assert sup.failovers >= len(victim_futs) and sup.futures_errored == 0
        assert sup.failover_replay_tokens >= 1 and len(sup.failover_latency_s) == 1
        for h in rs.handles[1:]:
            assert h.engine._block_mgr.conserved()
            check_invariants(h.engine._block_mgr)
        obs = got, sup_view(sup), [fp.counters(side, h.engine) for h in rs.handles[1:]]
        rs.stop()
        return obs

    fp.twin(both, scenario)


@pytest.mark.parametrize("seed", [1, 3, 4])
def test_fleet_chaos_gate(both, seed):
    """Seeded kill/suspect/recover chaos over a 3-replica fleet mid-traffic,
    greedy and temperature: every stream bit-identical to the fault-free
    run or a classified ReplicaLostError carrying its request, no
    stranded future, no selection of the dead replica after detection,
    every survivor conserved; and the port's run is the JAX package's."""
    max_new = 12

    def scenario(side):
        c = side.constants
        sv = side.supervisor
        rng = random.Random(seed)
        obs = []
        for temperature in (0.0, 0.8):
            want = fleet_reference(side, temperature, PROMPTS, max_new, burst_windows=1)
            rs = fp.fleet(side, 3, temperature=temperature, burst_windows=1)
            router = side.router.PrefixRouter(rs)
            inj = sv.ReplicaFaultInjector(schedule=[sv.ReplicaFaultSpec(
                f"{c.REPLICA_ID_PREFIX}{rng.randrange(3)}", sv.SITE_PROBE,
                rng.randint(1, 3), kind=side.faults.FAULT_TRANSIENT)])
            sup = supervisor(side, rs, router, suspect_after=2, dead_after=3,
                             fault_injector=inj)
            futs = [sup.submit(p, max_new=max_new) for p in PROMPTS]
            victim = rs.handles[rng.randrange(3)]
            vid = victim.replica_id
            kill_wave = rng.randint(2, 5)
            downed = set()
            dead_selindex = None
            for wave in range(600):
                for h in rs.handles:
                    if (h.state == c.REPLICA_STATE_ACTIVE and h.replica_id not in downed
                            and h.engine._thread is None):
                        h.engine._tick()
                if wave == kill_wave:
                    inj.kill(vid)
                    downed.add(vid)
                fp.probe(rs, sup)
                if dead_selindex is None and victim.health == c.REPLICA_HEALTH_DEAD:
                    dead_selindex = victim.routed_requests
                if all(f.done() for f in futs):
                    break
            assert all(f.done() for f in futs), "stranded futures after death"
            outcomes = []
            for i, fut in enumerate(futs):
                if fut.exception() is None:
                    assert fut.result(0) == want[i], f"stream {i} diverged"
                    outcomes.append(fut.result(0))
                else:
                    err = fut.exception()
                    assert isinstance(err, side.faults.ReplicaLostError)
                    assert err.prompt == PROMPTS[i]
                    outcomes.append(("lost", err.replica))
            assert victim.health == c.REPLICA_HEALTH_DEAD
            assert victim.routed_requests == dead_selindex
            assert victim.state == c.REPLICA_STATE_RETIRED
            for h in rs.handles:
                if h.replica_id != vid:
                    assert h.engine._block_mgr.conserved(), h.replica_id
                    check_invariants(h.engine._block_mgr)
            obs.append((outcomes, sup_view(sup), wave))
            rs.stop()
        return obs

    fp.twin(both, scenario)


def _raise_transfer(*a, **kw):
    raise RuntimeError("injected destination transfer failure")


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_drain_transfer_failure_falls_to_next_candidate(both, temperature):
    max_new = 10

    def scenario(side):
        want = fleet_reference(side, temperature, PROMPTS[:3], max_new)
        rs = fp.fleet(side, 3, temperature=temperature)
        router = side.router.PrefixRouter(rs)
        futs = [router.submit(p, max_new=max_new) for p in PROMPTS[:3]]
        src = rs.handles[0]
        assert fp.drive_fleet(side, rs, lambda: any(
            s.active and s.phase == "decoding" for s in src.engine._slots), n=64)
        broken = rs.handles[1]
        broken.engine.transfer_in_checkpoint = _raise_transfer
        broken.engine.transfer_in_request = _raise_transfer
        report = side.drain.drain_replica(rs, router, src.replica_id)
        assert report.rolled_back == 0
        assert src.state == side.constants.REPLICA_STATE_RETIRED
        assert set(report.destinations) <= {"replica-2"}
        assert src.engine._block_mgr.conserved()
        assert fp.drive_fleet(side, rs, lambda: all(f.done() for f in futs))
        got = [f.result(1) for f in futs]
        assert got == want
        assert rs.handles[2].engine._block_mgr.conserved()
        check_invariants(rs.handles[2].engine._block_mgr)
        obs = got, fp.report(report), fp.counters(side, rs.handles[2].engine)
        rs.stop()
        return obs

    fp.twin(both, scenario)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_drain_rolls_back_to_reopened_source_when_no_candidate(both, temperature):
    max_new = 10

    def scenario(side):
        want = fleet_reference(side, temperature, PROMPTS[:2], max_new, n=2)
        rs = fp.fleet(side, 2, temperature=temperature)
        router = side.router.PrefixRouter(rs)
        futs = [router.submit(p, max_new=max_new) for p in PROMPTS[:2]]
        src = rs.handles[0]
        assert fp.drive_fleet(side, rs, lambda: any(
            s.active and s.phase == "decoding" for s in src.engine._slots), n=64)
        broken = rs.handles[1]
        broken.engine.transfer_in_checkpoint = _raise_transfer
        broken.engine.transfer_in_request = _raise_transfer
        report = side.drain.drain_replica(rs, router, src.replica_id)
        assert report.rolled_back >= 1
        assert src.state == side.constants.REPLICA_STATE_ACTIVE
        assert src.engine._block_mgr.conserved()
        assert fp.drive_fleet(side, rs, lambda: all(f.done() for f in futs))
        got = [f.result(1) for f in futs]
        assert got == want
        check_invariants(src.engine._block_mgr)
        assert broken.engine._block_mgr.conserved()
        obs = got, fp.report(report), fp.counters(side, src.engine)
        rs.stop()
        return obs

    fp.twin(both, scenario)


@SIDE
def test_drain_rollback_restarts_thread_driven_source(both, which):
    """The rollback on a thread-driven fleet starts a fresh loop thread on
    the reopened source, or the rolled-back streams would wait forever."""
    side = both[which]
    max_new = 24
    solo = fp.engine(side)
    want = fp.run(solo, PROMPTS[:2], max_new=max_new, idle_ticks=0)
    solo.stop()
    rs = fp.fleet(side, 2)
    router = side.router.PrefixRouter(rs)
    src, broken = rs.handles
    broken.engine.transfer_in_checkpoint = _raise_transfer
    broken.engine.transfer_in_request = _raise_transfer
    futs = [src.engine.submit(p, max_new=max_new) for p in PROMPTS[:2]]
    for h in rs.handles:
        h.engine.start()
    report = side.drain.drain_replica(rs, router, src.replica_id)
    assert report.rolled_back >= 1
    assert src.state == side.constants.REPLICA_STATE_ACTIVE
    assert src.engine._thread is not None
    assert [f.result(30) for f in futs] == want
    rs.stop()  # a future resolves just before its slot is released: read after the join
    assert src.engine._block_mgr.conserved()
    check_invariants(src.engine._block_mgr)


# -- the engine's hooks (test_supervisor.py:909-982) ---------------------------------
def test_checkpoint_snapshot_is_passive_and_prefix_valid(both):
    def scenario(side):
        max_new = 12
        eng = fp.engine(side, burst_windows=1)
        fut = eng.submit(PROMPTS[0], max_new=max_new)
        for _ in range(200):
            eng._tick()
            if any(s.active and s.phase == "decoding" and len(s.refs) >= 2
                   for s in eng._slots):
                break
        cks = eng.checkpoint_snapshot()
        assert len(cks) == 1
        ck = cks[0]
        assert ck.prompt == PROMPTS[0] and 0 <= len(ck.generated) < max_new
        assert ck.future is fut and not fut.done()
        for _ in range(2000):
            if fut.done():
                break
            eng._tick()
        out = fut.result(1)
        eng.stop()
        assert out[: len(ck.generated)] == ck.generated
        solo = fp.engine(side)
        assert out == fp.run(solo, [PROMPTS[0]], max_new=max_new, idle_ticks=0)[0]
        solo.stop()
        return out, len(cks), fp.counters(side, eng)

    fp.twin(both, scenario)


def test_burst_boundary_checkpoint_hook_fires(both):
    def scenario(side):
        captured = []
        eng = fp.engine(side, n_slots=1, checkpoint_hook=captured.append, burst_windows=4,
                        steps_per_dispatch=2)
        fut = eng.submit(PROMPTS[0], max_new=16)
        for _ in range(400):
            if fut.done():
                break
            eng._tick()
        assert fut.done() and eng.burst_dispatches >= 1
        assert len(captured) >= 1 and all(isinstance(cks, list) for cks in captured)
        out = fut.result(0)
        for cks in captured:  # each capture a prefix of the stream
            assert all(out[: len(ck.generated)] == ck.generated for ck in cks)
        eng.stop()
        return out, len(captured), fp.counters(side, eng)

    fp.twin(both, scenario)


def test_forsake_disowns_without_failing_then_reopen_accepts(both):
    def scenario(side):
        eng = fp.engine(side, burst_windows=1)
        fut = eng.submit(PROMPTS[0], max_new=32)
        for _ in range(6):
            eng._tick()
        assert not fut.done()
        disowned = eng.forsake()
        assert fut in disowned and not fut.done()
        eng.stop()
        assert not fut.done()
        eng2 = fp.engine(side)
        eng2.stop(drain=True, drain_timeout_s=10)
        with pytest.raises(RuntimeError, match="stopped"):
            eng2.submit(PROMPTS[0], max_new=2)
        eng2.reopen()
        fut2 = eng2.submit(PROMPTS[0], max_new=2)
        for _ in range(200):
            if fut2.done():
                break
            eng2._tick()
        out = fut2.result(1)
        assert len(out) == 2
        eng2.stop()
        return len(disowned), out

    fp.twin(both, scenario)
