"""The port's phase-disaggregated serving (nos_tpu_torch/serving/disagg.py
and the engine's handoff halves) against the JAX package, on the CPU,
mirroring tests/test_disagg.py.

Two substrates, as in the reference: stub engines for the roles and the
router's phase filters, on both packages' classes; real engine fleets
(the shared tiny serving model, ticked by hand, a downed host simply no
longer ticked) for the handoff. Each real case runs one scenario on each
side (tests/test_torch_fleet_parity.py) and holds the port to the JAX
package: equal tokens, equal handoff counters on every engine, equal
coordinator reports and events (wall-clock fields aside), equal
`collect_serving` counters and store state; then each side to the
reference's oracles: disaggregated equal to colocated bit for bit, the
handed-off KV revived from the store, every stream of an in-transfer
death either equal or a classified ReplicaLostError carrying its
request, pools and store conserved."""

from concurrent.futures import Future

import pytest

import test_torch_fleet_parity as fp
from test_block_manager import check_invariants

_time_limit = fp.time_limit(240)

PROMPTS = [
    [4, 9, 2, 33, 7, 1, 8, 5, 12, 13, 14, 15, 16, 17, 18, 19],
    [40, 41, 42, 43, 44, 45, 46, 47],
    [9, 8, 7, 6, 5, 4, 3, 2, 1, 96, 95, 94, 93, 92, 91, 90],
]
MAX_NEW = 8
# tests/test_disagg.py:201: the reference tests' engine, a pool of 8 blocks.
POOL = dict(total_blocks=1 + 8)
SIDE = pytest.mark.parametrize("which", [0, 1], ids=["jax", "torch"])
HANDOFF_COUNTERS = ("handoff_exports", "handoff_ingests", "handoff_published_blocks",
                    "handoff_revived_tokens")


@pytest.fixture(scope="module")
def both():
    return fp.sides()


# -- the stub substrate (test_disagg.py:64-178) ----------------------------------------
class StubEngine:
    block_size = 8

    def __init__(self, c, backlog=0):
        self.c = c
        self.backlog = backlog

    def probe(self):
        c = self.c
        return {c.PROBE_KEY_ACTIVE_SLOTS: 0, c.PROBE_KEY_QUEUED_REQUESTS: 0,
                c.PROBE_KEY_PREFILL_BACKLOG: self.backlog, c.PROBE_KEY_DRAINING: False,
                c.PROBE_KEY_TP_DEVICES: 1, c.PROBE_KEY_SLOTS_TOTAL: 2,
                c.PROBE_KEY_KV_BLOCKS_TOTAL: 15}

    def prefix_keys(self):
        return frozenset()

    def submit(self, prompt, max_new, tenant=None, trace_id=None):
        return Future()

    def stop(self, **kw):
        pass


def role_fleet(side, roles, backlogs=None):
    engines = [StubEngine(side.constants, backlogs[i] if backlogs else 0)
               for i in range(len(roles))]
    rs = side.replica.ReplicaSet(engines, roles=roles)
    return rs, side.router.PrefixRouter(rs)


@SIDE
def test_replica_roles_validate_and_snapshot(both, which):
    side = both[which]
    c = side.constants
    rs = side.replica.ReplicaSet([StubEngine(c), StubEngine(c)])
    for h in rs.handles:
        assert h.role == c.REPLICA_ROLE_UNIFIED
        assert all(h.serves_phase(p) for p in (None, c.ROUTER_PHASE_PREFILL,
                                               c.ROUTER_PHASE_DECODE))
        assert h.snapshot()[c.REPLICA_KEY_ROLE] == h.role
    with pytest.raises(ValueError, match="role"):
        side.replica.ReplicaSet([StubEngine(c)], roles=["gpu"])
    with pytest.raises(ValueError, match="roles"):
        side.replica.ReplicaSet([StubEngine(c)], roles=[c.REPLICA_ROLE_PREFILL] * 2)
    rs2, _ = role_fleet(side, [c.REPLICA_ROLE_PREFILL, c.REPLICA_ROLE_DECODE])
    pre, dec = rs2.handles
    assert pre.serves_phase(c.ROUTER_PHASE_PREFILL)
    assert not pre.serves_phase(c.ROUTER_PHASE_DECODE)
    assert dec.serves_phase(c.ROUTER_PHASE_DECODE)
    assert not dec.serves_phase(c.ROUTER_PHASE_PREFILL)
    assert pre.serves_phase(None) and dec.serves_phase(None)


@SIDE
def test_router_phase_filters_candidates(both, which):
    side = both[which]
    c = side.constants
    rs, router = role_fleet(side, [c.REPLICA_ROLE_PREFILL, c.REPLICA_ROLE_DECODE,
                                   c.REPLICA_ROLE_UNIFIED])
    pre, dec, uni = rs.handles
    prompt = list(range(1, 17))
    for _ in range(4):
        assert router.select(prompt, phase=c.ROUTER_PHASE_PREFILL) in (pre, uni)
        assert router.select(prompt, phase=c.ROUTER_PHASE_DECODE) in (dec, uni)
    with pytest.raises(ValueError, match="phase"):
        router.select(prompt, phase="verify")
    with pytest.raises(RuntimeError, match="prefill-capable"):
        router.select(prompt, exclude=[pre, uni], phase=c.ROUTER_PHASE_PREFILL)
    assert router.select(prompt) in (pre, dec, uni)


@SIDE
def test_router_prefill_phase_prefers_free_prefill_budget(both, which):
    side = both[which]
    c = side.constants
    rs, router = role_fleet(side, [c.REPLICA_ROLE_PREFILL] * 2, backlogs=[4096, 0])
    _, free = rs.handles
    for _ in range(4):
        assert router.select(list(range(1, 17)), phase=c.ROUTER_PHASE_PREFILL) is free


@SIDE
def test_handoff_sites_registered_and_report_merges_pooled(both, which):
    side = both[which]
    sv, f = side.supervisor, side.faults
    assert sv.SITE_HANDOFF_PUBLISH in sv.REPLICA_SITES
    assert sv.SITE_HANDOFF_REVIVE in sv.REPLICA_SITES
    sv.ReplicaFaultSpec("replica-0", sv.SITE_HANDOFF_PUBLISH, 1,
                        kind=f.FAULT_REPLICA_UNREACHABLE, persistent=True)
    SR = side.telemetry.ServingReport
    a = SR(replicas=0, handoffs=2, handoff_reroutes=1, handoff_wall_s=0.5,
           handoff_latency_p95_s=1.0, handoff_latency_samples=[1.0, 1.0])
    b = SR(replicas=1, handoffs=1, handoffs_errored=1, handoff_wall_s=0.25,
           handoff_latency_p95_s=9.0, handoff_latency_samples=[9.0])
    m = SR.merge([a, b])
    assert (m.handoffs, m.handoff_reroutes, m.handoffs_errored) == (3, 1, 1)
    assert m.handoff_wall_s == pytest.approx(0.75)
    assert sorted(m.handoff_latency_samples) == [1.0, 1.0, 9.0]
    assert m.handoff_latency_p95_s == pytest.approx(9.0)
    assert m.handoff_latency_p50_s == pytest.approx(1.0)


# -- the real-engine substrate (test_disagg.py:184-467) ---------------------------------
def solo(side, temperature, max_new=MAX_NEW, **kw):
    """The colocated oracle (test_disagg.py:236): one engine, the traffic in
    submission order, so its serials match the disaggregated fleet's."""
    eng = fp.engine(side, temperature=temperature, **POOL, **kw)
    futs = [eng.submit(p, max_new=max_new) for p in PROMPTS]
    for _ in range(3000):
        if all(f.done() for f in futs):
            break
        eng._tick()
    outs = [list(f.result(1)) for f in futs]
    eng.stop()
    return outs


def outcome(fut):
    try:
        return list(fut.result(1))
    except Exception as exc:  # noqa: BLE001 - the classified loss is the outcome
        return (type(exc).__name__, exc.prompt, exc.max_new)


def events(coord):
    return [{k: v for k, v in e.items() if k != "t"} for e in coord.events]


def coord_report(coord):
    return fp.report(coord.report(), drop=("handoff_wall_s", "handoff_latency_p50_s",
                                           "handoff_latency_p95_s",
                                           "handoff_latency_samples"))


def conserved(side, rs, store):
    assert store.conserved()
    for h in rs.handles:
        if h.state == side.constants.REPLICA_STATE_ACTIVE:
            assert h.engine._block_mgr.conserved()
            check_invariants(h.engine._block_mgr)


def disagg_run(side, temperature, faults=(), roles=None, n_prompts=None, max_new=MAX_NEW,
               **kw):
    """test_disagg.py:255: a prefill replica and two decode replicas over one
    store, supervised, every request through the coordinator, ticked by
    hand until every future resolves."""
    c, sv = side.constants, side.supervisor
    roles = roles or [c.REPLICA_ROLE_PREFILL, c.REPLICA_ROLE_DECODE, c.REPLICA_ROLE_DECODE]
    store = side.kv_store.FleetKVStore(capacity_bytes=1 << 22)
    rs = side.replica.ReplicaSet([fp.engine(side, store=store, temperature=temperature, **POOL,
                                            **kw) for _ in roles], roles=roles)
    router = side.router.PrefixRouter(rs, kv_store=store)
    inj = sv.ReplicaFaultInjector(schedule=[
        sv.ReplicaFaultSpec(victim, site, 1, kind=side.faults.FAULT_REPLICA_UNREACHABLE,
                            persistent=True) for victim, site in faults])
    sup = sv.FleetSupervisor(rs, router, suspect_after=2, dead_after=3, fault_injector=inj,
                             sleep=lambda s: None)
    coord = side.disagg.HandoffCoordinator(rs, router, supervisor=sup)
    futs = [coord.submit(p, max_new=max_new) for p in PROMPTS[:n_prompts]]
    downed = set()

    def pred():
        downed.update(inj.downed)  # a fired persistent spec is a host death
        return all(f.done() for f in futs)

    assert fp.drive_fleet(side, rs, pred, n=2000, downed=downed, sup=sup)
    conserved(side, rs, store)
    obs = {
        "outs": [outcome(f) for f in futs],
        "engines": [{n: getattr(h.engine, n) for n in HANDOFF_COUNTERS} for h in rs.handles],
        "counters": [fp.counters(side, h.engine) for h in rs.handles],
        "states": [h.state for h in rs.handles],
        "coord": {k: v for k, v in coord.snapshot().items()
                  if k not in ("events", "handoff_wall_s")},
        "events": events(coord),
        "report": coord_report(coord),
        "store": fp.store_state(store),
    }
    coord.detach()
    rs.stop()
    return obs


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "temp"])
def test_disaggregated_equals_colocated_and_the_jax_packages(both, temperature):
    """The disaggregation oracle (test_disagg.py:286) on both packages: the
    port's disaggregated streams, handoff counters, coordinator report and
    events equal the JAX package's, and on each side they equal the
    colocated run bit for bit with the prompt KV revived from the store."""
    c = both[1].constants
    got = fp.twin(both, lambda side: disagg_run(side, temperature))
    assert got["outs"] == fp.twin(both, lambda side: solo(side, temperature))
    pre, decs = got["engines"][0], got["engines"][1:]
    assert got["coord"] == {"handoffs": len(PROMPTS), "handoff_reroutes": 0,
                            "handoffs_errored": 0}
    assert pre["handoff_exports"] == len(PROMPTS)
    assert pre["handoff_published_blocks"] + got["counters"][0]["store_published_blocks"] > 0
    assert sum(e["handoff_ingests"] for e in decs) == len(PROMPTS)
    assert sum(e["handoff_revived_tokens"] for e in decs) > 0
    assert all(e["event"] == c.FLEET_EV_HANDOFF for e in got["events"])
    assert got["report"]["handoffs"] == len(PROMPTS)


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "temp"])
@pytest.mark.parametrize("site,victim", [("handoff_publish", "replica-0"),
                                         ("handoff_revive", "replica-1")],
                         ids=["publish-source", "revive-destination"])
def test_handoff_in_transfer_death(both, temperature, site, victim):
    """test_disagg.py:329: the source dying mid-publish and the destination
    dying mid-revive. The port resolves every stream as the JAX package
    does; on each side every stream finishes bit for bit on a survivor or
    resolves with a classified ReplicaLostError carrying its request."""
    c = both[1].constants
    want = fp.twin(both, lambda side: solo(side, temperature))
    got = fp.twin(both, lambda side: disagg_run(side, temperature, faults=[(victim, site)]))
    matched = sum(o == w for o, w in zip(got["outs"], want))
    lost = [o for o in got["outs"] if isinstance(o, tuple)]
    assert matched + len(lost) == len(PROMPTS)
    assert all(o[0] == "ReplicaLostError" and o[1] is not None and o[2] == MAX_NEW
               for o in lost)
    if site == "handoff_publish":
        assert matched >= 1
        assert got["states"][0] == c.REPLICA_STATE_RETIRED
    else:
        assert not lost and got["coord"]["handoff_reroutes"] >= 1
        assert any(e["event"] == c.FLEET_EV_HANDOFF_REROUTE for e in got["events"])


def test_handoff_no_decode_survivor_resolves_classified(both):
    """test_disagg.py:393: every decode-capable replica down, so the handoff
    resolves the stream with a classified error carrying the request."""
    c = both[1].constants
    got = fp.twin(both, lambda side: disagg_run(
        side, 0.0, faults=[("replica-1", "handoff_revive")], n_prompts=1,
        roles=[c.REPLICA_ROLE_PREFILL, c.REPLICA_ROLE_DECODE]))
    assert got["outs"] == [("ReplicaLostError", PROMPTS[0], MAX_NEW)]
    assert got["coord"]["handoffs_errored"] == 1
    assert any(e["event"] == c.FLEET_EV_HANDOFF_FAILED for e in got["events"])


def test_unified_marker_inert_without_coordinator(both):
    """test_disagg.py:441: a handoff-marked request on an engine with no
    armed hook decodes in place."""
    def run(side):
        eng = fp.engine(side, **POOL)
        fut = eng.transfer_in_request(PROMPTS[0], max_new=MAX_NEW, handoff=True)
        for _ in range(2000):
            if fut.done():
                break
            eng._tick()
        out = list(fut.result(1))
        assert eng.handoff_exports == 0
        eng.stop()
        return out

    assert fp.twin(both, run) == fp.twin(both, lambda side: solo(side, 0.0))[0]


def test_handoff_with_bursts_keeps_the_jax_engines_counters(both):
    """Bursts on (steps_per_dispatch 2, burst_windows 4, 24 new tokens): the
    exported slot leaves in the wave of its final chunk, before the tick's
    decode dispatch, so no burst window decodes a lane about to leave. The
    port's per-slot macro tokens, dispatch and burst counters equal the JAX
    engine's on every replica, and the streams equal colocated."""
    kw = dict(steps_per_dispatch=2, burst_windows=4, max_new=24)
    got = fp.twin(both, lambda side: disagg_run(side, 0.0, **kw))
    assert got["outs"] == fp.twin(both, lambda side: solo(side, 0.0, **kw))
    assert sum(cn["burst_dispatches"] for cn in got["counters"][1:]) > 0
    assert got["counters"][0]["burst_dispatches"] == 0
    assert got["engines"][0]["handoff_exports"] == len(PROMPTS)


def test_handoff_on_the_int8_pool(both):
    """The int8 pool: payloads ("int8", codes, scales) published and revived,
    the streams equal colocated and the JAX package's."""
    got = fp.twin(both, lambda side: disagg_run(side, 0.0, kv_dtype="int8"))
    assert got["outs"] == fp.twin(both, lambda side: solo(side, 0.0, kv_dtype="int8"))
    assert sum(e["handoff_revived_tokens"] for e in got["engines"][1:]) > 0


def test_raising_hook_is_contained(both):
    """decode_server.py:2858: a handoff hook that raises is contained, the
    export is complete (slot released, future handed over, blocks in the
    store) and the engine keeps serving, as the JAX engine does."""
    def run(side):
        store = side.kv_store.FleetKVStore(capacity_bytes=1 << 22)
        eng = fp.engine(side, store=store, **POOL)
        handed = []

        def hook(ck):
            handed.append(ck)
            raise RuntimeError("hook fault")

        eng.set_handoff_hook(hook)
        fut = eng.transfer_in_request(PROMPTS[0], max_new=MAX_NEW, handoff=True)
        for _ in range(200):
            if handed:
                break
            eng._tick()
        assert len(handed) == 1 and handed[0].future is fut and not fut.done()
        assert not eng._has_outstanding() and not any(s.active for s in eng._slots)
        eng.set_handoff_hook(None)
        after = eng.submit(PROMPTS[1], max_new=MAX_NEW)
        for _ in range(2000):
            if after.done():
                break
            eng._tick()
        out = list(after.result(1))
        obs = (out, list(handed[0].generated), fp.counters(side, eng), fp.store_state(store))
        eng.stop()
        assert not fut.done()  # the hook owned it
        return obs

    fp.twin(both, run)
