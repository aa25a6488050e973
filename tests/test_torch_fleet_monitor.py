"""The port's fleet monitor (nos_tpu_torch/serving/monitor.py) against the
JAX package, on the CPU, mirroring tests/test_fleet_monitor.py.

Two substrates, as in the reference: stub engines (the duck-typed probe
surface, counters moved by hand, the clock injected) for the window math,
the SLO tracker, the rings and the journal, the replay, the gauge hygiene
and the unreachable replica, each case on both packages' classes and,
where it returns a journal or verdicts, the port's equal to the JAX
package's; real engine fleets ticked by hand for the purity oracle and
the pressure transitions, where the port's verdict sequence and journal
equal the JAX monitor's on the same ticks (the monitor's clock counts
samples, so every rate is the same number on both sides; latency
samples are wall clock, so a journal compares their presence)."""

import http.client
import json
import time
from types import SimpleNamespace

import pytest

import test_torch_fleet_parity as fp

_time_limit = fp.time_limit(240)

SIDE = pytest.mark.parametrize("which", [0, 1], ids=["jax", "torch"])


@pytest.fixture(scope="module")
def both():
    return fp.sides()


# -- the stub substrate (test_fleet_monitor.py:40-115) ---------------------------------
class StubEngine:
    """Cumulative counters the test moves by hand, plus the probe surface."""

    def __init__(self, c, n_slots=2, kv_total=15):
        self.c = c
        self.block_size = 8
        self.n_slots = n_slots
        self.kv_total = kv_total
        self.kv_free = kv_total
        self.steps_run = 0
        self.prefill_dispatches = 0
        self.prefill_tokens = 0
        self.spec_tokens_accepted = 0
        self.macro_tokens_by_slot = [0] * n_slots
        self.spills = 0
        self.revives = 0
        self.preemptions = 0
        self.recoveries = 0
        self.ttft_s = []
        self.queue_wait_s = []
        self.ttft_s_by_tenant = {}
        self.queue_wait_s_by_tenant = {}
        self.tokens_by_tenant = {}
        self.admissions_by_tenant = {}
        self.waiting_by_tenant = {}
        self.quota_rows = {}
        self.active_slots = 0
        self.draining = False
        self._block_mgr = SimpleNamespace(counts=lambda: {
            "free": self.kv_free, "cached": 0, "shared": 0, "spilled": 0})

    def probe(self):
        c = self.c
        return {c.PROBE_KEY_ACTIVE_SLOTS: self.active_slots,
                c.PROBE_KEY_QUEUED_REQUESTS: sum(self.waiting_by_tenant.values()),
                c.PROBE_KEY_PREFILL_BACKLOG: 0, c.PROBE_KEY_DRAINING: self.draining,
                c.PROBE_KEY_TP_DEVICES: 1, c.PROBE_KEY_SLOTS_TOTAL: self.n_slots,
                c.PROBE_KEY_KV_BLOCKS_TOTAL: self.kv_total}

    def tenant_probe(self):
        c = self.c
        tenants = (set(self.tokens_by_tenant) | set(self.admissions_by_tenant)
                   | set(self.waiting_by_tenant) | set(self.quota_rows))
        rows = {}
        for t in tenants:
            row = {c.TENANT_KEY_TOKENS: self.tokens_by_tenant.get(t, 0),
                   c.TENANT_KEY_ADMISSIONS: self.admissions_by_tenant.get(t, 0),
                   c.TENANT_KEY_WAITING: self.waiting_by_tenant.get(t, 0)}
            row.update(self.quota_rows.get(t, {}))
            rows[t] = row
        return rows

    def stop(self, **kw):
        pass


def stub_fleet(side, n=2, **kw):
    return side.replica.ReplicaSet([StubEngine(side.constants, **kw) for _ in range(n)])


def verdicts(reports):
    return [(r.window, r.replicas, r.tenants, r.slo_breached, r.headroom) for r in reports]


# -- telemetry: percentile, merge, delta and rates (test_fleet_monitor.py:121-307) -------
@SIDE
def test_percentile_and_merge_edge_cases(both, which):
    tm = both[which].telemetry
    SR = tm.ServingReport
    assert tm.percentile([], 50) == 0.0 and tm.percentile([], 95) == 0.0
    assert tm.percentile([2.5], 50) == 2.5 and tm.percentile([2.5], 95) == 2.5
    merged = SR.merge([])
    assert merged.replicas == 0 and merged.ttft_p95_s == 0.0
    full = SR(steps_run=4, spills=2, ttft_samples=[0.5, 1.5])
    old = SimpleNamespace(steps_run=3, macro_dispatches=1)
    merged = SR.merge([full, old])
    assert (merged.steps_run, merged.macro_dispatches, merged.spills) == (7, 1, 2)
    assert merged.ttft_samples == [0.5, 1.5]
    merged = SR.merge([SR(ttft_samples=[0.25])])
    assert merged.ttft_p50_s == 0.25 and merged.ttft_p95_s == 0.25
    merged = SR.merge([SR(steps_run=2, slot_seconds_total=1.5, kv_block_ticks=8,
                          cost_receipts=1), SimpleNamespace(steps_run=3)])
    assert (merged.steps_run, merged.slot_seconds_total, merged.kv_block_ticks,
            merged.cost_receipts) == (5, 1.5, 8, 1)


@SIDE
def test_report_delta_and_rates(both, which):
    tm = both[which].telemetry
    SR = tm.ServingReport
    d = tm.report_delta(SimpleNamespace(steps_run=7, macro_tokens_by_slot={"0": 10}),
                        SimpleNamespace(steps_run=3, macro_tokens_by_slot={"0": 4}))
    assert (d["steps_run"], d["tokens"], d["kv_block_ticks"]) == (4, 6, 0)
    d = tm.report_delta(SR(steps_run=9, kv_block_ticks=5),
                        SimpleNamespace(steps_run=3, macro_tokens_by_slot={"0": 4}))
    assert d["steps_run"] == 6 and d["kv_block_ticks"] == 5
    prev = SR(steps_run=10, prefill_tokens=64, spills=1, spec_tokens_accepted=5,
              macro_tokens_by_slot={"0": 30, "1": 10}, kv_blocks_free=3)
    cur = SR(steps_run=14, prefill_tokens=96, spills=1, spec_tokens_accepted=9,
             macro_tokens_by_slot={"0": 50, "1": 20}, kv_blocks_free=7)
    d = tm.report_delta(cur, prev)
    assert (d["steps_run"], d["prefill_tokens"], d["spills"], d["tokens"],
            d["kv_blocks_free"]) == (4, 32, 0, 34, 7)
    d = tm.report_delta(SR(steps_run=5, kv_blocks_free=2), None)
    assert (d["steps_run"], d["tokens"], d["kv_blocks_free"]) == (0, 0, 2)
    assert tm.report_delta(SR(steps_run=1), SR(steps_run=9))["steps_run"] == 0
    r = tm.report_rates(SR(macro_tokens_by_slot={"0": 40}, kv_blocks_free=6),
                        SR(macro_tokens_by_slot={"0": 0}), 2.0)
    assert r["tokens"] == 20.0 and r["kv_blocks_free"] == 6.0
    assert tm.report_rates(SR(macro_tokens_by_slot={"0": 40}), None, 0.0)["tokens"] == 0.0


# -- SLOTracker (test_fleet_monitor.py:248-308) ----------------------------------------
@SIDE
def test_slo_trip_recover_and_demand(both, which):
    side = both[which]
    mon, c = side.monitor, side.constants
    slo = mon.SLOTracker({"a": mon.SLOTarget(ttft_p95_s=1.0)}, breach_k=3, breach_n=5)
    assert slo.observe_window("a", ttft_p95_s=5.0, window=1) is True
    assert slo.breached("a") is False  # one spike is noise
    for w in range(2, 6):
        slo.observe_window("a", ttft_p95_s=0.1, window=w)
    assert slo.breached("a") is False
    slo = mon.SLOTracker({"a": mon.SLOTarget(ttft_p95_s=1.0)}, breach_k=3, breach_n=5)
    for w in range(1, 4):
        slo.observe_window("a", ttft_p95_s=2.0, window=w)
    assert slo.breached("a") is True
    for w in range(4, 9):
        slo.observe_window("a", ttft_p95_s=0.1, window=w)
    assert slo.breached("a") is False
    assert [e["event"] for e in slo.events] == [c.SLO_EV_BREACH, c.SLO_EV_RECOVER]
    tok = mon.SLOTracker({"a": mon.SLOTarget(min_tok_s=10.0)}, breach_k=1, breach_n=1)
    assert tok.observe_window("a", tok_s=0.0, demand=False) is False
    assert tok.observe_window("a", tok_s=2.0, demand=True) is True
    lat = mon.SLOTracker({"a": mon.SLOTarget(ttft_p95_s=1.0)}, breach_k=1, breach_n=1)
    assert lat.observe_window("a", ttft_p95_s=None) is False
    assert lat.observe_window("ghost", ttft_p95_s=99.0) is False
    assert lat.breached("ghost") is False
    with pytest.raises(ValueError, match="breach_k"):
        mon.SLOTracker({}, breach_k=4, breach_n=2)
    snap = slo.snapshot()
    assert snap["tenants"]["a"]["sustained"] is False and len(snap["events"]) == 2


# -- classification and headroom (test_fleet_monitor.py:415-467) ----------------------
@SIDE
def test_classification_and_headroom(both, which):
    side = both[which]
    mon, c = side.monitor, side.constants
    assert mon.classify_tenant({"quota_starved": True, "usage": 0.1, "min_share": 0.5,
                                "tokens": 0, "waiting": 2}) == c.PRESSURE_TENANT_STARVED
    assert mon.classify_tenant({"quota_borrower": True, "usage": 0.8, "min_share": 0.0,
                                "tokens": 12}) == c.PRESSURE_TENANT_BORROWING
    assert mon.classify_tenant({"quota_borrower": True, "usage": 0.0, "min_share": 0.0,
                                "tokens": 0}) == c.PRESSURE_TENANT_WITHIN
    active = c.REPLICA_STATE_ACTIVE
    assert mon.classify_replica({"lifecycle": c.REPLICA_STATE_DRAINING, "queue_depth": 5,
                                 "slots_active": 2, "slots_total": 2,
                                 "tokens": 10}) == c.PRESSURE_REPLICA_DRAINING
    assert mon.classify_replica({"lifecycle": active, "queue_depth": 1, "slots_active": 2,
                                 "slots_total": 2}) == c.PRESSURE_REPLICA_HOT
    assert mon.classify_replica({"lifecycle": active}) == c.PRESSURE_REPLICA_IDLE
    assert mon.classify_replica({"lifecycle": active, "tokens": 3}) == c.PRESSURE_REPLICA_OK
    assert mon.classify_replica({"probe_error": "transient"}) == c.PRESSURE_REPLICA_UNREACHABLE
    rows = {"a": {"pressure": c.PRESSURE_REPLICA_OK, "slots_total": 4, "slots_active": 1,
                  "kv_blocks_total": 10, "kv_blocks_free": 2},
            "b": {"pressure": c.PRESSURE_REPLICA_DRAINING, "slots_total": 4},
            "c": {"pressure": c.PRESSURE_REPLICA_UNREACHABLE, "slots_total": 4}}
    head = mon.fleet_headroom(rows)
    assert head == {"headroom": 0.2, "slot_headroom": 0.75, "kv_headroom": 0.2,
                    "slots_free": 3, "slots_total": 4, "replicas_active": 1}


# -- windows, rings, journal, replay on stubs (test_fleet_monitor.py:313-413) ----------
def test_windowed_rates_and_tenant_pooling_equal_the_jax_packages(both):
    def run(side):
        rs = stub_fleet(side, n=2)
        e0, e1 = (h.engine for h in rs.handles)
        mon = side.monitor.FleetMonitor(rs, clock=lambda: 0.0)
        mon.sample(now=0.0)
        e0.steps_run += 10
        e0.macro_tokens_by_slot[0] += 40
        e0.tokens_by_tenant["a"] = 30
        e1.tokens_by_tenant["a"] = 10
        e1.macro_tokens_by_slot[0] = 10
        e0.admissions_by_tenant["a"] = 2
        e0.prefill_tokens += 16
        e0.spills += 3
        e0.ttft_s_by_tenant["a"] = [0.5]
        e1.ttft_s_by_tenant["a"] = [1.5]
        mon.sample(now=2.0)
        row = mon.replica_windows("replica-0")[-1]
        assert (row["dt_s"], row["tokens"], row["tok_s"]) == (2.0, 40, 20.0)
        assert (row["prefill_tokens"], row["prefill_tok_s"]) == (16, 8.0)
        assert (row["admissions"], row["admissions_s"], row["spills_s"]) == (2, 1.0, 1.5)
        trow = mon.tenant_windows("a")[-1]
        assert (trow["tokens"], trow["tok_s"], trow["share"]) == (40, 20.0, 1.0)
        assert trow["ttft_p95_s"] == 1.5  # pooled across replicas
        mon.sample(now=3.0)  # the next window consumes no sample twice
        assert mon.tenant_windows("a")[-1]["ttft_p95_s"] is None
        assert mon.tenant_windows("a")[-1]["tokens"] == 0
        return mon.journal_lines()

    fp.twin(both, run)


@SIDE
def test_rings_and_journal_bounded_under_10k_samples(both, which):
    side = both[which]
    mon = side.monitor.FleetMonitor(stub_fleet(side, n=1), max_windows=16, journal_windows=64)
    for i in range(10_000):
        mon.sample(now=float(i))
    assert mon.windows_sampled == 10_000
    assert len(mon.replica_windows("replica-0")) == 16
    lines = mon.journal_lines()
    assert len(lines) == 64
    assert all(json.loads(line)["event"] == side.constants.FLEET_EV_WINDOW for line in lines)
    assert json.loads(lines[-1])["window"] == 10_000


def test_recovery_freezes_journal_bounded(both):
    def run(side):
        rs = stub_fleet(side, n=1)
        eng = rs.handles[0].engine
        mon = side.monitor.FleetMonitor(rs, max_frozen=2)
        mon.sample(now=0.0)
        for k in range(4):
            eng.recoveries += 1
            mon.sample(now=1.0 + k)
        frozen = mon.frozen_journals()
        assert len(frozen) == 2
        assert frozen[-1]["event"] == side.constants.FLEET_EV_FREEZE
        assert frozen[-1]["replicas"] == ["replica-0"]
        return frozen

    fp.twin(both, run)


def test_stub_verdicts_and_replay_equal_live_and_the_jax_packages(both):
    """test_fleet_monitor.py:376: hot, ok and an SLO breach on stubs; replay
    re-derives the live verdicts from the journal alone; the port's
    verdicts, journal and replay equal the JAX package's."""
    def run(side):
        mon_mod, c = side.monitor, side.constants
        rs = stub_fleet(side, n=2)
        e0, e1 = (h.engine for h in rs.handles)
        targets = {"gold": mon_mod.SLOTarget(ttft_p95_s=1.0)}
        mon = mon_mod.FleetMonitor(rs, slo=mon_mod.SLOTracker(dict(targets), breach_k=2,
                                                              breach_n=3))
        live = [mon.sample(now=0.0)]
        assert live[0].replicas["replica-0"] == c.PRESSURE_REPLICA_IDLE
        for w in (1.0, 2.0, 3.0):
            e0.active_slots = e0.n_slots
            e0.waiting_by_tenant = {"gold": 2}
            e0.tokens_by_tenant["gold"] = e0.tokens_by_tenant.get("gold", 0) + 8
            e0.macro_tokens_by_slot[0] += 8
            e0.ttft_s_by_tenant.setdefault("gold", []).append(5.0)
            e1.active_slots = 1
            e1.tokens_by_tenant["bulk"] = e1.tokens_by_tenant.get("bulk", 0) + 4
            e1.macro_tokens_by_slot[0] += 4
            live.append(mon.sample(now=w))
        last = live[-1]
        assert last.replicas == {"replica-0": c.PRESSURE_REPLICA_HOT,
                                 "replica-1": c.PRESSURE_REPLICA_OK}
        assert last.slo_breached["gold"] is True and 0.0 <= last.headroom <= 1.0
        replayed = mon_mod.FleetMonitor.replay(
            mon.journal_lines(), slo=mon_mod.SLOTracker(dict(targets), breach_k=2, breach_n=3))
        assert verdicts(replayed) == verdicts(live)
        assert [r.to_dict() for r in replayed] == [r.to_dict() for r in live]
        snap = mon.pressure_snapshot()
        snap.pop("sample_wall_s")  # the monitor's own wall clock
        return verdicts(live), mon.journal_lines(), snap

    fp.twin(both, run)


def test_replay_of_a_pre_accounting_journal(both):
    def run(side):
        c = side.constants
        line = json.dumps({"v": 1, "event": c.FLEET_EV_WINDOW, "window": 3, "t": 1.0,
                           "replicas": {"replica-0": {
                               "lifecycle": c.REPLICA_STATE_ACTIVE, "dt_s": 1.0,
                               "tokens": 12, "queue_depth": 0, "slots_active": 1,
                               "slots_total": 2}},
                           "tenants": {}})
        (rep,) = side.monitor.FleetMonitor.replay([line])
        assert rep.replicas["replica-0"] == c.PRESSURE_REPLICA_OK
        assert rep.tok_s_per_chip_hour == pytest.approx(12 / (1.0 / 3600.0))
        assert rep.waste_fraction == pytest.approx(1.0)
        return rep.to_dict()

    fp.twin(both, run)


# -- gauge hygiene and unreachable replicas (test_fleet_monitor.py:470-582) ------------
def test_retired_replica_drops_gauges_and_rings(both):
    def run(side):
        registry = side.Metrics()
        rs = stub_fleet(side, n=2)
        mon = side.monitor.FleetMonitor(rs, metrics=registry)
        mon.sample(now=0.0)
        assert 'replica="replica-1"' in registry.render()
        rs.retire("replica-1")
        mon.sample(now=1.0)
        rendered = registry.render()
        assert 'replica="replica-1"' not in rendered and 'replica="replica-0"' in rendered
        assert mon.replica_windows("replica-1") == []
        assert "replica-1" not in mon.pressure_snapshot()["replicas"]
        assert mon.last_report.replicas_active == 1
        return rendered

    fp.twin(both, run)


def test_unreachable_replica_is_marked_not_swallowed(both):
    def run(side):
        c = side.constants
        registry = side.Metrics()
        rs = stub_fleet(side, n=2)
        engines = [h.engine for h in rs.handles]
        mon = side.monitor.FleetMonitor(rs, metrics=registry)
        mon.sample(now=1.0)
        engines[0].steps_run = 10
        engines[0].macro_tokens_by_slot = [40, 0]

        def dead_probe():
            raise ConnectionError("connection refused by host")

        engines[0].probe = dead_probe
        rep = mon.sample(now=2.0)
        assert rep.replicas["replica-0"] == c.PRESSURE_REPLICA_UNREACHABLE
        assert rep.replicas["replica-1"] != c.PRESSURE_REPLICA_UNREACHABLE
        assert registry.get("nos_tpu_fleet_replica_state", replica="replica-0",
                            state=c.PRESSURE_REPLICA_UNREACHABLE) == 1.0
        assert registry.get("nos_tpu_fleet_replica_state", replica="replica-1",
                            state=c.PRESSURE_REPLICA_UNREACHABLE) == 0.0
        assert rep.slots_total == 2 and rep.replicas_active == 1
        unreach = [json.loads(x) for x in mon.journal_lines()
                   if json.loads(x)["event"] == c.FLEET_EV_UNREACHABLE]
        assert [(u["replica"], u["kind"]) for u in unreach] == [("replica-0", "transient")]
        replayed = side.monitor.FleetMonitor.replay(mon.journal_lines())
        assert replayed[-1].replicas["replica-0"] == c.PRESSURE_REPLICA_UNREACHABLE
        del engines[0].probe
        rep3 = mon.sample(now=3.0)
        assert rep3.replicas["replica-0"] != c.PRESSURE_REPLICA_UNREACHABLE
        assert mon.replica_windows("replica-0")[-1]["tokens"] == 40
        return mon.journal_lines(), registry.render()

    fp.twin(both, run)


@SIDE
def test_monitor_background_thread_samples_and_stops(both, which):
    side = both[which]
    mon = side.monitor.FleetMonitor(stub_fleet(side, n=1), interval_s=0.01).start()
    try:
        deadline = time.monotonic() + 5.0
        while mon.windows_sampled < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        mon.stop()
    assert mon.windows_sampled >= 3 and mon._thread is None
    settled = mon.windows_sampled
    time.sleep(0.05)
    assert mon.windows_sampled == settled


def _get(port, path, token=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    conn.request("GET", path, headers={"Authorization": f"Bearer {token}"} if token else {})
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp, body


@SIDE
def test_debug_pressure_serves_json_with_auth(both, which):
    side = both[which]
    c, obs = side.constants, side.observability
    mon = side.monitor.FleetMonitor(stub_fleet(side, n=1))
    mon.sample(now=0.0)
    srv = obs.ObservabilityServer(side.Metrics(), obs.HealthManager(), metrics_token="s3cr3t",
                                  pressure=mon).start()
    try:
        assert _get(srv.port, c.DEBUG_PATH_PRESSURE)[0].status == 401
        resp, body = _get(srv.port, c.DEBUG_PATH_PRESSURE, token="s3cr3t")
        assert resp.status == 200 and resp.getheader("Content-Type") == "application/json"
        payload = json.loads(body)
        assert payload["windows_sampled"] == 1 and payload["journal_lines"] == 1
        assert payload["report"]["replicas"]["replica-0"] in c.PRESSURE_REPLICA_STATES
    finally:
        srv.stop()
    srv = obs.ObservabilityServer(side.Metrics(), obs.HealthManager()).start()
    try:
        assert _get(srv.port, c.DEBUG_PATH_PRESSURE)[0].status == 404
    finally:
        srv.stop()


# -- the real-engine substrate (test_fleet_monitor.py:588-881) --------------------------
PROMPTS = {"a": [4, 9, 2, 33, 7, 1, 8, 5], "b": [40, 41, 42, 43, 44, 45, 46, 47],
           "c": [9, 8, 7, 6, 5, 4, 3, 2]}


class Clock:
    """The monitor's clock: one second a call, the same on both sides."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def drive(engines, pred, mon=None, n=600):
    """One tick per engine a wave; a monitor samples at the 1-tick cadence."""
    for _ in range(n):
        for e in engines:
            e._tick()
        if mon is not None:
            mon.sample()
        if pred():
            return True
    return False


def journal(mon, latency_targets=False):
    """The journal with each latency sample's value and each replica's
    restore-latency sum replaced by its presence (wall clock), and with
    latency SLO targets the SLO flags too."""
    out = []
    for line in mon.journal_lines():
        rec = json.loads(line)
        for row in rec.get("replicas", {}).values():
            row["restore_s"] = row.get("restore_s", 0.0) > 0.0
        for trow in rec.get("tenants", {}).values():
            for k in ("ttft_p95_s", "queue_wait_p95_s"):
                trow[k] = trow[k] is not None
            if latency_targets:
                trow.pop("slo_window_breach", None)
                trow.pop("slo_breached", None)
        if latency_targets:
            rec["pressure"].pop("slo_breached", None)
        out.append(rec)
    return out


def live(reports):
    return [(r.window, r.replicas, r.tenants, r.headroom, r.slots_free) for r in reports]


@pytest.mark.parametrize("temperature", [0.0, 0.7], ids=["greedy", "temp"])
def test_monitor_purity_and_the_jax_packages_journal(both, temperature):
    """test_fleet_monitor.py:636: outputs and dispatch counters equal with the
    monitor sampling every tick and without it, on each side; the port's
    outputs, verdicts and journal equal the JAX package's."""
    def run(side, monitor_on):
        engines = [fp.engine(side, temperature=temperature) for _ in range(2)]
        rs = side.replica.ReplicaSet(engines)
        mon = None
        if monitor_on:
            mon = side.monitor.FleetMonitor(
                rs, metrics=side.Metrics(), clock=Clock(),
                slo={"a": side.monitor.SLOTarget(ttft_p95_s=0.5, min_tok_s=1.0)})
        futs = [engines[i % 2].submit(PROMPTS[k], max_new=6, tenant=k)
                for i, k in enumerate(sorted(PROMPTS))]
        reports = []
        for _ in range(600):
            for e in engines:
                e._tick()
            if mon is not None:
                reports.append(mon.sample())
            if all(f.done() for f in futs):
                break
        outs = [list(f.result(timeout=60)) for f in futs]
        counters = [(e.steps_run, e.macro_dispatches, e.prefill_dispatches,
                     e.burst_dispatches, e.h2d_uploads) for e in engines]
        rs.stop()
        if mon is None:
            return outs, counters
        assert mon.windows_sampled > 0 and mon.last_report is not None
        return outs, counters, live(reports), journal(mon, latency_targets=True)

    def scenario(side):
        outs_off, counters_off = run(side, False)
        on = run(side, True)
        assert on[:2] == (outs_off, counters_off)
        return on[0], on[2], on[3]

    fp.twin(both, scenario)


def test_idle_to_hot_within_one_window(both):
    """test_fleet_monitor.py:687: saturating replica-0 of three flips it
    idle -> hot one sampling window after the burst."""
    def run(side):
        c = side.constants
        engines = [fp.engine(side) for _ in range(3)]
        rs = side.replica.ReplicaSet(engines)
        mon = side.monitor.FleetMonitor(rs, clock=Clock())
        try:
            baseline = mon.sample()
            assert set(baseline.replicas.values()) == {c.PRESSURE_REPLICA_IDLE}
            futs = [engines[0].submit(PROMPTS["a"], max_new=6)
                    for _ in range(engines[0].n_slots + 2)]
            for e in engines:
                e._tick()
            detected = mon.sample()
            assert detected.window == baseline.window + 1
            assert detected.replicas["replica-0"] == c.PRESSURE_REPLICA_HOT
            assert detected.replicas["replica-1"] == c.PRESSURE_REPLICA_IDLE
            assert detected.headroom < baseline.headroom
            assert drive(engines, lambda: all(f.done() for f in futs))
            outs = [list(f.result(timeout=60)) for f in futs]
            cooled = mon.sample()
            assert cooled.replicas["replica-0"] != c.PRESSURE_REPLICA_HOT
            return outs, live([baseline, detected, cooled]), journal(mon)
        finally:
            rs.stop()

    fp.twin(both, run)


def test_within_to_starved_agrees_with_quota_accounting(both):
    """test_fleet_monitor.py:726: a guaranteed tenant's blocked arrival flips
    it within -> starved within one window, as the engine's QuotaPolicy
    says; the port's verdicts and journal equal the JAX package's."""
    def run(side):
        c, q = side.constants, side.quota
        shares = {"gold": q.TenantShare(0.5, 1.0), "bulk": q.TenantShare(0.0, 1.0)}
        engines = [fp.engine(side, quota=q.QuotaPolicy(dict(shares), window_ticks=64))
                   for _ in range(3)]
        rs = side.replica.ReplicaSet(engines)
        mon = side.monitor.FleetMonitor(rs, clock=Clock())
        try:
            mon.sample()
            bulk = [engines[0].submit(PROMPTS["b"], max_new=12, tenant="bulk")
                    for _ in range(4)]
            for _ in range(6):
                for e in engines:
                    e._tick()
            before = mon.sample()
            assert before.tenants["gold"] == c.PRESSURE_TENANT_WITHIN
            assert before.tenants["bulk"] == c.PRESSURE_TENANT_BORROWING
            gold = [engines[0].submit(PROMPTS["a"], max_new=12, tenant="gold")
                    for _ in range(3)]
            for e in engines:
                e._tick()
            detected = mon.sample()
            assert detected.window == before.window + 1
            assert detected.tenants["gold"] == c.PRESSURE_TENANT_STARVED
            assert engines[0]._quota.is_starved("gold") is True
            assert drive(engines, lambda: all(f.done() for f in bulk + gold))
            outs = [list(f.result(timeout=60)) for f in bulk + gold]
            settled = mon.sample()
            assert settled.tenants["gold"] != c.PRESSURE_TENANT_STARVED
            return outs, live([before, detected, settled]), journal(mon)
        finally:
            rs.stop()

    fp.twin(both, run)


def test_real_engine_probe_extensions(both):
    """test_fleet_monitor.py:781: capacity totals in probe(), per-tenant rows
    in tenant_probe() agreeing with the engine's own counters."""
    def run(side):
        c = side.constants
        server = fp.engine(side)
        try:
            probe = server.probe()
            assert probe[c.PROBE_KEY_SLOTS_TOTAL] == 2 and probe[c.PROBE_KEY_KV_BLOCKS_TOTAL] > 0
            futs = [server.submit(PROMPTS["a"], max_new=6, tenant="a"),
                    server.submit(PROMPTS["b"], max_new=6, tenant="b")]
            assert drive([server], lambda: all(f.done() for f in futs))
            for f in futs:
                f.result(timeout=60)
            rows = server.tenant_probe()
            assert rows["a"][c.TENANT_KEY_ADMISSIONS] == rows["b"][c.TENANT_KEY_ADMISSIONS] == 1
            assert rows["a"][c.TENANT_KEY_WAITING] == 0 and rows["a"][c.TENANT_KEY_TOKENS] > 0
            assert sum(r[c.TENANT_KEY_TOKENS] for r in rows.values()) == (
                sum(server.macro_tokens_by_slot) + server.spec_tokens_accepted)
            assert c.TENANT_KEY_USAGE not in rows["a"]
            assert len(server.queue_wait_s_by_tenant["a"]) == 1
            return probe, rows
        finally:
            server.stop()

    fp.twin(both, run)


def test_drain_retire_cycle_drops_gauges(both):
    """test_fleet_monitor.py:818: a drain -> retire cycle leaves no stale
    per-replica gauge on /metrics and no ring in the monitor."""
    def run(side):
        c = side.constants
        engines = [fp.engine(side) for _ in range(2)]
        rs = side.replica.ReplicaSet(engines)
        router = side.router.PrefixRouter(rs)
        registry = side.Metrics()
        mon = side.monitor.FleetMonitor(rs, metrics=registry, clock=Clock())
        try:
            fut = router.submit(PROMPTS["a"], max_new=8, tenant="a")
            for _ in range(3):
                for h in rs.handles:
                    if h.state == c.REPLICA_STATE_ACTIVE:
                        h.engine._tick()
                mon.sample()
            assert 'replica="replica-0"' in registry.render()
            fp.settle(rs)
            side.drain.drain_replica(rs, router, "replica-0")
            assert drive([rs.handles[1].engine], fut.done, mon=mon)
            out = list(fut.result(timeout=60))
            mon.sample()
            rendered = registry.render()
            assert 'replica="replica-0"' not in rendered and 'replica="replica-1"' in rendered
            assert mon.replica_windows("replica-0") == []
            return out, journal(mon)
        finally:
            rs.stop()

    fp.twin(both, run)
