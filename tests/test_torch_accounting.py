"""The cost ledger in the port (nos_tpu_torch/serving/accounting.py
`CostLedger`; the DecodeServer's charge sites: `_admit_scan`,
`_dispatch_prefill_wave`, the macro, burst and verify token folds,
`_pump_revives`, `_preempt_slot`, `_note_cost_tick`, `_release_slot`)
against the JAX package, on the CPU, mirroring the reference's
tests/test_accounting.py: the ledger units (:36-83), the counter-gated
purity oracle (:498), receipts and conservation (:534), cached prefill
charges (:570) and conservation under preemption (:590), plus the
`kv_block_ticks_int8` field of an int8 pool; then the fleet half
(`duty_cycle`, `fleet_utilization`, `utilization_block`, :99-224) on
hand-computed rows through both packages, the monitor's journaled duty
and cost gauges (:226-339), and conservation across a phase handoff.

Both engines serve the shared float32 test model (the JAX init carried
across with `from_numpy_params`), each with its own ledger, driven tick
by tick on the same traffic: every tenant total equals the JAX ledger's
except the two wall-clock fields (slot-seconds and the chip-ms derived
from them), which are held by the conservation law instead. The debug endpoints'
cases are in tests/test_torch_observability.py."""

import dataclasses

import jax
import numpy as np
import pytest

import test_torch_fleet_parity as fp
from nos_tpu import tracing as jtracing
from nos_tpu.runtime.decode_server import DecodeServer as JaxServer
from nos_tpu.serving import CostLedger as JaxLedger
from nos_tpu.serving import accounting as jacct
from nos_tpu_torch import DecodeServer, GPTConfig, constants, from_numpy_params
from nos_tpu_torch.serving import CostLedger, duty_cycle, fleet_utilization, utilization_block
from nos_tpu_torch.tracing import EngineTracing
from test_torch_fleet_monitor import stub_fleet

from conftest import serving_test_config, serving_test_params

_time_limit = fp.time_limit(240)

ENGINE = dict(n_slots=2, max_len=64, prompt_buckets=(8, 16), block_size=8, seed=11)
PROMPTS = [
    [4, 9, 2, 33, 7, 1, 8, 5],
    [40, 41, 42, 43, 44, 45, 46, 47],
    [9, 8, 7, 6, 5, 4, 3, 2],
]
# The fields no wall clock moves.
EXACT = tuple(f for f in constants.COST_FIELDS
              if f not in (constants.COST_SLOT_SECONDS, constants.COST_CHIP_MS))


@pytest.fixture(scope="module")
def model():
    jcfg, jparams = serving_test_config(), serving_test_params()
    tcfg = GPTConfig(**dataclasses.asdict(jcfg))
    tparams = from_numpy_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def pair(model, ledger=True, **kw):
    """The JAX engine and the port's, each with its own tracer and ledger."""
    jcfg, jparams, tcfg, tparams = model
    args = dict(ENGINE, **kw)
    jsrv = JaxServer(jparams, jcfg, tracing=jtracing.EngineTracing() if ledger else None,
                     cost_ledger=JaxLedger() if ledger else None, **args)
    tsrv = DecodeServer(tparams, tcfg, tracing=EngineTracing() if ledger else None,
                        cost_ledger=CostLedger() if ledger else None, device="cpu", **args)
    return jsrv, tsrv


def drive(server, pred, n=800):
    for _ in range(n):
        server._tick()
        if pred():
            return True
    return False


def serve(server, reqs):
    futs = [server.submit(p, max_new=m, tenant=t) for p, m, t in reqs]
    assert drive(server, lambda: all(f.done() for f in futs))
    return [list(f.result(5)) for f in futs]


def exact_totals(ledger):
    return {t: {f: acct[f] for f in EXACT} for t, acct in ledger.tenant_totals().items()}


def same_ledger(jsrv, tsrv):
    """The port's tenant totals and receipts equal the JAX ledger's, wall
    clock fields aside; both conserve slot-seconds."""
    assert exact_totals(tsrv._cost) == exact_totals(jsrv._cost)
    assert (tsrv.cost_receipts, tsrv.kv_block_ticks) == (jsrv.cost_receipts, jsrv.kv_block_ticks)
    jrec, trec = jsrv._cost.snapshot()["receipts"], tsrv._cost.snapshot()["receipts"]
    keys = EXACT + ("key", "tenant", "status", "tokens")
    assert [{k: r.get(k) for k in keys} for r in trec] == [{k: r.get(k) for k in keys}
                                                          for r in jrec]
    for srv in (jsrv, tsrv):
        assert srv._cost.charged_slot_seconds() == pytest.approx(
            srv.slot_seconds_total, rel=1e-9, abs=1e-9)
    assert tsrv.slot_seconds_total > 0.0


# -- the ledger units (test_accounting.py:36-83) ------------------------------------------------
def test_ledger_charge_totals_and_receipt_lifecycle():
    led = CostLedger()
    led.open_request("tr-1", "gold")
    led.charge("tr-1", "gold", decode_tokens=5, slot_seconds=1.5, chip_ms=750.0)
    led.charge("tr-1", "gold", decode_tokens=3)
    totals = led.tenant_totals()
    assert totals["gold"][constants.COST_DECODE_TOKENS] == 8
    assert totals["gold"][constants.COST_SLOT_SECONDS] == 1.5
    live = led.receipt("tr-1")
    assert live[constants.COST_DECODE_TOKENS] == 8 and "status" not in live
    rec = led.close_request("tr-1", "gold", tokens=9)
    assert rec["status"] == constants.RECEIPT_STATUS_OK and rec["tokens"] == 9
    assert rec[constants.COST_DECODE_TOKENS] == 8 and led.receipts_issued == 1
    assert led.close_request("tr-1", "gold") is None


def test_ledger_rejects_unknown_charge_field():
    with pytest.raises(ValueError, match="unknown cost field"):
        CostLedger().charge("tr-1", "gold", widgets=3)


def test_ledger_none_key_charges_tenant_totals_only():
    led = CostLedger()
    led.open_request(None, "a")
    led.charge(None, "a", decode_tokens=4)
    assert led.tenant_totals()["a"][constants.COST_DECODE_TOKENS] == 4
    assert led.snapshot()["open_requests"] == 0
    assert led.close_request(None, "a") is None


def test_ledger_charge_after_close_folds_into_closed_receipt():
    led = CostLedger()
    led.open_request("tr-1", "a")
    led.close_request("tr-1", "a")
    led.charge("tr-1", "a", slot_seconds=0.25)
    assert led.receipt("tr-1")[constants.COST_SLOT_SECONDS] == 0.25
    assert led.charged_slot_seconds() == 0.25


def test_ledger_receipts_bounded_with_drop_count():
    led = CostLedger(max_receipts=4)
    for i in range(10):
        led.open_request(f"tr-{i}", "a")
        led.close_request(f"tr-{i}", "a")
    snap = led.snapshot()
    assert (snap["receipts_issued"], snap["dropped_receipts"], len(snap["receipts"])) == (10, 6, 4)
    assert led.receipt("tr-0") is None and led.receipt("tr-9") is not None


def test_ledger_snapshots_equal_the_jax_ledgers_on_one_charge_sequence():
    ledgers = (CostLedger(max_receipts=3), JaxLedger(max_receipts=3))
    for led in ledgers:
        for i in range(5):
            led.open_request(f"tr-{i}", "ab"[i % 2])
            led.charge(f"tr-{i}", "ab"[i % 2], decode_tokens=i, kv_block_ticks=2 * i,
                       spill_bytes=100, prefill_tokens_cached=8)
            led.charge(None, "c", replay_tokens=i)
            if i != 2:
                led.close_request(f"tr-{i}", "ab"[i % 2], tokens=i + 1)
    snaps = [led.snapshot() for led in ledgers]
    for snap in snaps:
        for rec in snap["receipts"]:
            rec.pop("dur_s")
    assert snaps[0] == snaps[1]


# -- engines (test_accounting.py:498, :534, :570, :590) ------------------------------------------
@pytest.mark.parametrize("temperature", [0.0, 0.7], ids=["greedy", "temp"])
def test_accounting_purity_counter_gated_oracle(model, temperature):
    """Ledger on against off: the same tokens and dispatch counters."""
    runs = []
    for on in (False, True):
        _, tsrv = pair(model, ledger=on, temperature=temperature)
        outs = serve(tsrv, [(p, 8, t) for t, p in zip("abc", PROMPTS)])
        runs.append((outs, tuple(getattr(tsrv, c) for c in (
            "steps_run", "macro_dispatches", "prefill_dispatches", "burst_dispatches",
            "h2d_uploads", "blocking_syncs"))))
    assert runs[1] == runs[0]


def test_receipts_and_conservation_solo(model):
    jsrv, tsrv = pair(model)
    reqs = [(p, 6, t) for t, p in zip("ab", PROMPTS[:2])]
    outs = serve(tsrv, reqs)
    assert serve(jsrv, reqs) == outs
    same_ledger(jsrv, tsrv)
    assert tsrv.cost_receipts == 2 and tsrv.kv_block_ticks > 0
    for rec, out in zip(tsrv._cost.snapshot()["receipts"], outs):
        assert rec["status"] == constants.RECEIPT_STATUS_OK and rec["tokens"] == len(out)
        assert rec[constants.COST_PREFILL_CHARGED] == 8
        assert rec[constants.COST_PREFILL_CACHED] == 0
        assert rec[constants.COST_KV_BLOCK_TICKS] > 0 and rec[constants.COST_CHIP_MS] > 0
        assert rec[constants.COST_DECODE_TOKENS] == len(out) - 1
    totals = tsrv._cost.tenant_totals()
    assert sum(a[constants.COST_DECODE_TOKENS] for a in totals.values()) == (
        sum(tsrv.macro_tokens_by_slot) + tsrv.spec_tokens_accepted)


def test_shared_prefix_hit_charges_cached_tokens(model):
    shared = [7, 7, 7, 7, 7, 7, 7, 7, 3, 3, 3, 3, 3, 3, 3, 3]
    jsrv, tsrv = pair(model)
    for srv in (jsrv, tsrv):
        serve(srv, [(shared + [1, 2, 3, 4], 4, "a")])
        serve(srv, [(shared + [5, 6, 7, 8], 4, "b")])
    same_ledger(jsrv, tsrv)
    recs = tsrv._cost.snapshot()["receipts"]
    assert recs[1][constants.COST_PREFILL_CACHED] >= 8
    assert recs[1][constants.COST_PREFILL_CHARGED] < recs[0][constants.COST_PREFILL_CHARGED]


def test_conservation_and_receipt_continuity_under_preemption(model):
    """A preempted slot charges its partial hold at release, the restore
    re-opens the same receipt, the replay and the spill bytes are billed,
    and charged slot-seconds still equal the engine's."""
    jsrv, tsrv = pair(model, burst_windows=1)
    outs = []
    for srv in (jsrv, tsrv):
        fut = srv.submit(PROMPTS[0], max_new=10, tenant="a")
        for _ in range(6):
            srv._tick()
        assert not fut.done()
        srv._preempt_slot(0)
        assert srv.preemptions == 1
        assert drive(srv, fut.done)
        outs.append(list(fut.result(5)))
    assert outs[1] == outs[0] and len(outs[0]) == 10
    same_ledger(jsrv, tsrv)
    rec = tsrv._cost.snapshot()["receipts"][0]
    assert tsrv.cost_receipts == 1 and rec["status"] == constants.RECEIPT_STATUS_OK
    assert rec[constants.COST_REPLAY_TOKENS] > 0
    assert rec[constants.COST_SPILL_BYTES] > 0
    # The preemption's copy-out and the replay's copy-in: whole payloads.
    assert rec[constants.COST_SPILL_BYTES] % tsrv._bytes_per_block == 0


def test_int8_pool_bills_its_own_block_ticks(model):
    """An int8 pool's residency bills `kv_block_ticks_int8`, never the
    native field, as the JAX int8 engine's does."""
    jsrv, tsrv = pair(model, kv_dtype="int8")
    reqs = [(p, 8, t) for t, p in zip("ab", PROMPTS[:2])]
    assert serve(tsrv, reqs) == serve(jsrv, reqs)
    same_ledger(jsrv, tsrv)
    totals = tsrv._cost.tenant_totals()
    assert all(a[constants.COST_KV_BLOCK_TICKS] == 0 for a in totals.values())
    assert sum(a[constants.COST_KV_BLOCK_TICKS_INT8] for a in totals.values()) == (
        tsrv.kv_block_ticks) > 0


@pytest.mark.parametrize("bw", [1, 4])
def test_burst_ticks_bill_every_fused_window(model, bw):
    """A burst tick bills `blocks x windows` (the fused windows, the JAX
    engine's weight), per-tick dispatch `blocks x 1`."""
    reqs = [(p, 24, t) for t, p in zip("ab", PROMPTS[:2])]
    jsrv, tsrv = pair(model, burst_windows=bw, steps_per_dispatch=2)
    assert serve(tsrv, reqs) == serve(jsrv, reqs)
    same_ledger(jsrv, tsrv)
    assert (tsrv.burst_dispatches > 0) == (bw > 1)


# -- the fleet half (test_accounting.py:99-224) -------------------------------------------------
def identity_residual(duty):
    return abs(duty[constants.ACCT_KEY_BUSY_CHIP_S] + duty[constants.ACCT_KEY_OVERHEAD_CHIP_S]
               + duty[constants.ACCT_KEY_WASTE_CHIP_S] - duty[constants.ACCT_KEY_WALL_CHIP_S])


K = constants
ACTIVE = {"lifecycle": K.REPLICA_STATE_ACTIVE}
DUTY_ROWS = {
    # 10 s x 2 chips: busy 6, host 3 of which idle 1, revive 0.5, restore
    # 0.25, and 1 s of unmeasured slack.
    "exact": ({"dt_s": 10.0, K.PROBE_KEY_TP_DEVICES: 2, K.ACCT_KEY_DISPATCH_S: 6.0,
               K.ACCT_KEY_HOST_S: 3.0, K.ACCT_KEY_IDLE_S: 1.0, K.ACCT_KEY_REVIVE_S: 0.5,
               K.ACCT_KEY_RESTORE_S: 0.25, **ACTIVE},
              (20.0, 12.0, 2.5, {K.WASTE_IDLE: 4.0, K.WASTE_SPILL_REVIVE: 1.0,
                                 K.WASTE_RECOVERY: 0.5})),
    "unreachable": ({"dt_s": 4.0, K.PROBE_KEY_TP_DEVICES: 2, "probe_error": "transient",
                     K.ACCT_KEY_DISPATCH_S: 3.0},
                    (8.0, 0.0, 0.0, {K.WASTE_UNREACHABLE: 8.0})),
    "draining": ({"dt_s": 5.0, K.ACCT_KEY_DISPATCH_S: 1.0, K.ACCT_KEY_HOST_S: 1.0,
                  K.ACCT_KEY_IDLE_S: 0.5, "lifecycle": K.REPLICA_STATE_DRAINING},
                 (5.0, 1.0, 0.5, {K.WASTE_DRAINING: 3.5})),
    "old_journal": ({"dt_s": 2.0}, (2.0, 0.0, 0.0, {K.WASTE_IDLE: 2.0})),
    "empty": ({}, (0.0, 0.0, 0.0, {})),
}


@pytest.mark.parametrize("case", sorted(DUTY_ROWS))
def test_duty_cycle_partitions_exactly_and_equals_the_jax_packages(case):
    """Hand-computed decompositions (test_accounting.py:108-171): busy,
    overhead and each named waste in chip-seconds, busy + overhead + waste
    == wall, and the port's dict equal to the JAX package's."""
    row, (wall, busy, overhead, waste) = DUTY_ROWS[case]
    duty = duty_cycle(row)
    assert duty == jacct.duty_cycle(row)
    assert duty[K.ACCT_KEY_WALL_CHIP_S] == pytest.approx(wall)
    assert duty[K.ACCT_KEY_BUSY_CHIP_S] == pytest.approx(busy)
    assert duty[K.ACCT_KEY_OVERHEAD_CHIP_S] == pytest.approx(overhead)
    want = {cause: waste.get(cause, 0.0) for cause in K.WASTE_CAUSES}
    assert duty[K.ACCT_KEY_WASTE] == pytest.approx(want)
    assert identity_residual(duty) < 1e-12


def test_fleet_utilization_and_utilization_block_hand_computed():
    """test_accounting.py:173-224: 1000 tokens over 20 chip-seconds, 6 s of
    slack idle; the bench block over cumulative reports, an unprofiled
    engine contributing nothing; both dicts equal the JAX package's."""
    from nos_tpu.telemetry import ServingReport as JaxReport
    from nos_tpu_torch.telemetry import ServingReport

    rows = {"r0": {"dt_s": 10.0, K.ACCT_KEY_DISPATCH_S: 8.0, K.ACCT_KEY_HOST_S: 2.0,
                   "tokens": 800},
            "r1": {"dt_s": 10.0, K.ACCT_KEY_DISPATCH_S: 2.0, K.ACCT_KEY_HOST_S: 2.0,
                   "tokens": 200}}
    util = fleet_utilization(rows)
    assert util == jacct.fleet_utilization(rows)
    assert util[K.ACCT_KEY_CHIP_SECONDS] == 20.0 and util["tokens"] == 1000
    assert util[K.ACCT_KEY_TOK_S_PER_CHIP_HOUR] == pytest.approx(1000 / (20.0 / 3600.0))
    assert util[K.ACCT_KEY_WASTE_FRACTION] == pytest.approx(0.3)
    assert fleet_utilization(rows, tokens=7)["tokens"] == 7
    fields = dict(tick_wall_s=4.0, tick_dispatch_s=3.0, tick_host_overhead_s=1.0,
                  tick_phase_s={K.TICK_PHASE_IDLE: 0.5}, tp_devices=2,
                  macro_tokens_by_slot={"0": 90}, spec_tokens_accepted=10)
    block = utilization_block([ServingReport(**fields), ServingReport()])
    assert block == jacct.utilization_block([JaxReport(**fields), JaxReport()])
    assert block[K.ACCT_KEY_CHIP_SECONDS] == 8.0 and block["tokens"] == 100
    assert block[K.ACCT_KEY_BUSY_CHIP_S] == 6.0
    assert abs(block["identity_residual_s"]) < 1e-12
    assert block[K.ACCT_KEY_TOK_S_PER_CHIP_HOUR] > 0


# -- the monitor's accounting (test_accounting.py:226-339) --------------------------------------
@pytest.fixture(scope="module")
def both():
    return fp.sides()


def test_monitor_windows_carry_duty_and_replay_reproduces_it(both):
    def run(side):
        rs = stub_fleet(side, n=1)
        eng = rs.handles[0].engine
        eng.tick_wall_s = eng.tick_dispatch_s = eng.tick_host_overhead_s = 0.0
        eng.tp = 2
        mon = side.monitor.FleetMonitor(rs)
        live = [mon.sample(now=0.0)]
        eng.tick_wall_s, eng.tick_dispatch_s, eng.tick_host_overhead_s = 1.6, 1.2, 0.4
        eng.macro_tokens_by_slot[0] = 64
        eng.tokens_by_tenant["a"] = 64
        live.append(mon.sample(now=2.0))
        duty = mon.replica_windows("replica-0")[-1][K.ACCT_KEY_DUTY]
        assert duty[K.ACCT_KEY_WALL_CHIP_S] == pytest.approx(4.0)
        assert duty[K.ACCT_KEY_BUSY_CHIP_S] == pytest.approx(2.4)
        assert duty[K.ACCT_KEY_OVERHEAD_CHIP_S] == pytest.approx(0.8)
        assert identity_residual(duty) < 1e-9
        assert live[-1].tok_s_per_chip_hour == pytest.approx(64 / (4.0 / 3600.0))
        assert 0.0 < live[-1].waste_fraction < 1.0
        replayed = side.monitor.FleetMonitor.replay(mon.journal_lines())
        got = [(r.tok_s_per_chip_hour, r.waste_fraction) for r in replayed]
        assert got == [(r.tok_s_per_chip_hour, r.waste_fraction) for r in live]
        return mon.journal_lines()

    fp.twin(both, run)


def test_unreachable_window_wall_lands_in_unreachable_waste(both):
    def run(side):
        rs = stub_fleet(side, n=1)
        eng = rs.handles[0].engine
        mon = side.monitor.FleetMonitor(rs)
        mon.sample(now=1.0)

        def dead_probe():
            raise ConnectionError("connection refused by host")

        eng.probe = dead_probe
        mon.sample(now=3.0)
        row = mon.replica_windows("replica-0")[-1]
        duty = row[K.ACCT_KEY_DUTY]
        assert row["probe_error"] and duty[K.ACCT_KEY_WALL_CHIP_S] == pytest.approx(2.0)
        assert duty[K.ACCT_KEY_WASTE][K.WASTE_UNREACHABLE] == pytest.approx(2.0)
        assert side.monitor.FleetMonitor.replay(mon.journal_lines())[-1].waste_fraction == 1.0
        return mon.journal_lines()

    fp.twin(both, run)


def test_tenant_cost_gauges_and_the_idle_tenant_sweep(both):
    """test_accounting.py:283-339: the ledger's nos_tpu_tenant_cost_* gauges
    published per active tenant; a tenant idle past the horizon loses every
    series and its ring, and comes back with the new work only."""
    def run(side):
        registry = side.Metrics()
        rs = stub_fleet(side, n=1)
        eng = rs.handles[0].engine
        led = side.CostLedger()
        led.charge(None, "a", slot_seconds=2.5, decode_tokens=10)
        mon = side.monitor.FleetMonitor(rs, metrics=registry, ledger=led,
                                        tenant_idle_windows=2)
        mon.sample(now=0.0)
        eng.tokens_by_tenant["a"] = 10
        eng.macro_tokens_by_slot[0] = 10
        mon.sample(now=1.0)
        assert registry.get("nos_tpu_tenant_cost_slot_seconds", tenant="a") == 2.5
        assert registry.get("nos_tpu_tenant_cost_decode_tokens", tenant="a") == 10.0
        seeded = registry.render()
        assert 'nos_tpu_fleet_tenant_tok_s{tenant="a"}' in seeded
        for w in range(4):
            mon.sample(now=2.0 + w)
        assert 'tenant="a"' not in registry.render()
        assert mon.tenant_windows("a") == []
        eng.tokens_by_tenant["a"] = 16
        eng.macro_tokens_by_slot[0] = 16
        mon.sample(now=10.0)
        assert 'nos_tpu_fleet_tenant_tok_s{tenant="a"}' in registry.render()
        assert mon.tenant_windows("a")[-1]["tokens"] == 6
        return seeded, registry.render(), mon.journal_lines()

    fp.twin(both, run)


# -- conservation across a phase handoff ----------------------------------------------------------
def test_conservation_and_one_receipt_per_stream_across_a_handoff(both):
    """A prefill replica and a decode replica sharing one ledger and one
    tracer: each stream's receipt opens on the prefill replica, follows
    the checkpoint and closes once on the decode replica; charged
    slot-seconds equal the two engines' summed busy slot-seconds; the
    exact fields equal the JAX ledger's."""
    def run(side):
        c = side.constants
        led, tracer = side.CostLedger(), side.Tracer()
        store = side.kv_store.FleetKVStore(capacity_bytes=1 << 22)
        engines = [fp.engine(side, store=store, cost_ledger=led,
                             tracing=side.EngineTracing(tracer=tracer)) for _ in range(2)]
        rs = side.replica.ReplicaSet(engines, roles=[c.REPLICA_ROLE_PREFILL,
                                                     c.REPLICA_ROLE_DECODE])
        router = side.router.PrefixRouter(rs, kv_store=store, tracer=tracer)
        coord = side.disagg.HandoffCoordinator(rs, router)
        futs = [coord.submit(p + p, max_new=6, tenant=t) for t, p in zip("ab", PROMPTS[:2])]
        assert fp.drive_fleet(side, rs, lambda: all(f.done() for f in futs))
        outs = [list(f.result(5)) for f in futs]
        for _ in range(4):
            for e in engines:
                e._tick()
        busy = sum(e.slot_seconds_total for e in engines)
        assert led.charged_slot_seconds() == pytest.approx(busy, rel=1e-9, abs=1e-9)
        assert busy > 0.0 and engines[0].handoff_exports == 2
        snap = led.snapshot()
        assert snap["receipts_issued"] == 2 and snap["open_requests"] == 0
        assert sum(e.cost_receipts for e in engines) == 2 and engines[0].cost_receipts == 0
        keys = EXACT + ("tenant", "status", "tokens")
        receipts = [{k: r.get(k) for k in keys} for r in snap["receipts"]]
        coord.detach()
        rs.stop()
        return outs, exact_totals(led), receipts

    fp.twin(both, run)
