"""Tracing, metrics and the serving report in the port (nos_tpu_torch/
tracing.py, observability.py, telemetry.py; the DecodeServer's trace,
flight-recorder, profiler and metric hooks) against the JAX package, on
the CPU, mirroring the reference's tests/test_tracing.py: the unit classes
(:72-200), the pure-observer oracle (:204), lifecycle spans (:247), one
trace across a device-lost restore and across a preemption (:302), a
postmortem per fault kind (:414), the attribution gate (:454), the
ServingReport split (:478) and the untraced engine's zeros (:513).

The engines serve the shared float32 test model (the JAX init carried
across with `from_numpy_params`) and are driven tick by tick on the same
traffic; the port's trace events (names and attrs), flight-recorder
events, `collect_serving` counter fields and metric counters must equal
the JAX engine's. Times are the only thing left out of the comparisons.
The reference's debug endpoints (:524-) are held in
tests/test_torch_observability.py; its drain-migration trace (:348) is
not mirrored here."""

import dataclasses

import jax
import numpy as np
import pytest

from nos_tpu import constants as jconstants
from nos_tpu import telemetry as jtelemetry
from nos_tpu import tracing as jtracing
from nos_tpu.observability import Metrics as JaxMetrics
from nos_tpu.runtime import faults as jfaults
from nos_tpu.runtime import quota as jquota
from nos_tpu.runtime.decode_server import DecodeServer as JaxServer
from nos_tpu_torch import DecodeServer, GPTConfig, constants, from_numpy_params
from nos_tpu_torch import telemetry
from nos_tpu_torch.observability import METRIC_SERIES, Metrics
from nos_tpu_torch.runtime import faults as tfaults
from nos_tpu_torch.runtime import quota as tquota
from nos_tpu_torch.telemetry import ServingReport, collect_serving
from nos_tpu_torch.tracing import EngineTracing, FlightRecorder, TickProfiler, Tracer

from conftest import serving_test_config, serving_test_params

ENGINE = dict(n_slots=2, max_len=64, prompt_buckets=(8, 16), block_size=8,
              steps_per_dispatch=4, seed=11)


@pytest.fixture(scope="module")
def model():
    jcfg, jparams = serving_test_config(), serving_test_params()
    tcfg = GPTConfig(**dataclasses.asdict(jcfg))
    tparams = from_numpy_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def pair(model, traced=True, quota=None, injector=None, **kw):
    """The JAX engine and the port's on the same arguments, each with its
    own tracing bundle (and QuotaPolicy and FaultInjector from `quota`
    shares and an injector schedule)."""
    jcfg, jparams, tcfg, tparams = model
    args = dict(ENGINE, **kw)
    sides = []
    for Server, trc, qm, fm, params, cfg, extra in (
            (JaxServer, jtracing, jquota, jfaults, jparams, jcfg, {}),
            (DecodeServer, None, tquota, tfaults, tparams, tcfg, {"device": "cpu"})):
        bundle = None
        if traced:
            bundle = jtracing.EngineTracing() if trc is not None else EngineTracing()
        policy = None
        if quota is not None:
            policy = qm.QuotaPolicy({t: qm.TenantShare(*a) for t, a in quota.items()},
                                    window_ticks=32)
        inj = fm.FaultInjector([fm.FaultSpec(*s) for s in injector]) if injector else None
        sides.append(Server(params, cfg, tracing=bundle, quota=policy, fault_injector=inj,
                            **args, **extra))
    return sides


def drive(server, reqs, n=2000):
    """Submit, tick by hand (each fault through `_recover`, as `_run`
    does); outcomes in submit order: tokens, or the exception."""
    futs = [server.submit(p, max_new=m, **({"tenant": t} if t else {})) for p, m, t in reqs]
    for _ in range(n):
        if all(f.done() for f in futs):
            break
        try:
            server._tick()
        except Exception as exc:  # noqa: BLE001 — the _run contract
            server._recover(exc)
    out = []
    for f in futs:
        try:
            out.append(f.result(timeout=5))
        except Exception as exc:  # noqa: BLE001 — a poisoned request
            out.append(type(exc).__name__)
    return out


def events(server):
    """Every trace's events without their times: {id: [(name, attrs)]}."""
    tr = server.tracing.tracer
    return {tid: [(e["name"], e["attrs"]) for e in tr.trace(tid)] for tid in tr.trace_ids()}


def flight(recorder_events):
    return [{k: v for k, v in e.items() if k != "t"} for e in recorder_events]


def same_observations(jsrv, tsrv):
    assert events(tsrv) == events(jsrv)
    assert flight(tsrv.tracing.recorder.snapshot()) == flight(jsrv.tracing.recorder.snapshot())
    dumps = [(d["reason"], flight(d["events"])) for d in jsrv.tracing.recorder.postmortem_dumps()]
    assert [(d["reason"], flight(d["events"]))
            for d in tsrv.tracing.recorder.postmortem_dumps()] == dumps
    assert tsrv.tracing.profiler.ticks == jsrv.tracing.profiler.ticks


PROMPTS = [[5, 11, 3, 42], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10], [5, 11, 3, 42], [9, 8, 7]]


# -- the unit classes (test_tracing.py:72-200) -------------------------------------------------
class TestTracer:
    def test_ids_are_deterministic_and_events_ordered(self):
        tr = Tracer()
        a, b = tr.new_trace(), tr.new_trace()
        assert a != b and a.startswith(constants.TRACE_ID_PREFIX)
        assert (a, b) == (jtracing.Tracer().new_trace(), "tr-00000002")
        tr.event(a, constants.TRACE_EV_SUBMIT, prompt_tokens=3)
        tr.event(a, constants.TRACE_EV_FINISH, tokens=5)
        evs = tr.trace(a)
        assert [e["name"] for e in evs] == [constants.TRACE_EV_SUBMIT, constants.TRACE_EV_FINISH]
        assert evs[0]["attrs"]["prompt_tokens"] == 3 and evs[0]["t"] <= evs[1]["t"]

    def test_none_id_noop_bounds_and_foreign_ids(self):
        tr = Tracer(max_traces=3, max_events_per_trace=4)
        tr.event(None, constants.TRACE_EV_SUBMIT)
        assert tr.trace_ids() == []
        tid = tr.new_trace()
        for i in range(10):
            tr.event(tid, constants.TRACE_EV_PREFILL_CHUNK, start=i)
        assert [e["attrs"]["start"] for e in tr.trace(tid)] == [6, 7, 8, 9]
        tids = [tid] + [tr.new_trace() for _ in range(4)]
        assert len(tr.trace_ids()) == 3 and tr.trace(tids[0]) is None
        assert tr.dropped_traces == 2
        tr.event("tr-foreign", constants.TRACE_EV_RESTORE, slot=1)
        assert [e["name"] for e in tr.trace("tr-foreign")] == [constants.TRACE_EV_RESTORE]

    def test_constants_are_the_references(self):
        for name in ("TRACE_EVENTS", "FLIGHT_EVENTS", "TICK_PHASES", "COST_FIELDS",
                     "RECEIPT_STATUSES", "TRACE_ID_PREFIX", "KV_DTYPES"):
            assert getattr(constants, name) == getattr(jconstants, name), name
        for name in dir(constants):
            if name.startswith(("TENANT_KEY_", "TRACE_EV_", "FLIGHT_EV_", "TICK_PHASE_",
                                "COST_", "RECEIPT_")):
                assert getattr(constants, name) == getattr(jconstants, name), name


class TestFlightRecorder:
    def test_ring_keeps_newest_and_counts_lifetime(self):
        rec = FlightRecorder(capacity=4)
        for i in range(10):
            rec.record(constants.FLIGHT_EV_MACRO, slots=i)
        snap = rec.snapshot()
        assert [e["slots"] for e in snap] == [6, 7, 8, 9]
        assert [e["seq"] for e in snap] == [7, 8, 9, 10] and rec.events_recorded == 10

    def test_postmortems_freeze_the_ring_and_are_bounded(self):
        rec = FlightRecorder(capacity=8, max_postmortems=2)
        rec.record(constants.FLIGHT_EV_ADMIT, slot=0)
        dump = rec.dump(tfaults.FAULT_TRANSIENT)
        assert dump["reason"] == tfaults.FAULT_TRANSIENT
        assert [e["name"] for e in dump["events"]] == [constants.FLIGHT_EV_ADMIT]
        rec.record(constants.FLIGHT_EV_FINISH, slot=0, tokens=3)
        assert len(rec.postmortem_dumps()[0]["events"]) == 1
        rec.dump(tfaults.FAULT_POISON)
        rec.dump(tfaults.FAULT_DEVICE_LOST)
        assert [d["reason"] for d in rec.postmortem_dumps()] == [
            tfaults.FAULT_POISON, tfaults.FAULT_DEVICE_LOST]


class TestTickProfiler:
    @staticmethod
    def _both(body):
        """Run `body(prof)` on the port's profiler and the JAX one, each on
        a deterministic clock (1 s a read); returns both."""
        out = []
        for cls in (TickProfiler, jtracing.TickProfiler):
            prof = cls(clock=iter(range(1000)).__next__)
            body(prof)
            out.append(prof)
        return out

    @staticmethod
    def _state(p):
        return (p.ticks, p.tick_wall_s, p.dispatch_s, p.host_overhead_s, p.phase_s,
                list(p.dispatch_samples), list(p.host_overhead_samples))

    def test_nested_phases_attribute_exclusive_time(self):
        def body(prof):
            prof.begin_tick()
            with prof.phase("outer"):
                with prof.phase("inner"):
                    pass
            prof.end_tick()
        t, j = self._both(body)
        assert t.phase_s == {"outer": 2.0, "inner": 1.0} and t.tick_wall_s == 5.0
        assert self._state(t) == self._state(j)

    def test_dispatch_split_is_orthogonal_to_phases(self):
        def body(prof):
            prof.begin_tick()
            with prof.phase("macro"):
                with prof.dispatch():
                    pass
            prof.end_tick()
        t, j = self._both(body)
        assert t.phase_s == {"macro": 3.0} and t.dispatch_s == 1.0 and t.host_overhead_s == 4.0
        assert self._state(t) == self._state(j)

    def test_disabled_profiler_records_nothing(self):
        prof = TickProfiler(enabled=False)
        prof.begin_tick()
        with prof.phase("x"), prof.dispatch():
            pass
        prof.end_tick()
        assert prof.ticks == 0 and prof.phase_s == {} and prof.attribution_coverage() == 1.0

    def test_end_tick_observes_histograms(self):
        metrics, jmetrics = Metrics(), JaxMetrics()
        for cls, reg in ((TickProfiler, metrics), (jtracing.TickProfiler, jmetrics)):
            prof = cls(clock=iter(range(1000)).__next__)
            prof.begin_tick()
            with prof.phase(constants.TICK_PHASE_ADMIT):
                pass
            prof.end_tick(reg)
        body = metrics.render()
        assert "nos_tpu_decode_tick_phase_seconds_seconds_bucket" in body
        assert 'phase="admit"' in body
        assert "nos_tpu_decode_tick_host_overhead_seconds_seconds_count" in body
        assert body == jmetrics.render()


def test_metrics_registry_renders_as_the_references():
    regs = (Metrics(), JaxMetrics())
    for m in regs:
        m.inc("nos_tpu_decode_steps")
        m.inc("nos_tpu_decode_recoveries", 2, kind="poison")
        m.set_gauge("nos_tpu_decode_kv_blocks_free", 7)
        for v in (0.0001, 0.003, 0.2, 20.0):
            m.observe("nos_tpu_decode_tick_seconds", v)
        m.remove_gauge("nos_tpu_decode_kv_blocks_free")
    assert regs[0].render() == regs[1].render()
    assert regs[0].get("nos_tpu_decode_recoveries", kind="poison") == 2


# -- the pure-observer oracle (test_tracing.py:204) ----------------------------------------------
COUNTERS = ("steps_run", "macro_dispatches", "burst_dispatches", "prefill_dispatches",
            "prefill_tokens", "prefix_hit_blocks", "h2d_uploads", "staging_syncs",
            "blocking_syncs")


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_tracing_is_a_pure_observer(model, temperature):
    reqs = [(p, n, None) for p, n in zip(PROMPTS, (12, 8, 10, 14))]
    runs = []
    for traced in (False, True):
        _, tsrv = pair(model, traced=traced, n_slots=4, temperature=temperature)
        if traced:
            tsrv.metrics = Metrics()
        outs = drive(tsrv, reqs)
        runs.append((outs, {c: getattr(tsrv, c) for c in COUNTERS}))
    assert runs[1] == runs[0]


# -- lifecycle spans (test_tracing.py:247) --------------------------------------------------------
def test_request_trace_covers_the_lifecycle_as_the_jax_engine(model):
    jsrv, tsrv = pair(model)
    assert drive(tsrv, [(list(range(1, 21)), 6, None)]) == drive(
        jsrv, [(list(range(1, 21)), 6, None)])
    same_observations(jsrv, tsrv)
    ((tid, evs),) = events(tsrv).items()
    names = [n for n, _ in evs]
    order = (constants.TRACE_EV_SUBMIT, constants.TRACE_EV_RESERVED,
             constants.TRACE_EV_PREFILL_CHUNK, constants.TRACE_EV_FIRST_TOKEN,
             constants.TRACE_EV_DECODE, constants.TRACE_EV_FINISH)
    assert names[0] == order[0] and names[-1] == order[-1]
    assert [names.index(n) for n in order] == sorted(names.index(n) for n in order)
    assert names.count(constants.TRACE_EV_PREFILL_CHUNK) == 2


def test_span_attrs_are_counts_and_ids_only(model):
    jsrv, tsrv = pair(model)
    drive(tsrv, [([7, 3, 9, 1, 4], 5, None)])
    drive(jsrv, [([7, 3, 9, 1, 4], 5, None)])
    same_observations(jsrv, tsrv)
    for evs in events(tsrv).values():
        for name, attrs in evs:
            assert name in constants.TRACE_EVENTS
            assert all(isinstance(v, (int, float, str, bool)) for v in attrs.values())
    for ev in tsrv.tracing.recorder.snapshot():
        assert ev["name"] in constants.FLIGHT_EVENTS
        assert all(isinstance(v, (int, float, str, bool)) for v in ev.values())


# -- one trace across a restore and a preemption (test_tracing.py:302) ----------------------------
def test_one_trace_across_device_lost_restore(model):
    reqs = [(p, 10, None) for p in PROMPTS[:2]]
    _, base = pair(model, traced=False)
    want = drive(base, reqs)
    jsrv, tsrv = pair(model, injector=[("dispatch_macro", 2, "device-lost")],
                      transient_backoff_s=0.001)
    assert drive(tsrv, reqs) == drive(jsrv, reqs) == want
    same_observations(jsrv, tsrv)
    evs = events(tsrv)
    assert len(evs) == 2  # the recovery minted no new trace
    restored = [t for t, e in evs.items() if any(n == constants.TRACE_EV_RESTORE for n, _ in e)]
    assert restored
    for tid in restored:
        names = [n for n, _ in evs[tid]]
        assert names.index(constants.TRACE_EV_SUBMIT) < names.index(
            constants.TRACE_EV_RESTORE) < names.index(constants.TRACE_EV_FINISH)


def test_one_trace_across_a_preemption(model):
    """A guaranteed tenant's arrival preempts the borrower: its trace
    carries preempt, spill, then restore and revive, and finish, on one
    id, event for event as the JAX engine's."""
    kw = dict(quota={"g": (0.6, 1.0), "b": (0.0, 1.0)}, prompt_buckets=(8,),
              total_blocks=1 + 7, steps_per_dispatch=1)
    jsrv, tsrv = pair(model, **kw)
    outs = []
    for srv in (jsrv, tsrv):
        fb = srv.submit([5, 11, 3, 42, 7, 9, 2, 1, 6, 6, 6], max_new=40, tenant="b")
        for _ in range(8):
            srv._tick()
        fg = srv.submit([40, 41, 42], max_new=10, tenant="g")
        for _ in range(2000):
            if fb.done() and fg.done():
                break
            srv._tick()
        outs.append([fb.result(5), fg.result(5)])
    assert outs[1] == outs[0] and tsrv.preemptions >= 1
    same_observations(jsrv, tsrv)
    names = [n for n, _ in events(tsrv)["tr-00000001"]]
    assert [names.index(n) for n in (
        constants.TRACE_EV_PREEMPT, constants.TRACE_EV_SPILL, constants.TRACE_EV_RESTORE,
        constants.TRACE_EV_FINISH)] == sorted(names.index(n) for n in (
            constants.TRACE_EV_PREEMPT, constants.TRACE_EV_SPILL, constants.TRACE_EV_RESTORE,
            constants.TRACE_EV_FINISH))
    assert names.count(constants.TRACE_EV_FINISH) == 1


# -- postmortems (test_tracing.py:414) -------------------------------------------------------------
@pytest.mark.parametrize("spec, kind", [
    (("admit", 2, "poison"), "poison"),
    (("dispatch_macro", 2, "transient"), "transient"),
    (("dispatch_macro", 2, "device-lost"), "device-lost"),
])
def test_recovery_dumps_a_postmortem_for_every_fault_kind(model, spec, kind):
    reqs = [(p, 8, None) for p in PROMPTS[:2]]
    jsrv, tsrv = pair(model, injector=[spec], transient_backoff_s=0.001)
    assert drive(tsrv, reqs) == drive(jsrv, reqs)
    same_observations(jsrv, tsrv)
    dumps = tsrv.tracing.recorder.postmortem_dumps()
    assert dumps and dumps[0]["reason"] == kind
    names = {e["name"] for e in dumps[0]["events"]}
    assert constants.FLIGHT_EV_ADMIT in names and names <= set(constants.FLIGHT_EVENTS)
    if kind != "transient":
        assert constants.FLIGHT_EV_RECOVERY in [
            e["name"] for e in tsrv.tracing.recorder.snapshot()]


# -- attribution, the report and metrics (test_tracing.py:454, :478, :513) ----------------------
def test_phase_attribution_covers_95_percent_of_tick_wall(model):
    _, tsrv = pair(model, n_slots=4)
    drive(tsrv, [(list(range(1, 11)), 12, None)] * 4)
    prof = tsrv.tracing.profiler
    assert prof.ticks > 0 and prof.attribution_coverage() >= 0.95
    assert prof.dispatch_s > 0
    assert prof.host_overhead_s + prof.dispatch_s == pytest.approx(prof.tick_wall_s, rel=1e-6)
    for phase in (constants.TICK_PHASE_ADMIT, constants.TICK_PHASE_PUMP_PREFILL,
                  constants.TICK_PHASE_DISPATCH_MACRO, constants.TICK_PHASE_QUOTA_ENFORCE):
        assert phase in prof.phase_s
    assert tsrv.tick_phase_s == prof.phase_s and tsrv.ticks_profiled == prof.ticks


def test_serving_report_carries_and_merges_the_split(model):
    _, tsrv = pair(model)
    drive(tsrv, [([1, 2, 3, 4, 5], 6, None)])
    rep = collect_serving(tsrv)
    assert rep.ticks_profiled == tsrv.tracing.profiler.ticks and rep.tick_wall_s > 0
    assert rep.tick_phase_s and len(rep.dispatch_samples) == rep.ticks_profiled
    skew = ServingReport(ticks_profiled=1, tick_wall_s=100.0, tick_host_overhead_s=99.0,
                         tick_dispatch_s=1.0, tick_phase_s={constants.TICK_PHASE_ADMIT: 99.0},
                         host_overhead_samples=[99.0], dispatch_samples=[1.0])
    merged = ServingReport.merge([rep, skew])
    assert merged.ticks_profiled == rep.ticks_profiled + 1
    assert merged.tick_wall_s == pytest.approx(rep.tick_wall_s + 100.0)
    assert merged.tick_phase_s[constants.TICK_PHASE_ADMIT] == pytest.approx(
        rep.tick_phase_s[constants.TICK_PHASE_ADMIT] + 99.0)
    assert merged.host_overhead_p95_s == 99.0 and merged.host_overhead_p50_s < 99.0


def test_untraced_engine_reports_zeros(model):
    _, tsrv = pair(model, traced=False)
    drive(tsrv, [([1, 2, 3], 4, None)])
    rep = collect_serving(tsrv)
    assert rep.ticks_profiled == 0 and rep.tick_phase_s == {} and rep.dispatch_samples == []
    assert tsrv.tick_phase_s == {} and tsrv.tick_wall_s == 0.0


def test_collect_serving_counters_and_metrics_equal_the_jax_engines(model):
    """A preempting, spilling, reviving run with a registry armed on each
    side: every counter field of `collect_serving`, the per-slot maps, the
    report delta/rate helpers and every metric counter equal the JAX
    engine's; every series the engine emits is in METRIC_SERIES."""
    kw = dict(quota={"g": (0.6, 1.0), "b": (0.0, 1.0)}, prompt_buckets=(8,),
              total_blocks=1 + 7, steps_per_dispatch=2)
    jsrv, tsrv = pair(model, **kw)
    jsrv.metrics, tsrv.metrics = JaxMetrics(), Metrics()
    outs = []
    for srv in (jsrv, tsrv):
        first = srv.submit([5, 11, 3, 42, 7, 9, 2, 1], max_new=40, tenant="b")
        for _ in range(3):  # the borrower decodes, then the guarantee arrives
            srv._tick()
        assert not first.done()
        rest = drive(srv, [([40, 41, 42], 10, "g"), ([5, 11, 3, 42, 7, 9, 2, 1, 8], 6, None)])
        for _ in range(2000):
            if first.done():
                break
            srv._tick()
        outs.append([first.result(5)] + rest)
    assert outs[1] == outs[0]
    trep, jrep = collect_serving(tsrv), jtelemetry.collect_serving(jsrv)
    fields = telemetry.report_counter_fields()
    assert fields == jtelemetry.report_counter_fields()
    assert {f: getattr(trep, f) for f in fields} == {f: getattr(jrep, f) for f in fields}
    assert trep.macro_tokens_by_slot == jrep.macro_tokens_by_slot
    assert trep.spec_rounds_by_slot == jrep.spec_rounds_by_slot
    for f in telemetry.REPORT_GAUGE_FIELDS - {"kv_pool_bytes"}:
        assert getattr(trep, f) == getattr(jrep, f), f
    assert telemetry.report_delta(trep, None) == jtelemetry.report_delta(jrep, None) | {
        "kv_pool_bytes": trep.kv_pool_bytes}
    tc, jc = tsrv.metrics._counters, jsrv.metrics._counters
    assert dict(tc) == dict(jc)
    emitted = {name for name, _ in list(tc) + list(tsrv.metrics._gauges)
               + list(tsrv.metrics._durations)}
    assert emitted <= {s.name for s in METRIC_SERIES}
    assert trep.preemptions >= 1 and trep.revives > 0
    assert telemetry.export_serving(tsrv) is None  # opt-in only
    sent = []
    assert telemetry.export_serving(tsrv, share_telemetry=True, sink=sent.append) is not None
    assert len(sent) == 1
