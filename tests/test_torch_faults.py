"""Surgical recovery in the port's DecodeServer (nos_tpu_torch/runtime/
decode_server.py: `_recover`, `_checkpoint_slot`, `_enqueue_restores`, the
fault sites; runtime/faults.py and runtime/checkpoint.py) against the JAX
engine, on the CPU, mirroring the reference's tests/test_serving_faults.py
(and the fault cases of test_burst_decode.py:155 and
test_sharded_decode.py:178).

Both engines serve the shared float32 test model (the JAX init carried
across with `from_numpy_params`) at their defaults, surgical recovery
included, each with its own FaultInjector built from the same schedule.
Every case holds the port to the JAX engine: equal tokens (or equal
failures), equal recovery counters (`recoveries`, `slots_restored`,
`replay_tokens`, `requests_poisoned`, `transient_retries`,
`fail_all_recoveries`) and equal visit counts at every injection site, so
the seeded schedules fire at the same point of the same tick sequence.
Then each side is held to the reference's own oracle: every stream that
resolves is bit-identical to the fault-free run, every failure is a
classified poison, the pool is conserved.

The JAX fault-free runs are shared per module; the seeded chaos runs
submit everything before start() (one deterministic admission wave) and
go through each engine's own `_run` loop; the others drive the tick and
`_recover` by hand, as the reference's tests do."""

import dataclasses

import jax
import numpy as np
import pytest

from nos_tpu.parallel.mesh import build_mesh as jax_build_mesh
from nos_tpu.runtime import checkpoint as jck
from nos_tpu.runtime.divergence import compare_output_streams
from nos_tpu.runtime import faults as jfaults
from nos_tpu.runtime.decode_server import DecodeServer as JaxServer
from nos_tpu_torch import DecodeServer, GPTConfig, from_numpy_params
from nos_tpu_torch.parallel import build_mesh
from nos_tpu_torch.runtime import checkpoint as tck
from nos_tpu_torch.runtime import faults as tfaults

from conftest import serving_test_config, serving_test_params

# tests/test_serving_faults.py's traffic and engine.
CHAOS_PROMPTS = [
    [5, 11, 3, 42],
    [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12],
    [40, 41, 42],
    [9, 8, 7, 6, 5, 4, 3, 2, 1],
    [20, 21, 22, 23, 24],
    [77, 3, 77, 3, 77, 3, 77, 3],
]
CHAOS_NEWS = [12, 8, 16, 10, 14, 9]
ENGINE = dict(n_slots=4, max_len=64, prompt_buckets=(8, 16), block_size=8,
              steps_per_dispatch=4, transient_backoff_s=0.001)
# tests/test_burst_decode.py's and test_sharded_decode.py's prompts and engine.
BURST_PROMPTS = [
    [3, 11, 42, 7, 19, 5, 23, 2, 61, 13],
    [8, 8, 31, 4, 90, 17, 6, 44, 9, 28],
    [55, 1, 2, 3, 70, 70, 12, 39, 80, 10],
]
SHARDED_PROMPTS = [
    [3, 11, 42, 7, 19, 5, 23, 2, 61, 13, 37, 4, 88, 29, 54, 6, 71, 9, 15, 33],
    [8, 8, 31, 4, 90, 17, 6, 44, 9, 28, 2, 95, 41, 63, 5, 12],
    [55, 1, 2, 3, 70, 70, 12, 39, 80, 10],
]
SMALL = dict(n_slots=3, max_len=96, prompt_buckets=(8, 16), block_size=8, steps_per_dispatch=4,
             transient_backoff_s=0.001)
RECOVERY = ("recoveries", "slots_restored", "replay_tokens", "requests_poisoned",
            "transient_retries", "fail_all_recoveries")
# The counters no host-readiness timing moves.
READINESS_FREE = ("recoveries", "requests_poisoned", "fail_all_recoveries")
# Every site either engine visits (SITES, and the two the reference checks
# but never schedules from a seed).
VISITED = tfaults.SITES + ("cow", "dispatch_burst")


@pytest.fixture(scope="module")
def model():
    jcfg, jparams = serving_test_config(), serving_test_params()
    tcfg = GPTConfig(**dataclasses.asdict(jcfg))
    tparams = from_numpy_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def port_engine(model, **kw):
    return DecodeServer(model[3], model[2], device="cpu", **kw)


def engines(model, **kw):
    """The JAX engine and the port's, from the same arguments."""
    jcfg, jparams, _, _ = model
    return JaxServer(jparams, jcfg, **kw), port_engine(model, **kw)


def _armed(model, jinj, tinj, **kw):
    """engines() with each side's injector."""
    jcfg, jparams, tcfg, tparams = model
    mesh, jmesh = kw.pop("mesh", None), kw.pop("jmesh", None)
    jsrv = JaxServer(jparams, jcfg, fault_injector=jinj, mesh=jmesh, **kw)
    device = "cpu" if mesh is None else None
    return jsrv, DecodeServer(tparams, tcfg, fault_injector=tinj, mesh=mesh, device=device,
                              **kw)


def injectors(schedule=(), seeded=None):
    """A JAX and a port FaultInjector with the same schedule: explicit
    (site, occurrence, kind) triples, or `seeded` = (seed, kwargs), each
    package drawing its own."""
    if seeded is not None:
        seed, kw = seeded
        return jfaults.FaultInjector.seeded(seed, **kw), tfaults.FaultInjector.seeded(seed, **kw)
    return (jfaults.FaultInjector([jfaults.FaultSpec(*s) for s in schedule]),
            tfaults.FaultInjector([tfaults.FaultSpec(*s) for s in schedule]))


def serve(server, reqs=None):
    """Queue every request, then start (`_run` handles the faults):
    per-request ("ok", tokens) or ("err", exception)."""
    reqs = reqs or list(zip(CHAOS_PROMPTS, CHAOS_NEWS))
    futs = [server.submit(p, max_new=n) for p, n in reqs]
    server.start()
    outcomes = []
    try:
        for f in futs:
            try:
                outcomes.append(("ok", f.result(timeout=300)))
            except Exception as e:  # noqa: BLE001 — the outcome under test
                outcomes.append(("err", e))
    finally:
        server.stop()
    return outcomes


def drive(server, reqs):
    """Submit, then tick by hand, each fault through `_recover` as `_run`
    does; returns the tokens in submit order."""
    futs = [server.submit(p, max_new=n) for p, n in reqs]
    for _ in range(4000):
        if all(f.done() for f in futs):
            break
        try:
            server._tick()
        except Exception as exc:  # noqa: BLE001 — the _run contract
            server._recover(exc)
    return [f.result(timeout=5) for f in futs]


def same_run(jsrv, tsrv, jinj=None, tinj=None, jout=None, tout=None, counters=RECOVERY):
    """The port's run is the JAX engine's: outcomes (tokens, or a poison
    on both sides), recovery counters and every site's visits."""
    if jout is not None:
        assert len(tout) == len(jout)
        for (jk, jv), (tk, tv) in zip(jout, tout):
            assert tk == jk, (jv, tv)
            if jk == "ok":
                assert tv == jv
            else:
                assert type(tv).__name__ == type(jv).__name__
                assert tfaults.classify_fault(tv) == jfaults.classify_fault(jv)
    assert {c: getattr(tsrv, c) for c in counters} == {c: getattr(jsrv, c) for c in counters}
    if jinj is not None:
        assert {s: tinj.visits(s) for s in VISITED} == {s: jinj.visits(s) for s in VISITED}
        assert ([(f.site, f.occurrence, f.kind, slot) for f, slot in tinj.fired]
                == [(f.site, f.occurrence, f.kind, slot) for f, slot in jinj.fired])


def held_to_oracle(server, outcomes, base, mod):
    """The reference's chaos oracle on one side: resolved streams equal the
    fault-free run, failures are classified poisons (as many as the engine
    counted), the fail-all sweep never ran, the pool is conserved and
    holds no block in use. `mod` is the side's faults module."""
    n_poisoned = 0
    for (kind, value), (_, want) in zip(outcomes, base):
        if kind == "ok":
            assert value == want
        else:
            n_poisoned += 1
            assert mod.classify_fault(value) == mod.FAULT_POISON, value
    assert n_poisoned == server.requests_poisoned
    assert server.fail_all_recoveries == 0
    assert server._block_mgr.conserved()
    assert server._block_mgr.counts()["in_use"] == 0


@pytest.fixture(scope="module")
def bases(model):
    """The fault-free runs, native and int8: the JAX engine's, and the
    port's equal to it."""
    out = {}
    for kv in ("fp16", "int8"):
        jsrv, tsrv = engines(model, kv_dtype=kv, **ENGINE)
        jout, tout = serve(jsrv), serve(tsrv)
        assert all(k == "ok" for k, _ in jout)
        assert tout == jout
        out[kv] = jout
    return out


def _chaos(model, bases, seed, kv):
    kw = dict(n_faults=3, max_occurrence=8)
    jinj, tinj = injectors(seeded=(seed, kw))
    assert list(tinj.schedule) == [tfaults.FaultSpec(s.site, s.occurrence, s.kind)
                                   for s in jinj.schedule]
    jsrv, tsrv = _armed(model, jinj, tinj, kv_dtype=kv, **ENGINE)
    jout, tout = serve(jsrv), serve(tsrv)
    base = bases[kv]
    held_to_oracle(tsrv, tout, base, tfaults)
    if kv == "fp16":
        same_run(jsrv, tsrv, jinj, tinj, jout, tout)
        held_to_oracle(jsrv, jout, base, jfaults)
    else:
        # The reference's int8 oracle (test_serving_faults.py:142): after a
        # recovery the JAX engine's replay re-quantizes blocks whose f32
        # rows differ from XLA's decode-written ones in the last bit (ROADMAP
        # C), and may leave its fault-free stream; the port's may not.
        # Where the JAX run kept its stream, the port's equals it.
        same_run(jsrv, tsrv, jinj, tinj)
        assert [k for k, _ in tout] == [k for k, _ in jout]
        for (kind, jv), (_, tv), (_, want) in zip(jout, tout, base):
            if kind != "ok":
                assert jfaults.classify_fault(jv) == jfaults.FAULT_POISON
            elif jv == want or jsrv.recoveries == 0:
                assert tv == jv
            else:
                assert len(jv) == len(want) and compare_output_streams(want, jv) >= 0.5
        assert jsrv._block_mgr.conserved() and jsrv.fail_all_recoveries == 0
    if tinj.fired:
        kinds = {spec.kind for spec, _ in tinj.fired}
        if kinds - {tfaults.FAULT_TRANSIENT}:
            assert tsrv.recoveries > 0
        else:
            assert tsrv.transient_retries > 0
    return tsrv, tinj


# -- the chaos gate -----------------------------------------------------------------
@pytest.mark.parametrize("seed", range(7))
def test_chaos_seeds_equal_jax_and_fault_free(model, bases, seed):
    """test_serving_faults.py:98 on both packages: three seeded faults of
    every kind at every site, each engine through its own `_run` loop."""
    _chaos(model, bases, seed, "fp16")


@pytest.mark.parametrize("seed", range(7))
def test_chaos_seeds_int8_pool_equal_jax_and_fault_free(model, bases, seed):
    """test_serving_faults.py:142 on both packages, over the int8 pool: the
    replay re-quantizes fresh blocks, and the port's streams still come
    back bit-identical to its int8 fault-free run; the JAX engine's are
    held to the reference's int8 oracle and, where they kept their
    fault-free stream, equal the port's (see `_chaos`)."""
    tsrv, _ = _chaos(model, bases, seed, "int8")
    assert tsrv.kv_quant_enabled == 1 and tsrv.kv_quant_payload_rejected == 0


# -- the fault kinds one at a time ----------------------------------------------------
def test_device_lost_restores_every_stream(model, bases):
    """Device-lost mid-decode: every slot checkpoints, the pool resets in
    place, every request re-admits and completes bit-identical, with one
    restore-latency sample a restored slot."""
    jinj, tinj = injectors([("dispatch_macro", 3, tfaults.FAULT_DEVICE_LOST)])
    jsrv, tsrv = _armed(model, jinj, tinj, **ENGINE)
    jout, tout = serve(jsrv), serve(tsrv)
    same_run(jsrv, tsrv, jinj, tinj, jout, tout)
    assert [v for _, v in tout] == [v for _, v in bases["fp16"]]
    assert tsrv.recoveries == 1 and tsrv.slots_restored > 0 and tsrv.replay_tokens > 0
    assert len(tsrv.restore_latency_s) == tsrv.slots_restored
    assert len(tsrv.ttft_s) == len(CHAOS_PROMPTS)


def test_transient_retries_without_teardown(model, bases):
    jinj, tinj = injectors([("dispatch_macro", 2, tfaults.FAULT_TRANSIENT),
                            ("dispatch_prefill_wave", 2, tfaults.FAULT_TRANSIENT)])
    jsrv, tsrv = _armed(model, jinj, tinj, **ENGINE)
    jout, tout = serve(jsrv), serve(tsrv)
    same_run(jsrv, tsrv, jinj, tinj, jout, tout)
    assert [v for _, v in tout] == [v for _, v in bases["fp16"]]
    assert tsrv.transient_retries == 2
    assert tsrv.recoveries == tsrv.slots_restored == tsrv.replay_tokens == 0


def test_transient_streak_escalates_to_device_lost(model, bases):
    jinj, tinj = injectors([("dispatch_macro", k, tfaults.FAULT_TRANSIENT)
                            for k in range(1, 9)])
    jsrv, tsrv = _armed(model, jinj, tinj, max_transient_retries=3, **ENGINE)
    jout, tout = serve(jsrv), serve(tsrv)
    same_run(jsrv, tsrv, jinj, tinj, jout, tout)
    assert [v for _, v in tout] == [v for _, v in bases["fp16"]]
    assert tsrv.recoveries >= 1 and tsrv.transient_retries >= 3


def test_fail_all_without_surgical_recovery(model):
    """surgical_recovery=False keeps the legacy sweep on both packages:
    the same device-lost fails every in-flight request."""
    jinj, tinj = injectors([("dispatch_macro", 3, tfaults.FAULT_DEVICE_LOST)])
    jsrv, tsrv = _armed(model, jinj, tinj, surgical_recovery=False, **ENGINE)
    jout, tout = serve(jsrv), serve(tsrv)
    same_run(jsrv, tsrv, jinj, tinj, jout, tout)
    failed = [v for k, v in tout if k == "err"]
    assert failed and all(isinstance(e, tfaults.DeviceLostError) for e in failed)
    assert tsrv.fail_all_recoveries >= 1 and tsrv.recoveries == 0


def _poison_mid_decode(server, injector, neighbors, victim, site_cls):
    """test_serving_faults.py:245's driving: tick until three neighbors
    decode mid-stream, then submit the victim and aim a poison at the next
    prefill wave."""
    futs = [server.submit(p, max_new=10) for p in neighbors]
    for _ in range(64):
        server._tick()
        slots = server._slots[:3]
        if all(s.active and s.phase == "decoding" for s in slots) and all(
                0 < len(s.refs) < 10 for s in slots):
            break
    fvictim = server.submit(victim, max_new=10)
    injector.add(site_cls("dispatch_prefill_wave",
                          injector.visits("dispatch_prefill_wave") + 1, "poison"))
    for _ in range(256):
        try:
            server._tick()
        except Exception as exc:  # noqa: BLE001 — the _run contract
            server._recover(exc)
        if all(f.done() for f in (*futs, fvictim)):
            break
    return futs, fvictim


def test_poison_mid_decode_fails_only_the_culpable_slot(model):
    neighbors = [[5, 11, 3, 42], [1, 2, 3, 4, 5, 6, 7], [9, 8, 7]]
    victim = [50, 51, 52, 53]
    kw = dict(n_slots=4, max_len=64, prompt_buckets=(8,), block_size=8)
    ref = port_engine(model, **kw)
    want = drive(ref, [(p, 10) for p in neighbors])
    jinj, tinj = injectors()
    jsrv, tsrv = _armed(model, jinj, tinj, **kw)
    jres = _poison_mid_decode(jsrv, jinj, neighbors, victim, jfaults.FaultSpec)
    tres = _poison_mid_decode(tsrv, tinj, neighbors, victim, tfaults.FaultSpec)
    same_run(jsrv, tsrv, jinj, tinj)
    (jfuts, jvictim), (tfuts, tvictim) = jres, tres
    assert isinstance(tvictim.exception(timeout=5), tfaults.PoisonRequestError)
    assert isinstance(jvictim.exception(timeout=5), jfaults.PoisonRequestError)
    assert [f.result(timeout=5) for f in tfuts] == [f.result(timeout=5) for f in jfuts] == want
    assert tsrv.requests_poisoned == 1 and tsrv.recoveries == 1
    assert tsrv._block_mgr.conserved()


def _poison_partial_hit(server, injector, donor, site_cls):
    fa = server.submit(donor, max_new=5)
    server._admit()
    server._pump_prefill()  # one 8-token chunk: the donor's block 0 registered
    fb = server.submit(donor, max_new=5)  # the same prefix: admits with 1 hit
    server._admit()
    assert server.prefix_hit_blocks == 1 and server._block_mgr.counts()["shared"] == 1
    injector.add(site_cls("dispatch_prefill_wave",
                          injector.visits("dispatch_prefill_wave") + 1, "poison"))
    for _ in range(256):
        try:
            server._tick()
        except Exception as exc:  # noqa: BLE001 — the _run contract
            server._recover(exc)
            assert server._block_mgr.conserved()
        if fa.done() and fb.done():
            break
    return fa, fb


def test_poison_mid_prefill_wave_with_partial_prefix_hit(model):
    """The poison blames the slot holding a partial prefix hit; recovery
    fails only it, drops its hit refcounts and restores the donor."""
    donor = [((i * 5) % 91) + 1 for i in range(40)]
    kw = dict(n_slots=2, max_len=64, prompt_buckets=(8,), block_size=8,
              prefill_budget_tokens=8)
    jinj, tinj = injectors()
    jsrv, tsrv = _armed(model, jinj, tinj, **kw)
    jfa, jfb = _poison_partial_hit(jsrv, jinj, donor, jfaults.FaultSpec)
    tfa, tfb = _poison_partial_hit(tsrv, tinj, donor, tfaults.FaultSpec)
    same_run(jsrv, tsrv, jinj, tinj)
    for j, t in ((jfa, tfa), (jfb, tfb)):
        assert (t.exception(timeout=5) is None) == (j.exception(timeout=5) is None)
    poisoned = [f for f in (tfa, tfb) if f.exception() is not None]
    assert len(poisoned) == 1 and isinstance(poisoned[0].exception(),
                                             tfaults.PoisonRequestError)
    survivor = tfb if poisoned[0] is tfa else tfa
    solo = port_engine(model, n_slots=2, max_len=64, prompt_buckets=(8,), block_size=8)
    assert survivor.result() == drive(solo, [(donor, 5)])[0]
    assert survivor.result() == (jfb if poisoned[0] is tfa else jfa).result()
    assert tsrv.requests_poisoned == 1 and tsrv._block_mgr.conserved()


def test_recovery_with_eos_and_spec_streams(model):
    """Device-lost during a speculating engine's verify rounds (the spec
    controller's snapshot rides the checkpoint), and during an eos stream:
    both restore to the fault-free tokens, as the JAX engine does. A verify
    round resolves, and an eos is scanned, once its tokens are ready on the
    host: a wall-clock property (the JAX engine's CPU dispatch is
    asynchronous, the port's CPU tensors are ready at once), so how many
    tokens a checkpoint holds, and with it `replay_tokens` and the later
    site visits, may differ between the packages; the tokens and the
    recovery itself may not."""
    rep = [3, 1, 4, 1, 5, 9, 2, 6] * 5
    plain = [7, 7, 2, 9] * 6
    kw = dict(n_slots=2, max_len=128, prompt_buckets=(8, 16, 32), block_size=8)
    spec = dict(kw, spec_k=4, spec_sync=True)
    base = drive(port_engine(model, **spec), [(rep, 20), (plain, 20)])
    jinj, tinj = injectors([("dispatch_verify", 2, tfaults.FAULT_DEVICE_LOST)])
    jsrv, tsrv = _armed(model, jinj, tinj, **spec)
    jout = drive(jsrv, [(rep, 20), (plain, 20)])
    tout = drive(tsrv, [(rep, 20), (plain, 20)])
    same_run(jsrv, tsrv, counters=READINESS_FREE)
    assert tout == jout == base and tsrv.recoveries == 1
    eos = base[0][len(base[0]) // 2]
    want = drive(port_engine(model, eos_id=eos, **kw), [(rep, 20)])
    jinj, tinj = injectors([("dispatch_macro", 1, tfaults.FAULT_DEVICE_LOST)])
    jsrv, tsrv = _armed(model, jinj, tinj, eos_id=eos, **kw)
    jout, tout = drive(jsrv, [(rep, 20)]), drive(tsrv, [(rep, 20)])
    same_run(jsrv, tsrv, counters=READINESS_FREE)
    assert tout == jout == want and tsrv.recoveries == 1


def test_sampled_stream_restores_exact_prng_continuation(model):
    """A temperature stream keeps its serial across a device-lost restore
    and offsets its PRNG step by the replayed tokens: the sampled tokens
    equal the fault-free run's and the JAX engine's."""
    kw = dict(n_slots=2, max_len=64, prompt_buckets=(8,), block_size=8, temperature=0.8,
              seed=11)
    reqs = [([4, 9, 2, 33], 12)]
    base = drive(port_engine(model, **kw), reqs)
    jinj, tinj = injectors([("dispatch_macro", 2, tfaults.FAULT_DEVICE_LOST)])
    jsrv, tsrv = _armed(model, jinj, tinj, **kw)
    jout, tout = drive(jsrv, reqs), drive(tsrv, reqs)
    same_run(jsrv, tsrv, jinj, tinj)
    assert tout == jout == base and len(base[0]) == 12
    assert tsrv.recoveries == 1 and tsrv.replay_tokens > 0


def test_bursts_degrade_under_faults_then_resume(model):
    """test_burst_decode.py:155: while the schedule holds a fault the engine
    stays per-tick; the recovery replays bit-identically, and bursts resume
    once the schedule is exhausted."""
    reqs = [(p, 24) for p in BURST_PROMPTS]
    baseline = drive(port_engine(model, burst_windows=6, **SMALL), reqs)
    jinj, tinj = injectors([("dispatch_macro", 3, tfaults.FAULT_DEVICE_LOST)])
    jsrv, tsrv = _armed(model, jinj, tinj, burst_windows=6, **SMALL)
    jout, tout = drive(jsrv, reqs), drive(tsrv, reqs)
    same_run(jsrv, tsrv, jinj, tinj)
    assert tout == jout == baseline
    assert tinj.fired and tsrv.recoveries == 1 and tsrv._block_mgr.conserved()
    assert tsrv.burst_dispatches == jsrv.burst_dispatches > 0


@pytest.mark.multidevice
@pytest.mark.parametrize("seed", range(7))
def test_sharded_chaos_gate(model, seed):
    """test_sharded_decode.py:178: seeded transient and device-lost faults
    at the dispatch sites of a tp=2 engine; the port at tp=2 (a CPU mesh)
    equals the JAX engine at tp=2 and the fault-free single-device run."""
    reqs = [(p, 16) for p in SHARDED_PROMPTS]
    baseline = drive(port_engine(model, **SMALL), reqs)
    kw = dict(n_faults=2, kinds=(tfaults.FAULT_TRANSIENT, tfaults.FAULT_DEVICE_LOST),
              sites=("dispatch_macro", "dispatch_prefill_wave"))
    jinj, tinj = injectors(seeded=(seed, kw))
    jsrv, tsrv = _armed(model, jinj, tinj, mesh=build_mesh({"tp": 2}, devices=["cpu", "cpu"]),
                        jmesh=jax_build_mesh({"tp": 2}, devices=jax.devices()[:2]), **SMALL)
    jout, tout = drive(jsrv, reqs), drive(tsrv, reqs)
    same_run(jsrv, tsrv, jinj, tinj)
    assert tsrv.tp == 2
    assert tout == jout == baseline
    assert tsrv._block_mgr.conserved()


def test_checkpoint_hook_at_burst_boundaries(model):
    """The hook sees `checkpoint_snapshot()` at every burst boundary: the
    same checkpoints as the JAX engine's hook (prompt, tokens, budget,
    serial, cursor), every one a strict prefix of its stream, and the
    outputs and dispatch counters those of the unhooked engine."""
    reqs = [(p, 24) for p in BURST_PROMPTS]
    plain = port_engine(model, burst_windows=6, **SMALL)
    want = drive(plain, reqs)
    seen = {"jax": [], "port": []}
    jsrv, tsrv = engines(model, burst_windows=6, **SMALL)
    jsrv.set_checkpoint_hook(lambda cks: seen["jax"].append(
        [{k: v for k, v in ck.to_dict().items() if k != "t_submit"} for ck in cks]))
    tsrv.set_checkpoint_hook(lambda cks: seen["port"].append(
        [{k: v for k, v in ck.to_dict().items() if k != "t_submit"} for ck in cks]))
    jout, tout = drive(jsrv, reqs), drive(tsrv, reqs)
    assert tout == jout == want
    assert tsrv.burst_dispatches == plain.burst_dispatches > 0
    assert len(seen["port"]) == tsrv.burst_dispatches
    assert seen["port"] == seen["jax"]
    by_prompt = {tuple(p): out for (p, _), out in zip(reqs, want)}
    for snap in seen["port"]:
        for ck in snap:
            full = by_prompt[tuple(ck["prompt"])]
            assert ck["generated"] == full[: len(ck["generated"])]
            assert len(ck["generated"]) < ck["max_new"]


def test_checkpoint_slot_captures_and_resolves_completed(model):
    """`_checkpoint_slot`'s two branches on both packages: a mid-stream
    capture (prompt, tokens, serial, the client future), and a capture that
    already completes the budget resolves the future instead."""
    prompt = [5, 11, 3, 42]
    jsrv, tsrv = engines(model, n_slots=2, max_len=64, prompt_buckets=(8,), block_size=8)
    cks = []
    for server in (jsrv, tsrv):
        fut = server.submit(prompt, max_new=12)
        for _ in range(32):
            server._tick()
            slot = server._slots[0]
            if slot.active and slot.phase == "decoding" and 2 <= len(slot.refs) < 12:
                break
        ck = server._checkpoint_slot(0)
        assert ck.future is fut and ck.replay_prompt() == prompt + ck.generated
        assert ck.serial == int(server._slot_serial[0])
        cks.append(ck)
        server._slots[0].max_new = len(ck.generated)
        assert server._checkpoint_slot(0) is None
        assert fut.result(timeout=5) == ck.generated
        server.stop()
    assert ({k: v for k, v in cks[1].to_dict().items() if k != "t_submit"}
            == {k: v for k, v in cks[0].to_dict().items() if k != "t_submit"})


def test_restore_waiting_at_stop_fails_cleanly(model):
    """A checkpoint still waiting in the re-admission line fails (never
    strands) when the engine stops."""
    tsrv = port_engine(model, n_slots=2, max_len=64, prompt_buckets=(8,), block_size=8,
                       burst_windows=1)
    fut = tsrv.submit([5, 11, 3, 42], max_new=12)
    for _ in range(8):
        tsrv._tick()
    tsrv._recover(tfaults.DeviceLostError("mid-flight"))
    assert len(tsrv._waiting) == 1 and tsrv._waiting[0].serial is not None
    tsrv.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        fut.result(timeout=5)


# -- the host modules against the reference's -----------------------------------------
EXCEPTIONS = [
    ("poison", lambda m: m.PoisonRequestError("p", slot=2)),
    ("transient", lambda m: m.TransientDispatchError("t")),
    ("device-lost", lambda m: m.DeviceLostError("d")),
    ("unreachable", lambda m: m.ReplicaUnreachableError("u", replica="r0")),
    ("lost", lambda m: m.ReplicaLostError("l", prompt=[1, 2], max_new=3)),
    ("flake", lambda m: RuntimeError("remote_compile: read body: closed")),
    ("reset", lambda m: OSError("Connection reset by peer")),
    ("value", lambda m: ValueError("nonsense")),
    ("crash", lambda m: RuntimeError("xla crash")),
]


@pytest.mark.parametrize("name,make", EXCEPTIONS, ids=[n for n, _ in EXCEPTIONS])
def test_classify_fault_equals_the_reference(name, make):
    """classify_fault and poison_slot_of on the same exceptions, bare and
    chained as a cause, in both packages."""
    def chained(m):
        try:
            try:
                raise make(m)
            except Exception as inner:
                raise RuntimeError("wrapped") from inner
        except RuntimeError as outer:
            return outer

    for build in (make, chained):
        t, j = build(tfaults), build(jfaults)
        assert tfaults.classify_fault(t) == jfaults.classify_fault(j)
        assert tfaults.poison_slot_of(t) == jfaults.poison_slot_of(j)
    assert tfaults.FAULT_KINDS == jfaults.FAULT_KINDS
    assert tfaults.SITES == jfaults.SITES and tfaults.POISON_SITES == jfaults.POISON_SITES


@pytest.mark.parametrize("seed,kw", [(7, dict(n_faults=4)), (0, dict(n_faults=3,
                                                                      max_occurrence=8)),
                                     (3, dict(n_faults=2, kinds=("transient", "device-lost"),
                                              sites=("dispatch_macro",
                                                     "dispatch_prefill_wave")))])
def test_seeded_injector_draws_the_reference_schedule(seed, kw):
    """`FaultInjector.seeded` draws the reference's schedule from the same
    seed; an injector fires the same faults at the same visits, counts
    nothing while disarmed, and validates its specs."""
    t, j = tfaults.FaultInjector.seeded(seed, **kw), jfaults.FaultInjector.seeded(seed, **kw)
    assert [dataclasses.astuple(s) for s in t.schedule] == [dataclasses.astuple(s)
                                                            for s in j.schedule]
    for inj in (t, j):
        for _ in range(10):
            for site in tfaults.SITES:
                try:
                    inj.check(site, slot=1)
                except Exception:  # noqa: BLE001 — recorded in inj.fired
                    pass
    assert ([(dataclasses.astuple(s), slot) for s, slot in t.fired]
            == [(dataclasses.astuple(s), slot) for s, slot in j.fired])
    assert not t.has_pending() and not j.has_pending()
    with pytest.raises(ValueError, match="site"):
        tfaults.FaultSpec("nonexistent", 1, tfaults.FAULT_POISON)
    with pytest.raises(ValueError, match="1-based"):
        tfaults.FaultSpec("admit", 0, tfaults.FAULT_POISON)
    off = tfaults.FaultInjector([tfaults.FaultSpec("admit", 1, "poison")], armed=False)
    off.check("admit", slot=0)
    assert off.visits("admit") == 0


def test_slot_checkpoint_equals_the_reference():
    """SlotCheckpoint: the same replay prompt, remaining budget and dict in
    both packages, each reading the other's dict, and a foreign version
    refused."""
    kw = dict(prompt=[1, 2, 3], generated=[4, 5], max_new=6, serial=9, t_submit=12.5,
              prefill_cursor=3, spec={"rate": 0.5, "denied_for": 2})
    t, j = tck.SlotCheckpoint(**kw), jck.SlotCheckpoint(**kw)
    assert t.replay_prompt() == j.replay_prompt() == [1, 2, 3, 4, 5]
    assert t.remaining_new == j.remaining_new == 4
    assert t.to_dict() == j.to_dict()
    assert tck.SlotCheckpoint.from_dict(j.to_dict()) == t
    assert jck.SlotCheckpoint.from_dict(t.to_dict()) == j
    with pytest.raises(ValueError, match="version"):
        tck.SlotCheckpoint.from_dict(dict(t.to_dict(), version=1))
