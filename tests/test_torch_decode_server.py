"""The port's DecodeServer (nos_tpu_torch/runtime/decode_server.py) against
the JAX DecodeServer on identical traffic, on the CPU.

Both engines serve the shared float32 test model (the JAX init carried
across with `from_numpy_params`) and must return IDENTICAL greedy tokens.
Both run their defaults (the radix cache, the spill tier and surgical
recovery on; tests/test_torch_faults.py drives the recovery). Both engines burst with their shared
default, burst_windows=4. Where all traffic is queued before start(), the
two engines' prefill, macro and burst dispatch counts must agree too. Also pinned here: the package imports neither jax nor nos_tpu,
and the engine refuses to drift to the CPU when no CUDA device exists."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from nos_tpu.runtime.decode_server import DecodeServer as JaxServer
from nos_tpu_torch import DecodeServer, GPTConfig, from_numpy_params, init_gpt
from nos_tpu_torch import telemetry as tt
from nos_tpu_torch.models.decode import init_paged_cache
from nos_tpu_torch.observability import Metrics
from nos_tpu_torch.runtime.quota import QuotaPolicy, TenantShare
from nos_tpu_torch.serving import CostLedger, FleetKVStore
from nos_tpu_torch.tracing import EngineTracing

from conftest import serving_test_config, serving_test_params

DISPATCH_COUNTERS = ("prefill_dispatches", "macro_dispatches", "burst_dispatches",
                     "burst_windows_run", "steps_run", "prefill_tokens")


@pytest.fixture(scope="module")
def model():
    jcfg = serving_test_config()
    tcfg = GPTConfig(**dataclasses.asdict(jcfg))
    jparams = serving_test_params()
    tparams = from_numpy_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def prompts(seed, lengths, vocab=97):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=n).tolist() for n in lengths]


def serve(server, traffic):
    """Queue every request, then start: dispatch counts are deterministic."""
    futs = [server.submit(p, n) for p, n in traffic]
    server.start()
    try:
        return [f.result(timeout=300) for f in futs]
    finally:
        server.stop()


def run_both(model, traffic, **kw):
    jcfg, jparams, tcfg, tparams = model
    jsrv = JaxServer(jparams, jcfg, **kw)
    tsrv = DecodeServer(tparams, tcfg, device="cpu", **kw)
    jout = serve(jsrv, traffic)
    tout = serve(tsrv, traffic)
    assert tout == jout
    assert ({c: getattr(tsrv, c) for c in DISPATCH_COUNTERS}
            == {c: getattr(jsrv, c) for c in DISPATCH_COUNTERS})
    return jsrv, tsrv, tout


def test_single_request(model):
    (p,) = prompts(0, [5])
    _, tsrv, (out,) = run_both(model, [(p, 8)], n_slots=2, max_len=64)
    assert len(out) == 8
    # K=1: the prefill tick's window, then bursts of 4 and 2 windows.
    assert tsrv.steps_run == tsrv.macro_dispatches + tsrv.burst_dispatches == 3
    assert tsrv.macro_dispatches + tsrv.burst_windows_run == 7


def test_concurrent_streams_are_isolated(model):
    traffic = [(p, 10) for p in prompts(1, [3, 9, 14])]
    _, _, outs = run_both(model, traffic, n_slots=3, max_len=64)
    # Isolation: each stream alone gives the same tokens.
    _, _, tcfg, tparams = model
    for (p, n), want in zip(traffic, outs):
        solo = DecodeServer(tparams, tcfg, n_slots=3, max_len=64, device="cpu")
        assert serve(solo, [(p, n)]) == [want]


def test_eos_frees_the_slot_early(model):
    jcfg, jparams, tcfg, tparams = model
    p1, p2 = prompts(2, [6, 7])
    probe = serve(DecodeServer(tparams, tcfg, n_slots=1, max_len=64, device="cpu"),
                  [(p1, 12)])[0]
    eos = probe[3]
    jsrv = JaxServer(jparams, jcfg, n_slots=1, max_len=64, eos_id=eos)
    tsrv = DecodeServer(tparams, tcfg, n_slots=1, max_len=64, eos_id=eos, device="cpu")
    traffic = [(p1, 12), (p2, 5)]
    jout, tout = serve(jsrv, traffic), serve(tsrv, traffic)
    assert tout == jout
    assert tout[0] == probe[: probe.index(eos) + 1]  # truncated at eos


def test_prompt_longer_than_the_largest_bucket(model):
    (p,) = prompts(3, [50])
    _, tsrv, (out,) = run_both(model, [(p, 6)], n_slots=1, max_len=96,
                               prompt_buckets=(8, 16, 32))
    assert len(out) == 6 and tsrv.prefill_dispatches == 2  # chunks of 32 + 18


def test_two_long_prompts_batch_through_the_prefill_window(model):
    traffic = [(p, 5) for p in prompts(4, [70, 75])]
    _, tsrv, _ = run_both(model, traffic, n_slots=2, max_len=96,
                          prompt_buckets=(8, 16, 32), prefill_budget_tokens=64)
    # Both mid chunks (0-32, 32-64) of the two prompts as one window each.
    assert tsrv.prefill_window_dispatches == 2


def test_batch1_chunks_run_eagerly_on_the_cpu(model):
    """On the CPU no chunk graph is captured: every batch-1 prompt chunk
    (a singleton mid chunk, every final chunk) runs its body eagerly and
    counts in `prefill_eager_chunks`, none in `prefill_graph_replays`. The
    serving report carries both, `merge` sums them, and the fleet
    monitor's windows leave the port's own fields out."""
    traffic = [(p, 5) for p in prompts(4, [70, 75, 40, 6])]
    _, tsrv, _ = run_both(model, traffic, n_slots=2, max_len=96,
                          prompt_buckets=(8, 16, 32), prefill_budget_tokens=64)
    assert not tsrv._prefill_graphs and tsrv.prefill_graph_replays == 0
    assert (tsrv.prefill_eager_chunks
            == tsrv.prefill_dispatches - tsrv.prefill_window_dispatches > len(traffic))
    rep = tt.collect_serving(tsrv)
    assert (rep.prefill_eager_chunks, rep.prefill_graph_replays) == (
        tsrv.prefill_eager_chunks, 0)
    merged = tt.ServingReport.merge([rep, rep])
    assert merged.prefill_eager_chunks == 2 * tsrv.prefill_eager_chunks
    assert not tt.PORT_REPORT_FIELDS & set(tt.report_counter_fields())


def test_steps_per_dispatch_4_matches_1(model):
    traffic = [(p, 11) for p in prompts(5, [4, 12])]
    _, k4, out4 = run_both(model, traffic, n_slots=2, max_len=64, steps_per_dispatch=4)
    _, k1, out1 = run_both(model, traffic, n_slots=2, max_len=64, steps_per_dispatch=1)
    assert out4 == out1
    windows = [k.macro_dispatches + k.burst_windows_run for k in (k4, k1)]
    assert windows[0] < windows[1]


def test_pool_backpressure_is_fifo(model):
    traffic = [(p, 10) for p in prompts(6, [12, 20, 6])]
    # Each request needs 3-4 blocks of 8; 7 allocatable blocks host two.
    _, tsrv, outs = run_both(model, traffic, n_slots=3, max_len=64, block_size=8,
                             total_blocks=8)
    assert [len(o) for o in outs] == [10, 10, 10]
    assert tsrv._block_mgr.counts()["in_use"] == 0


def test_shared_prefix_hit(model):
    jcfg, jparams, tcfg, tparams = model
    prefix, a, b = prompts(7, [24, 5, 6])
    results = []
    for srv in (JaxServer(jparams, jcfg, n_slots=2, max_len=64, block_size=8),
                DecodeServer(tparams, tcfg, n_slots=2, max_len=64, block_size=8,
                             device="cpu")):
        srv.start()
        try:
            first = srv.generate(prefix + a, max_new=6, timeout=300)
            second = srv.generate(prefix + b, max_new=6, timeout=300)
        finally:
            srv.stop()
        results.append((first, second, srv.prefix_hit_tokens))
    assert results[1] == results[0]
    assert results[1][2] == 24  # three full prefix blocks served from the cache
    cold = DecodeServer(tparams, tcfg, n_slots=2, max_len=64, block_size=8, device="cpu",
                        prefix_cache=False)
    assert serve(cold, [(prefix + b, 6)]) == [results[1][1]]


def test_deferred_features_raise(model):
    _, _, tcfg, tparams = model
    # Nothing of the reference's constructor or hooks is refused any more:
    # phase-disaggregated handoff is taken on both transfer hooks, and its
    # hook setter arms the export.
    store = FleetKVStore(1 << 20)
    server = DecodeServer(tparams, tcfg, device="cpu", n_slots=2, max_len=64,
                          prompt_buckets=(8, 16), block_size=8, kv_store=store)
    assert server.spill_tier.is_shared
    handed = []
    server.set_handoff_hook(handed.append)
    prompt = list(range(1, 18))
    fut = server.transfer_in_request(prompt, 4, handoff=True)
    for _ in range(50):
        if handed:
            break
        server._tick()
    # The export: one checkpoint at the first token, the prompt's two full
    # blocks in the store (the busy ticks' write-through publish may have
    # put them first), the slot released and the future handed over.
    assert len(handed) == 1 and not fut.done()
    ck = handed[0]
    assert ck.future is fut and ck.prompt == prompt and len(ck.generated) == 1
    assert server.handoff_exports == 1
    assert server.handoff_published_blocks + server.store_published_blocks == 2
    assert store.entries == 2 and not server._has_outstanding()
    assert not any(s.active for s in server._slots)
    # Disarmed, the marker is inert: the request decodes here.
    server.set_handoff_hook(None)
    inert = server.transfer_in_request(prompt, 4, handoff=True)
    # The ingest: a second engine over the same store takes the checkpoint
    # with handoff=True, counts a handoff arrival and revives the two
    # published blocks instead of recomputing them.
    dst = DecodeServer(tparams, tcfg, device="cpu", n_slots=2, max_len=64,
                       prompt_buckets=(8, 16), block_size=8, kv_store=store)
    dst.transfer_in_checkpoint(ck, handoff=True)
    for _ in range(200):
        if fut.done() and inert.done():
            break
        server._tick()
        dst._tick()
    assert dst.handoff_ingests == 1 and dst.handoff_revived_tokens == 16
    assert server.handoff_exports == 1 and server.handoff_ingests == 0
    assert fut.result(0) == inert.result(0) and len(fut.result(0)) == 4
    server.stop()
    dst.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        server.transfer_in_request(prompt, 4, handoff=True)
    # Quotas, metrics, tracing and the cost ledger construct.
    for kw in (dict(quota=QuotaPolicy({"g": TenantShare(0.5, 1.0)})), dict(metrics=Metrics()),
               dict(tracing=EngineTracing()), dict(cost_ledger=CostLedger())):
        DecodeServer(tparams, tcfg, device="cpu", **kw)
    # Surgical recovery is the default, as in the reference, and the
    # injector and the checkpoint hook are taken.
    assert DecodeServer(tparams, tcfg, device="cpu").surgical_recovery
    DecodeServer(tparams, tcfg, device="cpu", fault_injector=object(), checkpoint_hook=print)
    # radix_cache is inert without the prefix cache, as in the reference.
    assert not DecodeServer(tparams, tcfg, device="cpu", prefix_cache=False).radix_cache


def test_no_device_and_no_cuda_raises(model, monkeypatch):
    _, _, tcfg, tparams = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeServer(tparams, tcfg)


@pytest.mark.parametrize("entry", ["init_gpt", "from_numpy_params", "init_paged_cache"])
def test_entry_points_without_device_raise_without_cuda(model, monkeypatch, entry):
    """The other entry points default to CUDA and never drift to the CPU
    either (DecodeServer: the test above)."""
    _, jparams, tcfg, _ = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "init_gpt": lambda: init_gpt(tcfg),
        "from_numpy_params": lambda: from_numpy_params(
            jax.tree_util.tree_map(np.asarray, jparams), tcfg),
        "init_paged_cache": lambda: init_paged_cache(tcfg, 4, 8),
    }
    with pytest.raises(RuntimeError, match=f"{entry} runs on CUDA"):
        calls[entry]()


def test_package_imports_neither_jax_nor_nos_tpu():
    """Every module of the package, and chip_smoke.py, in a fresh process;
    `grpc` stays a deferred import of the kubelet client's constructors,
    and the tpuslice shim is neither built nor loaded by an import."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, pkgutil, importlib, nos_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(nos_tpu_torch.__path__, 'nos_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'nos_tpu_torch.runtime.faults' in sys.modules\n"
        "assert 'nos_tpu_torch.runtime.checkpoint' in sys.modules\n"
        "for m in ('runtime.quota', 'tracing', 'observability', 'telemetry',\n"
        "          'serving.accounting', 'serving.kv_store', 'serving.replica',\n"
        "          'serving.router', 'serving.drain', 'serving.supervisor',\n"
        "          'serving.disagg', 'serving.monitor', 'models.vit', 'models.checkpoint',\n"
        "          'runtime.slice_server', 'parallel.collectives', 'parallel.ring_attention',\n"
        "          'parallel.pipeline', 'parallel.moe', 'cluster.kube', 'cluster.apiserver',\n"
        "          'cluster.pod_resources_grpc', 'api.webhooks', 'runtime.mfu',\n"
        "          'tpu.packing', 'tpu.mesh', 'tpu.slice_group', 'util.leader', 'util.pod',\n"
        "          'tpulib.native_client', 'tpulib.local', 'tpulib.cloud',\n"
        "          'tpulib.cloud_server', 'config', 'system', 'sim', 'sim_oracle', 'cli',\n"
        "          'scheduler.framework', 'scheduler.scheduler', 'scheduler.plugins.capacity',\n"
        "          'scheduler.plugins.noderesources', 'scheduler.plugins.topology'):\n"
        "    assert 'nos_tpu_torch.' + m in sys.modules, m\n"
        "assert sys.modules['nos_tpu_torch.tpulib.native_client']._lib is None\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'nos_tpu' or m.startswith('nos_tpu.')\n"
        "       or m == 'grpc' or m.startswith('grpc.')]\n"
        "print(len(list(pkgutil.walk_packages(nos_tpu_torch.__path__))), bad)\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=repo)
    assert res.returncode == 0, res.stderr


def _getattr_probes(path, obj):
    """The names a module reads off `obj` with getattr(obj, "name", ...)."""
    import re

    with open(path) as f:
        return set(re.findall(r'getattr\(\s*' + obj + r',\s*"(\w+)"', f.read()))


def test_serving_plane_probes_find_every_engine_hook(model):
    """The serving plane duck-types the engine with getattr(..., None) or
    getattr(..., 0) and takes an "absent" branch when a name is missing:
    in the port none may be missing. Every engine method the reference's
    drain, replica and supervisor modules probe exists on the port's
    DecodeServer, and so does every counter `collect_serving` reads that
    the JAX engine has (the rest are the supervisor's, which it reports
    itself); the port's reads its own counters besides
    (`telemetry.PORT_REPORT_FIELDS`)."""
    jcfg, jparams, tcfg, tparams = model
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    hooks = set()
    for name in ("drain", "replica", "router", "supervisor"):
        hooks |= _getattr_probes(os.path.join(root, "nos_tpu", "serving", name + ".py"),
                                 r"(?:\w+\.)?engine")
    assert hooks == {"reopen", "_thread", "prewarm_from_store", "set_checkpoint_hook",
                     "checkpoint_snapshot", "forsake", "kv_dtype"}
    jsrv = JaxServer(jparams, jcfg)
    tsrv = DecodeServer(tparams, tcfg, device="cpu")
    for hook in hooks:
        assert hasattr(tsrv, hook), hook
        assert callable(getattr(tsrv, hook)) == callable(getattr(jsrv, hook)), hook
    read = _getattr_probes(os.path.join(root, "nos_tpu", "telemetry.py"), "server")
    # The port's `collect_serving` reads counters of its own besides.
    own = set(tt.PORT_REPORT_FIELDS)
    assert read | own == _getattr_probes(
        os.path.join(root, "nos_tpu_torch", "telemetry.py"), "server")
    for name in own:
        assert hasattr(tsrv, name) and not hasattr(jsrv, name), name
    missing = {n for n in read if hasattr(jsrv, n) and not hasattr(tsrv, n)}
    assert not missing, missing
    assert {n for n in read if not hasattr(jsrv, n)} == {
        "replica_suspects", "replica_deaths", "failovers", "failover_replay_tokens",
        "futures_failed_over", "futures_errored", "failover_latency_s"}
    for n in ("store_hits", "store_misses", "store_puts", "store_dedup_hits",
              "store_published_blocks", "prewarm_tokens", "failover_revive_tokens",
              "store_bytes", "store_entries", "handoff_exports", "handoff_ingests",
              "handoff_published_blocks", "handoff_revived_tokens"):
        assert getattr(tsrv, n) == getattr(jsrv, n) == 0, n


def test_device_gate_token_refs_and_counts_hold_under_thread_chaos():
    """Engines on one card tick from their own threads (a replica set):
    a window capture (`_DEVICE_GATE.exclusive`) never overlaps a tick
    (`shared`, reentrant), a capture inside a tick is refused, a token
    ref read from several threads materializes and counts once, and
    concurrent launch counts lose no update. Threads outnumber the cores
    and the switch interval is short, so a lost update would show."""
    import threading
    import time

    from nos_tpu_torch.ops import _build
    from nos_tpu_torch.runtime import decode_server as ds
    from nos_tpu_torch.runtime.staging import SyncLedger

    gate = ds._DeviceGate()
    lock = threading.Lock()
    inside = {"shared": 0, "exclusive": 0}
    errors = []
    ledger = SyncLedger()
    refs = [ds._TokRef(torch.arange(4, dtype=torch.int32) + i, ledger) for i in range(200)]
    launches, routes = {"k": 0}, {"k": {"r": 0}}
    n_threads = 2 * (os.cpu_count() or 4)

    captured = threading.Event()

    def ticker():
        while not captured.is_set():  # tick for as long as captures happen
            with gate.shared(), gate.shared():
                with lock:
                    inside["shared"] += 1
                    if inside["exclusive"]:
                        errors.append("a tick ran during a capture")
                time.sleep(0)
                with lock:
                    inside["shared"] -= 1

    def capturer():
        for _ in range(20):
            with gate.exclusive():
                with lock:
                    inside["exclusive"] += 1
                    if inside["shared"] or inside["exclusive"] > 1:
                        errors.append("a capture overlapped a tick or a capture")
                time.sleep(0.002)  # a capture takes a while: ticks must wait it out
                with lock:
                    inside["exclusive"] -= 1

    def reader():
        for i, ref in enumerate(refs):
            if ref.is_ready():
                assert ref.np().tolist() == [i, i + 1, i + 2, i + 3]

    def counter():
        for _ in range(1000):
            _build.count_launch(launches, routes, "k", "r")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        captures = [threading.Thread(target=capturer) for _ in range(2)]
        threads = ([threading.Thread(target=ticker) for _ in range(n_threads)]
                   + [threading.Thread(target=reader) for _ in range(n_threads)]
                   + [threading.Thread(target=counter) for _ in range(n_threads)])
        for t in threads + captures:
            t.start()
        for t in captures:
            t.join(timeout=20)
        starved = any(t.is_alive() for t in captures)  # new ticks must wait for a capture
        captured.set()
        for t in threads + captures:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads + captures)
    finally:
        sys.setswitchinterval(old)
    assert not starved and not errors, errors[:3]
    assert ledger.syncs == len(refs)
    assert launches["k"] == routes["k"]["r"] == 1000 * n_threads
    with gate.shared():
        with pytest.raises(RuntimeError, match="deadlock"):
            with gate.exclusive():
                pass


def test_prewarm_runs_every_prefill_program_and_changes_nothing(model):
    """`prewarm()` (reference decode_server.py:1378, tests/test_radix_serving.py:199)
    runs each bucket's mid chunk, final chunk and window wave on the scratch
    page before traffic: the same uploads as the JAX engine's, and the
    traffic after it serves the tokens and counters of an engine without
    it (and of the JAX engine prewarmed alike). It refuses an engine that
    is serving."""
    jcfg, jparams, tcfg, tparams = model
    kw = dict(n_slots=2, max_len=64, prompt_buckets=(8, 16, 32), block_size=8)
    prompt = [((i * 5) % 91) + 1 for i in range(24)]
    counters = DISPATCH_COUNTERS + ("h2d_uploads", "staging_syncs", "prefix_hit_blocks",
                                    "prefix_cow_hits")

    def run(server):
        outs = []
        for _ in range(2):  # cold, then a full-prefix hit
            fut = server.submit(prompt, max_new=4)
            for _ in range(400):
                if fut.done():
                    break
                server._tick()
            outs.append(fut.result(timeout=5))
        return outs, {c: getattr(server, c) for c in counters}

    jwarm = JaxServer(jparams, jcfg, **kw).prewarm()
    twarm = DecodeServer(tparams, tcfg, device="cpu", **kw).prewarm()
    assert twarm.h2d_uploads == jwarm.h2d_uploads
    assert twarm.staging_syncs == jwarm.staging_syncs
    got, want = run(twarm), run(jwarm)
    assert got == want
    plain = run(DecodeServer(tparams, tcfg, device="cpu", **kw))
    assert got[0] == plain[0] and got[0][0] == got[0][1]
    fut = twarm.submit(prompt, max_new=8)
    twarm._tick()
    with pytest.raises(RuntimeError, match="before serving"):
        twarm.prewarm()
    fut.cancel()
