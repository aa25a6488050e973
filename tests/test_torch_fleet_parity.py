"""The harness of the port's serving-plane parity tests
(test_torch_kv_store.py, test_torch_serving_cluster.py,
test_torch_supervisor.py): one scenario, written once against a `Side`,
runs on the JAX package and on the port, and the two sides' observations
must be equal. Its own tests hold the serving plane's wire constants of
the two packages equal, value for value.

A `Side` bundles one package's engine, serving plane, telemetry, faults
and constants, with the shared float32 test model (the JAX init carried
across to the port with `from_numpy_params`). Its engines take the
reference tests' defaults; the port's run on the CPU (`device="cpu"`, or
a mesh that repeats the CPU for tp=2, as the JAX side's virtual CPU
devices do)."""

import dataclasses
import signal
import types

import jax
import numpy as np
import pytest

from conftest import serving_test_config, serving_test_params

# The reference tests' engine (tests/test_kv_store.py:63,
# test_serving_cluster.py:44, test_supervisor.py:554).
ENGINE = dict(n_slots=2, max_len=64, prompt_buckets=(8, 16), block_size=8, seed=11)


def _jax_side():
    from nos_tpu import constants, observability, telemetry
    from nos_tpu.observability import Metrics
    from nos_tpu.parallel.mesh import build_mesh
    from nos_tpu.runtime import block_manager, checkpoint, faults, quota, radix_tree
    from nos_tpu.runtime.decode_server import DecodeServer
    from nos_tpu.runtime.spill import SpillTier
    from nos_tpu.serving import (accounting, disagg, drain, kv_store, monitor, replica, router,
                                 supervisor)
    from nos_tpu.tracing import EngineTracing, FlightRecorder, Tracer

    cfg, params = serving_test_config(), serving_test_params()
    return types.SimpleNamespace(
        name="jax", cfg=cfg, params=params, device={}, DecodeServer=DecodeServer,
        constants=constants, telemetry=telemetry, Metrics=Metrics, faults=faults,
        checkpoint=checkpoint, quota=quota, radix_tree=radix_tree,
        block_manager=block_manager, SpillTier=SpillTier, kv_store=kv_store,
        replica=replica, router=router, drain=drain, supervisor=supervisor,
        CostLedger=accounting.CostLedger, EngineTracing=EngineTracing, Tracer=Tracer,
        accounting=accounting, disagg=disagg, monitor=monitor, observability=observability,
        FlightRecorder=FlightRecorder,
        mesh2=lambda: build_mesh({"tp": 2}, devices=jax.devices()[:2]))


def _torch_side():
    from nos_tpu_torch import GPTConfig, constants, from_numpy_params, observability, telemetry
    from nos_tpu_torch.observability import Metrics
    from nos_tpu_torch.parallel import build_mesh
    from nos_tpu_torch.runtime import block_manager, checkpoint, faults, quota, radix_tree
    from nos_tpu_torch.runtime.decode_server import DecodeServer
    from nos_tpu_torch.runtime.spill import SpillTier
    from nos_tpu_torch.serving import (accounting, disagg, drain, kv_store, monitor, replica,
                                       router, supervisor)
    from nos_tpu_torch.tracing import EngineTracing, FlightRecorder, Tracer

    jcfg = serving_test_config()
    cfg = GPTConfig(**dataclasses.asdict(jcfg))
    params = from_numpy_params(jax.tree_util.tree_map(np.asarray, serving_test_params()),
                               cfg, device="cpu")
    return types.SimpleNamespace(
        name="torch", cfg=cfg, params=params, device={"device": "cpu"},
        DecodeServer=DecodeServer, constants=constants, telemetry=telemetry,
        Metrics=Metrics, faults=faults, checkpoint=checkpoint, quota=quota,
        radix_tree=radix_tree, block_manager=block_manager, SpillTier=SpillTier,
        kv_store=kv_store, replica=replica, router=router, drain=drain,
        supervisor=supervisor, CostLedger=accounting.CostLedger,
        EngineTracing=EngineTracing, Tracer=Tracer, accounting=accounting, disagg=disagg,
        monitor=monitor, observability=observability, FlightRecorder=FlightRecorder,
        mesh2=lambda: build_mesh({"tp": 2}, devices=["cpu", "cpu"]))


def time_limit(seconds):
    """An autouse fixture that fails a test still running after `seconds`
    (SIGALRM raises in the test's thread), so a hung engine thread, server
    or wait ends its test instead of the run. A module takes it with
    `_time_limit = time_limit(n)`."""

    @pytest.fixture(autouse=True)
    def _time_limit():
        def expire(signum, frame):
            raise TimeoutError(f"test still running after {seconds} s")

        old = signal.signal(signal.SIGALRM, expire)
        signal.setitimer(signal.ITIMER_REAL, seconds)
        try:
            yield
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, old)

    return _time_limit


def sides():
    """(JAX side, port side)."""
    return _jax_side(), _torch_side()


def engine(side, store=None, mesh=None, **kw):
    """One engine of `side` at the reference tests' defaults."""
    args = dict(ENGINE)
    args.update(kw)
    place = {} if mesh is not None else side.device
    return side.DecodeServer(side.params, side.cfg, kv_store=store, mesh=mesh, **args, **place)


def fleet(side, n, store=None, **kw):
    return side.replica.ReplicaSet([engine(side, store=store, **kw) for _ in range(n)])


def counters(side, server):
    """Every counter field of the engine's `collect_serving` report and its
    integer gauges (the pool's byte size aside), the store's included."""
    rep = side.telemetry.collect_serving(server)
    names = side.telemetry.report_counter_fields() + tuple(
        sorted(side.telemetry.REPORT_GAUGE_FIELDS - {"kv_pool_bytes"}))
    return {n: getattr(rep, n) for n in names}


def store_state(store):
    return {"entries": store.entries, "host_bytes": store.host_bytes,
            "pinned": store.pinned_entries, "puts": store.puts,
            "dedup_hits": store.dedup_hits, "hits": store.hits, "misses": store.misses,
            "drops": store.drops, "keys": sorted(store.keys())}


def report(obj, drop=("latency_s",)):
    """A DrainReport or FailoverReport as a dict, wall-clock fields aside."""
    return {k: v for k, v in dataclasses.asdict(obj).items() if k not in drop}


def twin(both, scenario):
    """Run `scenario(side)` on the JAX side, then on the port's; the two
    observations must be equal. Returns the port's."""
    jside, tside = both
    want = scenario(jside)
    got = scenario(tside)
    assert got == want
    return got


def run(server, prompts, max_new=4, tenant=None, idle_ticks=6, n=2000):
    """tests/test_kv_store.py:72: drive to completion, then a few idle ticks
    so the idle publish sweep pushes the cache into the store."""
    futs = [server.submit(p, max_new=max_new, tenant=tenant) for p in prompts]
    for _ in range(n):
        if all(f.done() for f in futs):
            break
        server._tick()
    outs = [f.result(timeout=5) for f in futs]
    for _ in range(idle_ticks):
        server._tick()
    return outs


def settle(rs):
    """Wait until every token vector the replicas' slots hold is computed,
    without reading it. JAX dispatches asynchronously even on the CPU, so
    which of its refs `is_ready()` when the supervisor's passive
    `checkpoint_snapshot` runs depends on timing; the port's CPU refs are
    ready at once. Settling first makes the snapshot, and with it the
    failover's replay, the same on both sides."""
    for h in rs.handles:
        for slot in h.engine._slots:
            for ref, _, _ in slot.refs:
                arr = getattr(ref, "_arr", None)
                if hasattr(arr, "block_until_ready"):
                    arr.block_until_ready()


def probe(rs, sup):
    """One supervisor sweep over a settled fleet."""
    settle(rs)
    return sup.probe()


def drive_fleet(side, rs, pred, n=600, downed=(), sup=None):
    """One tick per active, unstarted, live replica a wave (a downed host
    is simply no longer ticked), then a supervisor sweep if one is given."""
    for _ in range(n):
        for h in rs.handles:
            if (h.state == side.constants.REPLICA_STATE_ACTIVE
                    and h.replica_id not in downed and h.engine._thread is None):
                h.engine._tick()
        if sup is not None:
            probe(rs, sup)
        if pred():
            return True
    return False


FLEET_CONSTANTS = ("REPLICA_", "PROBE_KEY_", "ROUTER_", "FLEET_EV", "SLO_EV_", "PRESSURE_",
                   "ACCT_KEY_", "WASTE_", "DEBUG_PATH_", "METRICS_CONTENT_TYPE")


def test_wire_constants_equal_the_jax_packages():
    """Every constant of the port's `constants.py` has the reference's
    value (a replica id, state or probe key spelled otherwise would not be
    the same protocol), and every serving-plane constant of the reference
    is in the port: the monitor's verdicts, the utilization plane's keys
    and waste causes and the debug HTTP paths included."""
    from nos_tpu import constants as jc
    from nos_tpu_torch import constants as tc

    names = [n for n in dir(tc) if n.isupper()]
    assert names and all(getattr(tc, n) == getattr(jc, n) for n in names), [
        n for n in names if getattr(tc, n) != getattr(jc, n)]
    fleet = {n for n in dir(jc) if n.isupper() and n.startswith(FLEET_CONSTANTS)}
    assert "FLEET_EVENTS" in fleet and "REPLICA_ROLES" in fleet
    assert {"PRESSURE_TENANT_STATES", "WASTE_CAUSES", "DEBUG_PATH_INDEX",
            "METRICS_CONTENT_TYPE"} <= fleet
    assert fleet <= set(names), sorted(fleet - set(names))
