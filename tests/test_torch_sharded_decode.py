"""The port's tensor-parallel DecodeServer (nos_tpu_torch/parallel,
models/decode.py::TPLocal, the sharded paged-attention ops) against its own
single-device engine and against the JAX engine, on the CPU, every engine
with its default bursts (burst_windows=4).

The port's mesh repeats one device (`devices=["cpu", "cpu"]`), as the JAX
package tests on the virtual CPU devices of tests/conftest.py. Mirrors the
cases of tests/test_sharded_decode.py that the port covers: construction
refusals and tp=1 passthrough; greedy and T=0.8 token streams of the port at
tp=2 equal to the port at tp=1 and to the JAX engine at tp=1 and tp=2, with
equal counters; the steady-state host-sync budget; the vocab-96 model whose embedding and head
shard; the param specs; TPLocal's exact collectives; and the sharded plain
attention against JAX's interpret-mode sharded kernels."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.models.gpt import init_gpt as jax_init_gpt
from nos_tpu.ops import paged_attention as jpa
from nos_tpu.parallel import sharding as jsh
from nos_tpu.parallel.mesh import build_mesh as jax_build_mesh
from nos_tpu.runtime.decode_server import DecodeServer as JaxServer
from nos_tpu_torch import DecodeServer, GPTConfig, from_numpy_params
from nos_tpu_torch.models.decode import TPLocal, init_paged_cache
from nos_tpu_torch.ops import paged_attention as tpa
from nos_tpu_torch.parallel import (build_mesh, decode_param_rules, param_partition_specs,
                                    shard_params)
from nos_tpu_torch.observability import Metrics
from nos_tpu_torch.runtime.quota import QuotaPolicy, TenantShare
from nos_tpu_torch.runtime.staging import HostStage, TickState
from nos_tpu_torch.serving import FleetKVStore

from conftest import serving_test_config, serving_test_params

pytestmark = pytest.mark.multidevice


# tests/test_sharded_decode.py's prompts: budgeted prefill runs multi-chunk.
PROMPTS = [
    [3, 11, 42, 7, 19, 5, 23, 2, 61, 13, 37, 4, 88, 29, 54, 6, 71, 9, 15, 33],
    [8, 8, 31, 4, 90, 17, 6, 44, 9, 28, 2, 95, 41, 63, 5, 12],
    [55, 1, 2, 3, 70, 70, 12, 39, 80, 10],
]
COUNTERS = ("h2d_uploads", "staging_syncs", "blocking_syncs", "macro_dispatches",
            "burst_dispatches", "burst_windows_run", "steps_run", "prefill_dispatches",
            "prefill_window_dispatches", "prefill_tokens")


def bridge(jcfg, jparams):
    tcfg = GPTConfig(**dataclasses.asdict(jcfg))
    return tcfg, from_numpy_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                   device="cpu")


@pytest.fixture(scope="module")
def model():
    jcfg, jparams = serving_test_config(), serving_test_params()
    return (jcfg, jparams) + bridge(jcfg, jparams)


@pytest.fixture(scope="module")
def mesh():
    return build_mesh({"tp": 2}, devices=["cpu", "cpu"])


@pytest.fixture(scope="module")
def jmesh():
    return jax_build_mesh({"tp": 2}, devices=jax.devices()[:2])


def make(tparams, tcfg, mesh=None, **kw):
    """The reference file's make() settings, on the port."""
    defaults = dict(n_slots=3, max_len=96, prompt_buckets=(8, 16), block_size=8,
                    steps_per_dispatch=4)
    defaults.update(kw)
    if mesh is None or mesh.shape.get("tp", 1) == 1:
        defaults["device"] = "cpu"  # a mesh places only a tensor-parallel engine
    return DecodeServer(tparams, tcfg, mesh=mesh, **defaults)


def make_jax(jparams, jcfg, mesh=None, **kw):
    defaults = dict(n_slots=3, max_len=96, prompt_buckets=(8, 16), block_size=8,
                    steps_per_dispatch=4)
    defaults.update(kw)
    return JaxServer(jparams, jcfg, mesh=mesh, **defaults)


def drive(server, reqs):
    """Deterministic driving, tick by tick on this thread (the reference
    file's drive(); the port has no fault recovery to route through)."""
    futs = [server.submit(p, max_new=n) for p, n in reqs]
    for _ in range(4000):
        if all(f.done() for f in futs):
            break
        server._tick()
    return [f.result(timeout=5) for f in futs]


# -- construction contract -------------------------------------------------------
def test_mesh_validation_and_tp1_passthrough(model, mesh):
    jcfg, jparams, tcfg, tparams = model
    with pytest.raises(ValueError, match="no 'model' axis"):
        make(tparams, tcfg, mesh=mesh, tp_axis="model")
    wide = build_mesh({"tp": 8}, devices=["cpu"] * 8)  # heads=4 on an 8-wide axis
    with pytest.raises(ValueError, match="must divide"):
        make(tparams, tcfg, mesh=wide)
    fused = dataclasses.replace(tcfg, fuse_projections=True)
    with pytest.raises(ValueError, match="fuse_projections"):
        DecodeServer(tparams, fused, mesh=mesh, n_slots=2, max_len=64, prompt_buckets=(8,))
    one = build_mesh({"tp": 1}, devices=["cpu"])
    server = make(tparams, tcfg, mesh=one)
    assert server.tp == 1 and server._mesh is None and server._tp is None
    assert server._param_specs is None and isinstance(server.params, dict)
    sharded = make(tparams, tcfg, mesh=mesh)
    assert sharded.tp == 2 and sharded._mesh is mesh and sharded._tp.tp == 2
    assert len(sharded.params) == 2 and len(sharded.cache) == 2
    # The 97-token vocabulary does not divide: embedding and head replicate.
    assert not sharded._tp.emb_sharded and not sharded._tp.head_sharded


@pytest.mark.parametrize("case", ["kv_store", "quota+metrics"])
def test_deferred_features_with_a_mesh_raise(model, mesh, case):
    """At tp=2 the fleet KV store constructs and publishes full-width
    payloads, and a phase-disaggregated handoff exports (the checkpoint at
    the first token, the prompt's full blocks in the store at full width);
    quotas and metrics construct and serve."""
    _, _, tcfg, tparams = model
    if case == "kv_store":
        store = FleetKVStore(1 << 24)
        server = make(tparams, tcfg, mesh=mesh, kv_store=store)
        handed = []
        server.set_handoff_hook(handed.append)
        exported = server.transfer_in_request(PROMPTS[0], 8, handoff=True)
        for _ in range(100):
            if handed:
                break
            server._tick()
        assert [ck.future for ck in handed] == [exported] and len(handed[0].generated) == 1
        assert server.handoff_exports == 1 and store.entries == len(PROMPTS[0]) // 8
        server.set_handoff_hook(None)
        fut = server.submit(PROMPTS[0], max_new=8)
        for _ in range(400):
            if fut.done():
                break
            server._tick()
        assert len(fut.result(timeout=5)) == 8
        for _ in range(4):
            server._tick()  # the idle sweep publishes the cached blocks
        assert server.store_published_blocks > 0 and store.entries > 0
        assert store.host_bytes == store.entries * server._bytes_per_block
        return
    registry = Metrics()
    server = make(tparams, tcfg, mesh=mesh, metrics=registry,
                  quota=QuotaPolicy({"g": TenantShare(0.5, 1.0)}, window_ticks=16))
    fut = server.submit(PROMPTS[0], max_new=8, tenant="g")
    for _ in range(400):
        if fut.done():
            break
        server._tick()
    assert len(fut.result(timeout=5)) == 8
    assert server.tokens_by_tenant["g"] == 7  # the first token is the prefill's
    assert registry.get("nos_tpu_decode_tp_devices") == 2
    assert server._quota.ticks > 0


def test_device_must_be_the_first_shard(model, mesh):
    _, _, tcfg, tparams = model
    with pytest.raises(ValueError, match="first shard device"):
        DecodeServer(tparams, tcfg, mesh=mesh, device="meta")


# -- exactness ----------------------------------------------------------------------
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_sharded_outputs_identical_greedy_and_temperature(model, mesh, jmesh, temperature):
    """Multi-chunk budgeted prefill and K=4 macro decode: the port at tp=2
    reproduces the port at tp=1 and the JAX engine at tp=1 and tp=2 token for
    token, and its counters equal tp=1's on the same traffic."""
    jcfg, jparams, tcfg, tparams = model
    reqs = [(p, 18 + 5 * i) for i, p in enumerate(PROMPTS)]
    ref = make(tparams, tcfg, temperature=temperature)
    outs_ref = drive(ref, reqs)
    shd = make(tparams, tcfg, mesh=mesh, temperature=temperature)
    assert drive(shd, reqs) == outs_ref
    assert drive(make_jax(jparams, jcfg, temperature=temperature), reqs) == outs_ref
    assert drive(make_jax(jparams, jcfg, mesh=jmesh, temperature=temperature),
                 reqs) == outs_ref
    assert {c: getattr(shd, c) for c in COUNTERS} == {c: getattr(ref, c) for c in COUNTERS}
    assert shd.macro_dispatches > 0 and shd.prefill_dispatches > len(PROMPTS)
    assert shd.burst_dispatches > 0


def test_sharded_prefill_window_and_eos(model, mesh):
    """Two long prompts batch through the multi-slot window wave, and an eos
    ends a stream early, both at tp=2 exactly as at tp=1."""
    _, _, tcfg, tparams = model
    rng = np.random.RandomState(4)
    reqs = [(rng.randint(1, 97, size=n).tolist(), 9) for n in (40, 45)]
    kw = dict(n_slots=2, prompt_buckets=(8, 16), prefill_budget_tokens=32)
    ref = make(tparams, tcfg, **kw)
    outs = drive(ref, reqs)
    shd = make(tparams, tcfg, mesh=mesh, **kw)
    assert drive(shd, reqs) == outs
    assert shd.prefill_window_dispatches == ref.prefill_window_dispatches > 0
    eos = outs[0][3]
    want = drive(make(tparams, tcfg, eos_id=eos, **kw), reqs)
    assert drive(make(tparams, tcfg, mesh=mesh, eos_id=eos, **kw), reqs) == want
    assert want[0] == outs[0][:4]


# -- host-sync budget -------------------------------------------------------------
def test_steady_state_budget_identical_to_tp1(model, mesh):
    """The reference's steady-state budget test: once every slot decodes,
    the first burst costs at most one packed sync (and its one upload),
    later bursts zero uploads and zero blocking reads, and every delta
    equals the tp=1 engine's on identical traffic."""
    _, _, tcfg, tparams = model

    def steady_deltas(mesh_arg):
        server = make(tparams, tcfg, mesh=mesh_arg, steps_per_dispatch=2)
        futs = [server.submit(p, max_new=40) for p in PROMPTS]
        for _ in range(50):
            server._tick()
            if all(s.active and s.phase == "decoding" for s in server._slots) \
                    and not server._waiting and server._queue.empty():
                break
        marks = []
        names = ("h2d_uploads", "staging_syncs", "blocking_syncs", "burst_dispatches")
        for _ in range(3):
            before = [getattr(server, n) for n in names]
            server._tick()
            marks.append(tuple(getattr(server, n) - b for n, b in zip(names, before)))
        for f in futs:
            f.cancel()
        server.stop()
        return marks

    tp1, tp2 = steady_deltas(None), steady_deltas(mesh)
    assert tp2 == tp1
    uploads, syncs, blocking, bursts = tp2[0]
    assert bursts == 1 and syncs <= 1 and uploads == syncs
    for mark in tp2[1:]:
        assert mark == (0, 0, 0, 1)


def test_vocab_sharded_embedding_and_head_identical(mesh, jmesh):
    """vocab=96 divides the axis: tok_emb shards on vocab rows (lookup plus
    zeros, summed) and lm_head on vocab columns (local f32 logits,
    gathered). The whole engine at tp=2 equals tp=1 and the JAX engine."""
    jcfg96 = dataclasses.replace(serving_test_config(), vocab=96)
    jparams96 = jax_init_gpt(jax.random.PRNGKey(0), jcfg96)
    tcfg96, tparams96 = bridge(jcfg96, jparams96)
    reqs = [([3, 11, 42, 7, 19, 5, 23, 2], 10)]
    kw = dict(n_slots=2, max_len=64, prompt_buckets=(8,), block_size=8, steps_per_dispatch=1)
    out1 = drive(make(tparams96, tcfg96, **kw), reqs)
    s2 = make(tparams96, tcfg96, mesh=mesh, **kw)
    assert drive(s2, reqs) == out1
    assert s2._tp.emb_sharded and s2._tp.head_sharded
    assert drive(make_jax(jparams96, jcfg96, **kw), reqs) == out1
    assert drive(make_jax(jparams96, jcfg96, mesh=jmesh, **kw), reqs) == out1


# -- params, mesh and pool ----------------------------------------------------------
@pytest.mark.parametrize("vocab", [97, 96])
def test_param_specs_and_shards_match_jax(mesh, jmesh, vocab):
    """The spec of every path equals JAX's PartitionSpec (97 falls back to
    replicated tok_emb and lm_head); each shard holds its contiguous slice
    and the slices concatenate back to the leaf; replicated leaves are one
    tensor for shards that share a device."""
    jcfg = dataclasses.replace(serving_test_config(), vocab=vocab)
    jparams = jax_init_gpt(jax.random.PRNGKey(1), jcfg)
    _, tparams = bridge(jcfg, jparams)
    rules = decode_param_rules("tp")
    jspecs = jsh.param_partition_specs(jparams, jmesh, jsh.decode_param_rules("tp"))
    specs = param_partition_specs(tparams, mesh, rules)
    flat = dict(jax.tree_util.tree_leaves_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    assert len(flat) == 3 + 9 * jcfg.layers
    for path, jspec in flat.items():
        node = specs
        for key in path:
            node = node[key.key]
        assert node == tuple(jspec), path
    sharded = vocab % 2 == 0
    assert (specs["tok_emb"] != ()) == sharded and (specs["lm_head"] != ()) == sharded
    shards = shard_params(tparams, mesh, rules)
    assert len(shards) == 2
    for name, dim in (("tok_emb", 0), ("lm_head", 1)):
        parts = [s[name] for s in shards]
        if sharded:
            assert all(p.is_contiguous() for p in parts)
            assert torch.equal(torch.cat(parts, dim), tparams[name])
        else:
            assert parts[0] is parts[1] and torch.equal(parts[0], tparams[name])
    layer = [s["layers"]["0"] for s in shards]
    assert layer[0]["wq"].shape == (32, 16)
    assert torch.equal(torch.cat([p["w_down"] for p in layer], 1),
                       tparams["layers"]["0"]["w_down"])
    assert layer[0]["ln1"]["scale"] is layer[1]["ln1"]["scale"]


def test_build_mesh_axes_and_errors():
    m = build_mesh({"dp": -1, "tp": 2}, devices=["cpu"] * 4)
    assert m.shape == {"dp": 2, "tp": 2} and m.axis_names == ("dp", "tp")
    assert m.devices == [torch.device("cpu")] * 4
    assert m.axis_devices("tp") == [torch.device("cpu")] * 2
    assert build_mesh(devices=["cpu"] * 3).shape == {"dp": 3}
    assert len(build_mesh({"tp": 2}, devices=["cpu"] * 3).devices) == 2  # a prefix
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        build_mesh({"tp": 4}, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="at most one axis size may be -1"):
        build_mesh({"dp": -1, "tp": -1}, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="cannot infer"):
        build_mesh({"dp": -1, "tp": 3}, devices=["cpu"] * 4)


def test_build_mesh_without_devices_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="build_mesh runs on CUDA"):
        build_mesh({"tp": 2})


def test_init_paged_cache_partitions_kv_heads(model, mesh):
    _, _, tcfg, _ = model
    pool = init_paged_cache(tcfg, 5, 8, mesh=mesh)
    assert isinstance(pool, list) and len(pool) == 2
    for shard in pool:
        assert set(shard) == {"0", "1"}
        assert shard["0"]["k"].shape == (5, tcfg.n_kv // 2, 8, tcfg.head_dim)
        assert shard["0"]["k"].device == torch.device("cpu")
    one = init_paged_cache(tcfg, 5, 8, mesh=build_mesh({"tp": 1}, devices=["cpu"]),
                           device="cpu")
    assert one["0"]["v"].shape == (5, tcfg.n_kv, 8, tcfg.head_dim)


def test_tick_state_one_upload_per_sync_on_a_mesh(mesh):
    stage = HostStage("cpu")
    st = TickState(stage, 3, 4, mesh=mesh)
    packed = np.arange(3 * 9, dtype=np.int32).reshape(3, 9)
    st.sync(packed)
    assert stage.uploads == 1 and st.syncs == 1
    assert len(st.tables) == 2 and st.tables[0] is st.table and st.tables[1] is st.table
    assert torch.equal(st.table, torch.from_numpy(packed[:, :4]))


# -- TPLocal: the collectives are exact -----------------------------------------------
def test_tplocal_gather_embed_head_exact(model):
    _, _, tcfg, _ = model
    cfg = dataclasses.replace(tcfg, vocab=96)
    tp = TPLocal(cfg, ["cpu", "cpu"], emb_sharded=True, head_sharded=True)
    assert tp.lcfg.heads == 2 and tp.lcfg.n_kv == 1 and tp.lcfg.hidden == 16
    g = torch.Generator().manual_seed(0)
    parts = [torch.randn(2, 3, 5, generator=g, dtype=torch.bfloat16) for _ in range(2)]
    got = tp.gather(parts)
    assert len(got) == 2 and got[0] is got[1] and got[0].dtype == torch.bfloat16
    assert torch.equal(got[0], torch.cat(parts, -1))
    emb = torch.randn(96, 32, generator=g)
    head = torch.randn(32, 96, generator=g)
    params = [{"tok_emb": emb[:48].contiguous(), "lm_head": head[:, :48].contiguous()},
              {"tok_emb": emb[48:].contiguous(), "lm_head": head[:, 48:].contiguous()}]
    tokens = torch.tensor([[0, 47, 48, 95], [5, 60, 1, 90]], dtype=torch.int32)
    x = tp.embed(params, tokens)
    assert torch.equal(x[0], emb[tokens.long()]) and x[0] is x[1]
    h = torch.randn(2, 4, 32, generator=g)
    logits = tp.head([h, h], [p["lm_head"] for p in params])
    assert logits.dtype == torch.float32 and torch.equal(logits, (h @ head).float())
    rep = TPLocal(cfg, ["cpu", "cpu"], emb_sharded=False, head_sharded=False)
    full = [{"tok_emb": emb, "lm_head": head}] * 2
    assert torch.equal(rep.embed(full, tokens)[1], emb[tokens.long()])
    assert torch.equal(rep.head([h, h], [head, head]), (h @ head).float())


# -- the sharded attention against JAX's interpret-mode sharded kernels --------------
def _split(x, axis=1):
    half = x.shape[axis] // 2
    return [t.contiguous() for t in torch.split(torch.from_numpy(np.array(x)), half, axis)]


def test_sharded_window_plain_matches_jax_interpret(jmesh):
    from tests.test_paged_attention import make_window_case

    args = make_window_case(0, 4, 8, 4, 32, 16, 4, 24, 5)
    want = jpa._window_pallas_sharded(*args, mesh=jmesh, tp_axis="tp", interpret=True)
    q, pk, pv = (_split(a) for a in args[:3])
    table, pos, lengths, mask = (torch.from_numpy(np.array(a)) for a in args[3:])
    out = tpa.paged_window_attention_sharded(q, pk, pv, table, pos, lengths, mask)
    assert len(out) == 2 and out[0].shape == (4, 4, 5, 32)
    np.testing.assert_allclose(torch.cat(out, 1).numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_sharded_decode_plain_matches_jax_interpret(jmesh):
    rng = np.random.RandomState(3)
    b, nh, nkv, hd, bs, n_pages, total = 4, 8, 4, 32, 16, 4, 24
    q = rng.randn(b, nh, hd).astype(np.float32)
    pk = rng.randn(total, nkv, bs, hd).astype(np.float32)
    pv = rng.randn(total, nkv, bs, hd).astype(np.float32)
    table = rng.randint(1, total, size=(b, n_pages)).astype(np.int32)
    limit = rng.randint(1, n_pages * bs, size=b).astype(np.int32)
    want = jpa._pallas_sharded(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                               jnp.asarray(table), jnp.asarray(limit), mesh=jmesh,
                               tp_axis="tp", interpret=True)
    out = tpa.paged_decode_attention_sharded(
        _split(q), _split(pk), _split(pv), torch.from_numpy(table),
        [torch.from_numpy(limit)] * 2)
    np.testing.assert_allclose(torch.cat(out, 1).numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    # Per head, the sharded op is the unsharded op on the same heads.
    whole = tpa.paged_decode_attention(torch.from_numpy(q), torch.from_numpy(pk),
                                       torch.from_numpy(pv), torch.from_numpy(table),
                                       torch.from_numpy(limit))
    assert torch.equal(torch.cat(out, 1), whole)
