"""The port's radix cache and host spill tier (nos_tpu_torch/runtime/
decode_server.py: `_extract_block`/`_revive`/`_cow_copy`, the revive and COW
pumps, output registration) against the JAX DecodeServer on the CPU.

Both engines serve the shared float32 test model with their defaults
(`radix_cache=True`, `spill_blocks=None`) on tests/test_radix_serving.py's
traffic: a mid-block-diverging prompt (COW), a multi-turn re-admission, and
a pool of 1 + 6 blocks that spills a cached path and revives it. Tokens
must be EQUAL (no tolerance), greedy and T=0.8, and every radix and spill
counter equal to the reference's; the flat-chain and cold arms of the port
give the same tokens. The same cases at tp=2 (one controller, two CPU
shards) against the JAX engine's outputs, and a payload at tp=2 byte for
byte the payload at tp=1."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from nos_tpu.runtime.decode_server import DecodeServer as JaxServer
from nos_tpu_torch import DecodeServer, GPTConfig, from_numpy_params
from nos_tpu_torch.parallel import build_mesh

from conftest import serving_test_config, serving_test_params

ENGINE = dict(n_slots=2, max_len=64, prompt_buckets=(8, 16), block_size=8, seed=11)
COUNTERS = ("prefix_lookups", "prefix_hit_blocks", "prefix_hit_tokens", "prefix_evictions",
            "prefix_cow_hits", "prefix_cow_tokens", "output_blocks_registered",
            "radix_nodes", "spills", "revives", "spill_drops", "spill_host_bytes",
            "prefill_tokens", "prefill_dispatches", "steps_run", "h2d_uploads",
            "blocking_syncs")

DONOR = [((i * 5) % 91) + 1 for i in range(24)]  # 3 full blocks of 8
DIV = DONOR[:12] + [((i * 7) % 91) + 2 for i in range(12)]  # diverges mid-block 1
SPILL_DONOR = DONOR + [77, 78, 79, 80]
FILLER = [((i * 11) % 91) + 3 for i in range(28)]


@pytest.fixture(scope="module")
def model():
    jcfg, jparams = serving_test_config(), serving_test_params()
    tcfg = GPTConfig(**dataclasses.asdict(jcfg))
    tparams = from_numpy_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def mesh():
    return build_mesh({"tp": 2}, devices=["cpu", "cpu"])


def port(model, mesh=None, **kw):
    _, _, tcfg, tparams = model
    kw = dict(ENGINE, **kw)
    if mesh is None:
        kw["device"] = "cpu"
    return DecodeServer(tparams, tcfg, mesh=mesh, **kw)


def ref(model, **kw):
    jcfg, jparams, _, _ = model
    return JaxServer(jparams, jcfg, **dict(ENGINE, **kw))


def run_seq(server, reqs):
    """Serve `reqs` strictly in order: serials (and T>0 streams) align."""
    outs = []
    server.start()
    try:
        for p, n in reqs:
            outs.append(server.generate(p, max_new=n, timeout=300))
    finally:
        server.stop()
    return outs


def multi_turn(server):
    """Turn 2 re-submits turn 1's prompt, its output and three new tokens."""
    turn1 = DONOR[:20]
    server.start()
    try:
        out1 = server.generate(turn1, max_new=12, timeout=300)
        out2 = server.generate(turn1 + out1 + [33, 44, 55], max_new=8, timeout=300)
    finally:
        server.stop()
    return [out1, out2]


def counters(server):
    return {c: getattr(server, c) for c in COUNTERS}


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_midblock_cow_equals_jax_and_cold(model, temperature):
    reqs = [(DONOR, 6), (DIV, 6)]
    jsrv = ref(model, temperature=temperature)
    want = run_seq(jsrv, reqs)
    tree = port(model, temperature=temperature)
    assert run_seq(tree, reqs) == want
    assert counters(tree) == counters(jsrv)
    assert tree.prefix_cow_hits >= 1 and tree.prefix_cow_tokens >= 1
    assert tree.prefix_keys() == jsrv.prefix_keys()
    assert run_seq(port(model, radix_cache=False, temperature=temperature), reqs) == want
    assert run_seq(port(model, prefix_cache=False, temperature=temperature), reqs) == want


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_multi_turn_readmission_equals_jax_and_cold(model, temperature):
    jsrv = ref(model, temperature=temperature)
    want = multi_turn(jsrv)
    tree = port(model, temperature=temperature)
    assert multi_turn(tree) == want
    assert counters(tree) == counters(jsrv)
    chain = port(model, radix_cache=False, temperature=temperature)
    assert multi_turn(chain) == want
    assert multi_turn(port(model, prefix_cache=False, temperature=temperature)) == want
    # Turn 2 walked the registered output blocks: less prefill than the chain.
    assert tree.output_blocks_registered > 0
    assert tree.prefill_tokens < chain.prefill_tokens


def test_spilled_subtree_revive_equals_jax_and_cold(model):
    reqs = [(SPILL_DONOR, 4), (FILLER, 4), (SPILL_DONOR, 4), (DIV, 4)]
    tight = dict(total_blocks=1 + 6, n_slots=1)
    jsrv = ref(model, **tight)
    want = run_seq(jsrv, reqs)
    tree = port(model, **tight)
    assert run_seq(tree, reqs) == want
    assert counters(tree) == counters(jsrv)
    assert tree.spills > 0 and tree.revives > 0
    assert run_seq(port(model, prefix_cache=False, **tight), reqs) == want
    # Without the tier the evicted path is recomputed: same tokens, more prefill.
    off = port(model, spill_blocks=0, **tight)
    assert run_seq(off, reqs) == want
    assert off.spills == 0 and off.prefill_tokens > tree.prefill_tokens


def test_radix_counters_and_defaults(model):
    """The reference's defaults, and the counters read through to the
    BlockManager and the tier (equal to the JAX engine's on COW traffic)."""
    tree = port(model)
    assert tree.radix_cache and tree.spill_tier is not None
    assert tree.spill_tier.capacity_bytes == tree.total_blocks * tree._bytes_per_block
    jsrv = ref(model)
    reqs = [(DONOR, 6), (DIV, 6), (DONOR[:20], 6)]
    assert run_seq(tree, reqs) == run_seq(jsrv, reqs)
    assert counters(tree) == counters(jsrv)
    assert tree.radix_nodes > 0 and tree.prefix_lookups == 3
    flat = port(model, radix_cache=False)
    run_seq(flat, reqs)
    assert flat.radix_nodes == 0 and flat.prefix_cow_hits == 0
    assert flat.output_blocks_registered == 0


def test_copies_write_the_pool_in_place(model):
    """`_extract_block` then `_revive` round-trips a block exactly; `_cow_copy`
    copies exactly the first `length` rows and reads its source only; no
    pool tensor is rebound (the captured window holds their addresses)."""
    server = port(model, total_blocks=8)
    gen = torch.Generator().manual_seed(0)
    for layer in server.cache.values():
        for t in layer.values():
            t.copy_(torch.randn(t.shape, generator=gen))
    ptrs = [t.data_ptr() for layer in server.cache.values() for t in layer.values()]
    before = {i: {n: t.clone() for n, t in layer.items()} for i, layer in server.cache.items()}
    (k, v), nbytes = server._extract_block(3)
    assert nbytes == server._bytes_per_block and server.blocking_syncs == 1
    assert server._dispatch_revive((k, v), 5) and server.h2d_uploads == 2
    server._cow_copy(2, 6, 5)
    for i, layer in server.cache.items():
        for n, t in layer.items():
            old = before[i][n]
            assert torch.equal(t[5], old[3]) and torch.equal(t[5], (k if n == "k" else v)[int(i)])
            assert torch.equal(t[6, :, :5], old[2, :, :5])
            assert torch.equal(t[6, :, 5:], old[6, :, 5:])
            assert torch.equal(t[2], old[2])
            rest = [b for b in range(8) if b not in (5, 6)]
            assert torch.equal(t[rest], old[rest])
    assert ptrs == [t.data_ptr() for layer in server.cache.values() for t in layer.values()]
    assert not server._dispatch_revive(("int8", k, v, None, None), 5)
    assert server.kv_quant_payload_rejected == 1


@pytest.mark.multidevice
def test_payload_at_tp2_equals_tp1(model, mesh):
    """The copy-out gathers the KV-head shards: after the same traffic a
    block's payload at tp=2 is byte for byte its payload at tp=1, and a
    revive slices it back so both shards' pages equal tp=1's."""
    reqs = [(DONOR, 6)]
    one, two = port(model), port(model, mesh=mesh)
    assert run_seq(one, reqs) == run_seq(two, reqs)
    for block in range(1, 5):
        (k1, v1), n1 = one._extract_block(block)
        (k2, v2), n2 = two._extract_block(block)
        assert n1 == n2 and torch.equal(k1, k2) and torch.equal(v1, v2)
    two._dispatch_revive(one._extract_block(2)[0], 7)
    for s, pool in enumerate(two.cache):
        for i, layer in pool.items():
            assert torch.equal(layer["k"][7], one.cache[i]["k"][2][s:s + 1])
            assert torch.equal(layer["v"][7], one.cache[i]["v"][2][s:s + 1])


@pytest.mark.multidevice
@pytest.mark.parametrize("case", ["cow", "multi_turn", "spill"])
def test_tp2_equals_jax(model, mesh, case):
    """COW, multi-turn and spilled revive at tp=2 give the JAX engine's
    tokens, with its radix and spill counters."""
    tight = dict(total_blocks=1 + 6, n_slots=1) if case == "spill" else {}
    jsrv, shd = ref(model, **tight), port(model, mesh=mesh, **tight)
    if case == "multi_turn":
        assert multi_turn(shd) == multi_turn(jsrv)
    else:
        reqs = ([(DONOR, 6), (DIV, 6)] if case == "cow"
                else [(SPILL_DONOR, 4), (FILLER, 4), (SPILL_DONOR, 4), (DIV, 4)])
        assert run_seq(shd, reqs) == run_seq(jsrv, reqs)
    assert counters(shd) == counters(jsrv)
    engaged = {"cow": shd.prefix_cow_hits, "multi_turn": shd.output_blocks_registered,
               "spill": shd.revives}
    assert engaged[case] > 0


def test_engine_is_freed_without_the_cycle_collector(model):
    """The spill tier's reader does not tie the manager to the engine: a
    stopped engine, and its pool, go as soon as the last reference does."""
    import gc
    import weakref

    server = port(model, total_blocks=1 + 6, n_slots=1)
    assert run_seq(server, [(SPILL_DONOR, 4), (FILLER, 4)]) and server.spills > 0
    ref_ = weakref.ref(server)
    gc.disable()
    try:
        del server
        assert ref_() is None
    finally:
        gc.enable()
