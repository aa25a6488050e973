"""The port's speculative decoding (nos_tpu_torch/models/speculative.py,
`paged_verify_window`, the engine's verify rounds) against the JAX package's,
on the CPU.

The host pieces (`find_prompt_lookup_draft`, `_LookupIndex`, `accept_prefix`,
`AdaptiveSpec`) must return the reference's values on seeded inputs;
`speculative_generate` and the engines must return EQUAL tokens (no
tolerance) with equal round and acceptance counts. The engines run
tests/test_spec_tree_drafting.py's traffic: a regenerated request, whose
continuation the radix tree drafts, a COW-sharing neighbour, a repetitive
prompt that prompt-lookup drafts, and rejected drafts that demote every
source so fused bursts resume. spec-on also equals the port's spec-off. The
same at tp=2 against the JAX engine's outputs (the reference's own sharded
speculation gate is red and no proof)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.models import decode as jd
from nos_tpu.models import speculative as jspec
from nos_tpu.runtime import decode_server as jds
from nos_tpu.runtime.decode_server import DecodeServer as JaxServer
from nos_tpu_torch import DecodeServer, GPTConfig, from_numpy_params
from nos_tpu_torch.models import decode as td
from nos_tpu_torch.models import speculative as tspec
from nos_tpu_torch.parallel import build_mesh
from nos_tpu_torch.runtime import decode_server as tds

from conftest import serving_test_config, serving_test_params

JAX_OFF = dict(surgical_recovery=False)
ENGINE = dict(n_slots=2, max_len=64, prompt_buckets=(8, 16), block_size=8, seed=11)
SPEC = dict(spec_k=6, spec_sync=True)
SPEC_COUNTERS = ("spec_rounds", "spec_tokens_accepted", "spec_demotions", "spec_tree_rounds",
                 "spec_history_rounds", "spec_tree_tokens_accepted",
                 "spec_history_tokens_accepted", "spec_tree_demotions",
                 "spec_history_demotions", "both_dispatch_ticks", "steps_run",
                 "macro_dispatches", "burst_dispatches", "prefill_tokens", "h2d_uploads",
                 "blocking_syncs")

DONOR = [((i * 5) % 91) + 1 for i in range(24)]
DIV = DONOR[:12] + [((i * 7) % 91) + 2 for i in range(12)]
REPEAT = [3, 1, 4, 1, 5, 9, 2, 6] * 3
TRAFFIC = {
    "regeneration": [(DONOR, 16), (DONOR, 16)],
    "cow_shared": [(DONOR, 10), (DIV, 10), (DIV, 10)],
    "repetitive": [(REPEAT, 24), (DONOR, 8)],
}


@pytest.fixture(scope="module")
def model():
    jcfg, jparams = serving_test_config(), serving_test_params()
    tcfg = GPTConfig(**dataclasses.asdict(jcfg))
    tparams = from_numpy_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def port(model, mesh=None, **kw):
    _, _, tcfg, tparams = model
    kw = dict(ENGINE, **kw)
    if mesh is None:
        kw["device"] = "cpu"
    return DecodeServer(tparams, tcfg, mesh=mesh, **kw)


def ref(model, **kw):
    jcfg, jparams, _, _ = model
    return JaxServer(jparams, jcfg, **JAX_OFF, **dict(ENGINE, **kw))


def run_seq(server, reqs):
    outs = []
    server.start()
    try:
        for p, n in reqs:
            outs.append(server.generate(p, max_new=n, timeout=300))
    finally:
        server.stop()
    return outs


def counters(server):
    return {c: getattr(server, c) for c in SPEC_COUNTERS}


# -- the host pieces -----------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_lookup_and_acceptance_match_reference(seed):
    rng = np.random.RandomState(seed)
    for _ in range(40):
        history = rng.randint(0, 5, size=rng.randint(1, 40)).tolist()
        ngram, k = int(rng.randint(1, 4)), int(rng.randint(0, 9))
        assert (tspec.find_prompt_lookup_draft(history, ngram, k)
                == jspec.find_prompt_lookup_draft(history, ngram, k))
        window = rng.randint(0, 3, size=rng.randint(1, 9)).tolist()
        preds = rng.randint(0, 3, size=len(window)).tolist()
        assert tspec.accept_prefix(window, preds) == jspec.accept_prefix(window, preds)
    # The incremental index, with evictions (max_entries 6), over extends.
    start = rng.randint(0, 6, size=10).tolist()
    mine, theirs = (tspec._LookupIndex(list(start), 2, 6), jspec._LookupIndex(list(start), 2, 6))
    for _ in range(60):
        new = rng.randint(0, 6, size=rng.randint(1, 4)).tolist()
        mine.extend(new)
        theirs.extend(new)
        k = int(rng.randint(1, 8))
        assert mine.draft(k) == theirs.draft(k)
        assert mine.index == theirs.index and mine.history == theirs.history


@pytest.mark.parametrize("seed", range(3))
def test_adaptive_spec_matches_reference(seed):
    rng = np.random.RandomState(seed)
    mine, theirs = tspec.AdaptiveSpec(), jspec.AdaptiveSpec()
    sources = [tspec.SOURCE_TREE, tspec.SOURCE_HISTORY]
    assert sources == [jspec.SOURCE_TREE, jspec.SOURCE_HISTORY]
    for generated in range(0, 400, 3):
        source = sources[rng.randint(2)]
        drafted = int(rng.randint(0, 7))
        accepted = int(rng.randint(0, drafted + 1))
        assert (mine.observe(drafted, accepted, generated, source)
                == theirs.observe(drafted, accepted, generated, source))
        for s in sources:
            assert mine.allowed(generated, s) == theirs.allowed(generated, s)
            assert mine.cap(6, s) == theirs.cap(6, s)
        assert mine.denial_margin(generated, sources) == theirs.denial_margin(generated, sources)
        snap = mine.snapshot(generated)
        assert snap == theirs.snapshot(generated)
        assert (dataclasses.asdict(tspec.AdaptiveSpec.restore(snap))
                == dataclasses.asdict(jspec.AdaptiveSpec.restore(snap)))


# -- the programs ---------------------------------------------------------------------
@pytest.mark.parametrize("case", ["repetitive", "no_draft", "eos"])
def test_speculative_generate_matches_jax(model, case):
    jcfg, jparams, tcfg, tparams = model
    prompt = REPEAT if case != "no_draft" else DONOR
    kw = dict(max_new=24, prompt_chunk=16, block_size=8, return_stats=True)
    if case == "no_draft":
        kw["draft_k"] = 0
    want, jstats = jspec.speculative_generate(jparams, jcfg, prompt, **kw)
    if case == "eos":
        full = want
        kw["eos_id"] = full[5]
        want, jstats = jspec.speculative_generate(jparams, jcfg, prompt, **kw)
        assert want == full[: full.index(kw["eos_id"]) + 1]
    got, stats = tspec.speculative_generate(tparams, tcfg, prompt, **kw)
    assert got == want and stats == jstats
    if case == "repetitive":
        assert stats["accepted_per_round"] > 1.0


def test_paged_verify_window_matches_jax(model):
    """Window W = 7 over three lanes' own pages at per-lane positions, one
    lane masked: logits within f32 rounding of JAX's on the live rows, the
    greedy picks equal, and the pool written alike."""
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.RandomState(0)
    bs, total, w = 8, 16, 7
    shape = (total, jcfg.n_kv, bs, jcfg.head_dim)
    pool = {str(i): {n: rng.randn(*shape).astype(np.float32) for n in ("k", "v")}
            for i in range(jcfg.layers)}
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]], np.int32)
    tokens = rng.randint(0, 97, size=(3, w)).astype(np.int32)
    pos = np.array([5, 17, 9], np.int32)
    lengths = np.array([7, 3, 5], np.int32)
    mask = np.array([True, True, False])
    jlog, jpool = jd.paged_verify_window(
        jparams, jnp.asarray(tokens), jcfg, jax.tree_util.tree_map(jnp.asarray, pool),
        jnp.asarray(table), jnp.asarray(pos), jnp.asarray(lengths), jnp.asarray(mask), bs)
    tpool = {i: {n: torch.from_numpy(a.copy()) for n, a in d.items()} for i, d in pool.items()}
    tlog, _ = td.paged_verify_window(
        tparams, torch.from_numpy(tokens), tcfg, tpool, torch.from_numpy(table),
        torch.from_numpy(pos), torch.from_numpy(lengths), torch.from_numpy(mask), bs)
    jlog = np.asarray(jlog)
    for b in range(2):
        live = slice(0, lengths[b])
        np.testing.assert_allclose(tlog[b, live].numpy(), jlog[b, live], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(td.greedy(tlog[b, live]).numpy(),
                                      jlog[b, live].argmax(-1))
    for i in pool:
        for n in ("k", "v"):
            np.testing.assert_allclose(tpool[i][n][1:].numpy(), np.asarray(jpool[i][n])[1:],
                                       rtol=1e-6, atol=1e-6)


# -- the engine -----------------------------------------------------------------------
@pytest.mark.parametrize("case", sorted(TRAFFIC))
def test_engine_spec_equals_jax_and_spec_off(model, case):
    reqs = TRAFFIC[case]
    jsrv = ref(model, **SPEC)
    want = run_seq(jsrv, reqs)
    tsrv = port(model, **SPEC)
    assert run_seq(tsrv, reqs) == want
    assert counters(tsrv) == counters(jsrv)
    assert run_seq(port(model), reqs) == want
    assert tsrv.spec_rounds > 0 and tsrv.spec_tokens_accepted > 0
    if case == "repetitive":
        assert tsrv.spec_history_tokens_accepted > 0
    else:
        assert tsrv.spec_tree_rounds > 0 and tsrv.spec_tree_tokens_accepted > 0


def test_history_only_and_pipelined_engines(model):
    """`spec_tree_drafts=False` drafts from history alone (the JAX engine's
    tokens and counts); `spec_sync=False` probes only tokens already
    materialized, so which rounds run depends on timing: the tokens still
    equal the JAX engine's."""
    reqs = TRAFFIC["regeneration"]
    kw = dict(SPEC, spec_tree_drafts=False)
    jsrv, tsrv = ref(model, **kw), port(model, **kw)
    assert run_seq(tsrv, reqs) == run_seq(jsrv, reqs)
    assert counters(tsrv) == counters(jsrv)
    assert tsrv.spec_tree_rounds == 0 and tsrv.spec_history_rounds > 0
    assert run_seq(port(model, spec_k=4), reqs) == run_seq(ref(model, spec_k=4), reqs)
    with pytest.raises(ValueError, match="temperature"):
        port(model, spec_k=2, temperature=0.8)


def test_bursts_resume_while_all_sources_in_cooldown(model, monkeypatch):
    """Drafts the model never accepts demote history drafting at once; while
    every source cools down the spec-armed engine bursts again, and its
    tokens equal spec-off's and the JAX engine's (cf.
    tests/test_spec_tree_drafting.py:402)."""

    def rejecting(base):
        class _Rejecting(base):
            def draft(self, k):
                return [96] * k if k > 0 else []
        return _Rejecting

    monkeypatch.setattr(tds, "_LookupIndex", rejecting(tds._LookupIndex))
    monkeypatch.setattr(jds, "_LookupIndex", rejecting(jds._LookupIndex))
    kw = dict(n_slots=1, max_len=128, radix_cache=False, burst_windows=4, steps_per_dispatch=4)
    reqs = [(REPEAT, 64)]
    base = port(model, **kw)
    want = run_seq(base, reqs)
    assert base.burst_dispatches > 0
    jsrv, tsrv = ref(model, **kw, **SPEC), port(model, **kw, **SPEC)
    assert run_seq(tsrv, reqs) == want == run_seq(jsrv, reqs)
    assert counters(tsrv) == counters(jsrv)
    assert tsrv.spec_demotions >= 1 and tsrv.burst_dispatches > 0 and tsrv.spec_rounds > 0


@pytest.mark.multidevice
@pytest.mark.parametrize("case", ["regeneration", "repetitive"])
def test_tp2_spec_equals_jax(model, case):
    """Sharded verify windows (`_paged_window_tp`): the JAX engine's tokens
    and round counts at tp=2."""
    mesh = build_mesh({"tp": 2}, devices=["cpu", "cpu"])
    reqs = TRAFFIC[case]
    jsrv, shd = ref(model, **SPEC), port(model, mesh=mesh, **SPEC)
    assert run_seq(shd, reqs) == run_seq(jsrv, reqs)
    assert counters(shd) == counters(jsrv)
    assert shd.spec_rounds > 0
