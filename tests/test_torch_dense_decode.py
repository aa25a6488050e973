"""The port's dense decode programs and plain decode attention
(nos_tpu_torch/models/decode.py, nos_tpu_torch/ops/decode_attention.py)
against the JAX reference (nos_tpu/models/decode.py,
nos_tpu/ops/decode_attention.py) on the CPU.

Same weights (the JAX init carried across with `from_numpy_params`) on two
float32 configs, the shared serving config and tests/test_decode.py's, and
the same caches and prompts, made from a numpy seed. Bounds: the plain
attention against JAX's `_reference` atol 1e-5 in f32; against the Pallas
kernel in interpret mode 3e-2 in bf16, test_decode_attention.py's bound
(one bf16 rounding of the output); logits atol 1e-4 and caches atol 1e-5,
as for the paged programs; greedy tokens identical."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.models import decode as jd
from nos_tpu.models.gpt import init_gpt as jax_init_gpt
from nos_tpu.ops import decode_attention as jda
from nos_tpu_torch import DecodeServer
from nos_tpu_torch.models import decode as td
from nos_tpu_torch.models.gpt import GPTConfig as TGPTConfig
from nos_tpu_torch.models.params import from_numpy_params
from nos_tpu_torch.ops import _build
from nos_tpu_torch.ops import decode_attention as tda

from conftest import serving_test_config, serving_test_params
from test_decode import CFG as DECODE_CFG

LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def _model(name):
    if name == "serving":
        jcfg, jparams = serving_test_config(), serving_test_params()
    else:
        jcfg = DECODE_CFG
        jparams = jax_init_gpt(jax.random.PRNGKey(0), jcfg)
    tcfg = TGPTConfig(**dataclasses.asdict(jcfg))
    tparams = from_numpy_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(params=["serving", "decode"])
def model(request):
    return _model(request.param)


def _tokens(seed, shape, vocab):
    return np.random.RandomState(seed).randint(0, vocab, size=shape).astype(np.int32)


def _random_cache(cfg, b, max_len, seed):
    rng = np.random.RandomState(seed)
    shape = (b, cfg.n_kv, max_len, cfg.head_dim)
    return {str(i): {"k": rng.randn(*shape).astype(np.float32),
                     "v": rng.randn(*shape).astype(np.float32)}
            for i in range(cfg.layers)}


def _as_jax(cache):
    return {l: {k: jnp.asarray(a) for k, a in lc.items()} for l, lc in cache.items()}


def _as_torch(cache):
    return {l: {k: torch.from_numpy(a.copy()) for k, a in lc.items()}
            for l, lc in cache.items()}


def _assert_caches_close(tcache, jcache):
    for layer, lc in jcache.items():
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[layer][name].numpy(), np.asarray(lc[name]),
                                       atol=CACHE_ATOL, rtol=0)


# -- decode attention, plain version -------------------------------------------
def _attention_inputs(b, nkv, rep, maxl, hd, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, nkv * rep, hd).astype(np.float32)
    ck = rng.randn(b, nkv, maxl, hd).astype(np.float32)
    cv = rng.randn(b, nkv, maxl, hd).astype(np.float32)
    return q, ck, cv


@pytest.mark.parametrize("limits", [[0, 1, 17, 64], [64, 100, 3, 0], [33, 32, 31, 65]])
def test_reference_matches_jax_f32(limits):
    """Including limit 0 (the uniform mean of V over all max rows) and
    limit > max (every position valid)."""
    q, ck, cv, = _attention_inputs(4, 2, 4, 64, 32, seed=sum(limits))
    lim = np.array(limits, np.int32)
    want = jda._reference(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(lim))
    got = tda._reference(*(torch.from_numpy(a) for a in (q, ck, cv, lim)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    if 0 in limits:
        row = limits.index(0)
        mean_v = cv[row].mean(axis=1)  # [nkv, hd]
        np.testing.assert_allclose(got.numpy()[row].reshape(2, 4, 32),
                                   np.repeat(mean_v[:, None], 4, axis=1), atol=1e-5)


@pytest.mark.parametrize("b,nkv,rep,maxl,hd", [(3, 2, 4, 64, 32), (2, 3, 2, 32, 16)])
def test_reference_matches_pallas_interpret_bf16(b, nkv, rep, maxl, hd):
    """test_decode_attention.py's shapes, the uneven rep=2 case included."""
    q, ck, cv = _attention_inputs(b, nkv, rep, maxl, hd, seed=hd)
    lim = np.array([1, maxl // 3, maxl][:b], np.int32)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, ck, cv))
    want = jda._pallas(jq, jk, jv, jnp.asarray(lim), interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, ck, cv))
    got = tda._reference(tq, tk, tv, torch.from_numpy(lim))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=3e-2, rtol=3e-2)


def test_decode_attention_takes_the_plain_version_on_the_cpu():
    q, ck, cv = _attention_inputs(2, 2, 2, 16, 16, seed=1)
    args = [torch.from_numpy(a) for a in (q, ck, cv)] + [torch.tensor([3, 16], dtype=torch.int32)]
    before = dict(tda.LAUNCHES)
    assert torch.equal(tda.decode_attention(*args), tda._reference(*args))
    assert tda.LAUNCHES == before
    with pytest.raises(ValueError):
        tda.decode_attention(*(a.to("meta") for a in args))


# -- the split decode kernels' arithmetic (csrc/split_decode.cuh) -------------------
SPLIT_KEYS = _build.split_keys()


def split_decode(q, keys, vals, n_keys, uniform, split=SPLIT_KEYS):
    """The split decode kernels' arithmetic in plain PyTorch, in f32: for
    every (b, g) the group's query rows attend the lane's first n_keys[b]
    keys in fixed `split`-key splits, each split's partial (m, l, acc)
    taken over its keys (every score 0 where `uniform[b]`: the dense
    kernel's limit <= 0), then the splits combined in split order, out =
    sum_s e^{m_s - M} acc_s / max(sum_s e^{m_s - M} l_s, 1e-30), M = max_s
    m_s; a lane with no key gives zeros. q [B, nh, hd]; keys and vals [B,
    nkv, S, hd] f32 -> [B, nh, hd] in q's dtype."""
    b, nh, hd = q.shape
    nkv = keys.shape[1]
    rep = nh // nkv
    out = torch.zeros((b, nh, hd))
    for bi in range(b):
        n = int(n_keys[bi])
        for g in range(nkv):
            rows = q[bi, g * rep:(g + 1) * rep].float()
            parts = []
            for s0 in range(0, n, split):
                idx = torch.arange(s0, min(s0 + split, n))
                if uniform[bi]:
                    s = torch.zeros((rep, len(idx)))
                else:
                    s = (rows @ keys[bi, g, idx].T) * hd ** -0.5
                m = s.max(dim=1).values
                p = torch.exp(s - m[:, None])
                parts.append((m, p.sum(dim=1), p @ vals[bi, g, idx]))
            if not parts:
                continue
            big_m = torch.stack([m for m, _, _ in parts]).max(dim=0).values
            num, den = torch.zeros((rep, hd)), torch.zeros(rep)
            for m, l, acc in parts:
                e = torch.exp(m - big_m)
                num, den = num + e[:, None] * acc, den + e * l
            out[bi, g * rep:(g + 1) * rep] = num / den.clamp_min(1e-30)[:, None]
    return out.to(q.dtype)


def dense_split_decode(q, cache_k, cache_v, limit, split=SPLIT_KEYS):
    """`split_decode` as the dense kernel runs it: n_keys = min(limit, max),
    and limit <= 0 scores all `max` positions alike."""
    max_len = cache_k.shape[2]
    lim = limit.long()
    n_keys = torch.where(lim <= 0, max_len, lim.clamp(max=max_len))
    return split_decode(q, cache_k.float(), cache_v.float(), n_keys, (lim <= 0).tolist(), split)


J_DENSE_REF = jax.jit(jda._reference)
J_DENSE_PALLAS = jax.jit(functools.partial(jda._pallas, interpret=True))
K = SPLIT_KEYS
DENSE_SPLIT_MAX = 3 * K + 10


@pytest.mark.parametrize("limits", [
    [1, K - 1, K, K + 1],                           # the first split's edge
    [2 * K - 1, 2 * K, 2 * K + 1, 3 * K],           # the second's, and three splits
    [5, 2 * K + 3, K, 77],                          # a ragged mix
    [DENSE_SPLIT_MAX, DENSE_SPLIT_MAX + 9, 0, -2],  # max, past max, and <= 0 (uniform)
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_arithmetic_matches_jax(limits, dtype):
    """The split-and-combine arithmetic against the JAX package's `_pallas`
    (interpret mode) and `_reference` at the split boundaries. f32: atol
    1e-5 (summation order only); bf16 inputs (the arithmetic stays f32, the
    output is rounded to bf16 once): within one bf16 rounding of the
    output, 2^-8 relative plus 1e-6, against both."""
    q, ck, cv = _attention_inputs(4, 2, 4, DENSE_SPLIT_MAX, 32, seed=sum(limits) % 1000)
    lim = np.array(limits, np.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, ck, cv))
    got = dense_split_decode(tq, tk, tv, torch.from_numpy(lim)).float().numpy()
    jargs = [jnp.asarray(a, jdt) for a in (q, ck, cv)] + [jnp.asarray(lim)]
    for want in (J_DENSE_REF(*jargs), J_DENSE_PALLAS(*jargs)):
        want = np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        else:
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=2.0 ** -8)


# -- the dense programs ------------------------------------------------------------
def test_init_cache_shapes(model, monkeypatch):
    _, _, tcfg, _ = model
    cache = td.init_cache(tcfg, batch=3, max_len=16, device="cpu")
    assert set(cache) == {str(i) for i in range(tcfg.layers)}
    assert tuple(cache["0"]["k"].shape) == (3, tcfg.n_kv, 16, tcfg.head_dim)
    assert cache["1"]["v"].dtype == torch.float32 and not cache["1"]["v"].any()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="init_cache runs on CUDA"):
        td.init_cache(tcfg, 1, 8)


@pytest.mark.parametrize("pos_kind", ["int", "tensor"])
def test_prefill_and_decode_step_match_jax(model, pos_kind):
    jcfg, jparams, tcfg, tparams = model
    prompt = _tokens(0, (2, 5), jcfg.vocab)
    jl, jcache = jax.jit(functools.partial(jd.prefill, cfg=jcfg, max_len=16))(
        jparams, jnp.asarray(prompt))
    tl, tcache = td.prefill(tparams, torch.from_numpy(prompt), tcfg, 16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
    _assert_caches_close(tcache, jcache)
    token = _tokens(1, (2,), jcfg.vocab)
    jl, jcache = jax.jit(functools.partial(jd.decode_step, cfg=jcfg))(
        jparams, jnp.asarray(token), cache=jcache, pos=5)
    pos = 5 if pos_kind == "int" else torch.tensor(5)
    tl, out = td.decode_step(tparams, torch.from_numpy(token), tcfg, tcache, pos)
    assert out is tcache  # written in place
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, jcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
    _assert_caches_close(tcache, jcache)


def test_one_token_prompt_prefill_goes_through_decode_attention(model, monkeypatch):
    """A one-token prompt is a t == 1 step: the cached-attention op runs."""
    jcfg, jparams, tcfg, tparams = model
    prompt = _tokens(2, (3, 1), jcfg.vocab)
    calls = []
    real = td.decode_attention
    monkeypatch.setattr(td, "decode_attention",
                        lambda *a: calls.append(a[3].tolist()) or real(*a))
    jl, jcache = jd.prefill(jparams, jnp.asarray(prompt), jcfg, 8)
    tl, tcache = td.prefill(tparams, torch.from_numpy(prompt), tcfg, 8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
    _assert_caches_close(tcache, jcache)
    assert calls == [[1, 1, 1]] * tcfg.layers


def test_decode_step_ragged_matches_jax(model):
    """Per-row positions over a filled dense cache; row 3's position is past
    the cache (max 16): JAX clamps its write to position 15, and its limit
    (21) leaves every position valid."""
    jcfg, jparams, tcfg, tparams = model
    cache = _random_cache(jcfg, 4, 16, seed=3)
    token = _tokens(4, (4,), jcfg.vocab)
    pos = np.array([0, 7, 15, 20], np.int32)
    jl, jcache = jax.jit(functools.partial(jd.decode_step_ragged, cfg=jcfg))(
        jparams, jnp.asarray(token), cache=_as_jax(cache), pos=jnp.asarray(pos))
    tcache = _as_torch(cache)
    tl, _ = td.decode_step_ragged(tparams, torch.from_numpy(token), tcfg, tcache,
                                  torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
    _assert_caches_close(tcache, jcache)


def test_decode_step_clamps_a_lockstep_write_past_the_cache(model):
    jcfg, jparams, tcfg, tparams = model
    cache = _random_cache(jcfg, 2, 8, seed=5)
    token = _tokens(6, (2,), jcfg.vocab)
    jl, jcache = jd.decode_step(jparams, jnp.asarray(token), jcfg, _as_jax(cache), 9)
    tcache = _as_torch(cache)
    tl, _ = td.decode_step(tparams, torch.from_numpy(token), tcfg, tcache, 9)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
    _assert_caches_close(tcache, jcache)


@pytest.mark.parametrize("b,t,steps,max_len", [(2, 5, 6, 16), (3, 1, 7, None)])
def test_generate_greedy_matches_jax(model, b, t, steps, max_len):
    jcfg, jparams, tcfg, tparams = model
    prompt = _tokens(10 + t, (b, t), jcfg.vocab)
    want = jax.jit(lambda p, x: jd.generate(p, x, jcfg, steps=steps, max_len=max_len))(
        jparams, jnp.asarray(prompt))
    got = td.generate(tparams, torch.from_numpy(prompt), tcfg, steps=steps, max_len=max_len)
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_and_prefill_reject_an_overflowing_cache(model):
    _, _, tcfg, tparams = model
    prompt = torch.from_numpy(_tokens(7, (1, 5), tcfg.vocab))
    with pytest.raises(ValueError, match="exceed cache max_len"):
        td.generate(tparams, prompt, tcfg, steps=6, max_len=8)
    with pytest.raises(ValueError, match="exceeds cache max_len"):
        td.prefill(tparams, prompt, tcfg, max_len=4)
    with pytest.raises(ValueError, match="steps must be >= 1"):
        td.generate(tparams, prompt, tcfg, steps=0)


def test_dense_generate_equals_the_engine(model):
    """The dense generate is the engine's golden reference
    (tests/test_paged_attention.py:237, in JAX): the port's engine serves
    the same greedy tokens as the port's dense generate, prompt by prompt."""
    _, _, tcfg, tparams = model
    rng = np.random.RandomState(8)
    prompts = [rng.randint(1, tcfg.vocab, size=n).tolist() for n in (3, 6, 9, 4)]
    server = DecodeServer(tparams, tcfg, n_slots=3, max_len=32, block_size=8,
                          prompt_buckets=(4, 8, 16), device="cpu")
    futs = [server.submit(p, 8) for p in prompts]
    server.start()
    try:
        outs = [f.result(timeout=300) for f in futs]
    finally:
        server.stop()
    for prompt, got in zip(prompts, outs):
        solo = td.generate(tparams, torch.tensor([prompt], dtype=torch.int32), tcfg, steps=8)
        assert got == solo[0].tolist(), prompt
