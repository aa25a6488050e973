"""The port's paged serving programs (nos_tpu_torch/models/decode.py)
against the JAX reference (nos_tpu/models/decode.py) on the CPU.

Same weights (the JAX init carried across with `from_numpy_params`), the
same pool contents and page tables, made from a numpy seed, and the shared
float32 serving config. Logits atol 1e-4, pools atol 1e-5; scratch-page
contents are never compared (several lanes write block 0 at once, in no
defined order)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.models import decode as jd
from nos_tpu_torch.models import decode as td
from nos_tpu_torch.models.gpt import GPTConfig as TGPTConfig
from nos_tpu_torch.models.params import from_numpy_params

from conftest import serving_test_config, serving_test_params

BS = 8
TOTAL = 24
LOGIT_ATOL = 1e-4
POOL_ATOL = 1e-5


@pytest.fixture(scope="module")
def model():
    jcfg = serving_test_config()
    tcfg = TGPTConfig(**dataclasses.asdict(jcfg))
    jparams = serving_test_params()
    tparams = from_numpy_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def jitted(fn, **static):
    """The JAX reference program compiled whole (one compile instead of one
    per eager op); `static` binds the config and the Python-level knobs."""
    return jax.jit(functools.partial(fn, **static))


def random_pools(cfg, seed):
    rng = np.random.RandomState(seed)
    shape = (TOTAL, cfg.n_kv, BS, cfg.head_dim)
    return {
        str(i): {"k": rng.randn(*shape).astype(np.float32),
                 "v": rng.randn(*shape).astype(np.float32)}
        for i in range(cfg.layers)
    }


def as_jax(pools):
    return {l: {k: jnp.asarray(a) for k, a in lc.items()} for l, lc in pools.items()}


def as_torch(pools):
    return {l: {k: torch.from_numpy(a.copy()) for k, a in lc.items()}
            for l, lc in pools.items()}


def assert_pools_close(tpool, jpool):
    for layer, lc in jpool.items():
        for name in ("k", "v"):
            got = tpool[layer][name].numpy()[1:]  # block 0 is scratch
            np.testing.assert_allclose(got, np.asarray(lc[name])[1:], atol=POOL_ATOL, rtol=0)


def table_for(b, n_pages, seed):
    rng = np.random.RandomState(seed)
    perm = rng.permutation(np.arange(1, TOTAL))
    table = np.zeros((b, n_pages), dtype=np.int32)
    for row in range(b):
        table[row] = perm[row * n_pages:(row + 1) * n_pages]
    return table


def test_init_paged_cache_shapes_and_int8_leaves(model):
    _, _, tcfg, _ = model
    pool = td.init_paged_cache(tcfg, TOTAL, BS, device="cpu")
    assert set(pool) == {str(i) for i in range(tcfg.layers)}
    assert tuple(pool["0"]["k"].shape) == (TOTAL, tcfg.n_kv, BS, tcfg.head_dim)
    assert pool["0"]["v"].dtype == torch.float32 and not pool["1"]["k"].any()
    assert set(pool["0"]) == {"k", "v"}
    quant = td.init_paged_cache(tcfg, TOTAL, BS, kv_dtype="int8", device="cpu")
    for lc in quant.values():
        assert set(lc) == {"k", "v", "k_scale", "v_scale"}
        assert lc["k"].dtype == lc["v"].dtype == torch.int8
        assert tuple(lc["k"].shape) == (TOTAL, tcfg.n_kv, BS, tcfg.head_dim)
        assert lc["k_scale"].dtype == lc["v_scale"].dtype == torch.float32
        assert tuple(lc["k_scale"].shape) == tuple(lc["v_scale"].shape) == (TOTAL,)
        assert not any(t.any() for t in lc.values())
    with pytest.raises(ValueError):
        td.init_paged_cache(tcfg, TOTAL, BS, kv_dtype="fp8", device="cpu")


def test_paged_decode_step_matches_reference(model):
    """Ragged positions, one masked lane (its write lands on scratch), and
    one lane whose position sits at a page boundary."""
    jcfg, jparams, tcfg, tparams = model
    pools = random_pools(jcfg, 0)
    table = table_for(4, 5, 1)
    token = np.array([3, 50, 96, 7], np.int32)
    pos = np.array([0, 17, 8, 39], np.int32)
    mask = np.array([True, True, False, True])
    step = jitted(jd.paged_decode_step, cfg=jcfg, block_size=BS)
    jl, jpool = step(jparams, jnp.asarray(token), pcache=as_jax(pools),
                     table=jnp.asarray(table), pos=jnp.asarray(pos), mask=jnp.asarray(mask))
    tpool = as_torch(pools)
    tl, out_pool = td.paged_decode_step(tparams, torch.from_numpy(token), tcfg, tpool,
                                        torch.from_numpy(table), torch.from_numpy(pos),
                                        torch.from_numpy(mask), BS)
    assert out_pool is tpool  # written in place
    live = mask  # a masked lane's logits are garbage by contract
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], atol=LOGIT_ATOL,
                               rtol=0)
    assert_pools_close(tpool, jpool)


@pytest.mark.parametrize("with_logits", [True, False])
@pytest.mark.parametrize("start,length,chunk", [(0, 13, 16), (16, 16, 16), (21, 5, 8)])
def test_paged_prefill_chunk_matches_reference(model, with_logits, start, length, chunk):
    jcfg, jparams, tcfg, tparams = model
    pools = random_pools(jcfg, 2)
    table = table_for(1, 5, 3)[0]
    rng = np.random.RandomState(start + length)
    tokens = np.zeros((1, chunk), np.int32)
    tokens[0, :length] = rng.randint(0, jcfg.vocab, size=length)
    chunk_fn = jitted(jd.paged_prefill_chunk, cfg=jcfg, block_size=BS,
                      with_logits=with_logits)
    jl, jpool = chunk_fn(jparams, jnp.asarray(tokens), pcache=as_jax(pools),
                         table_row=jnp.asarray(table), start=start, length=length)
    tpool = as_torch(pools)
    tl, _ = td.paged_prefill_chunk(tparams, torch.from_numpy(tokens), tcfg, tpool,
                                   torch.from_numpy(table), start, length, BS,
                                   with_logits=with_logits)
    if with_logits:
        np.testing.assert_allclose(tl.numpy()[:length], np.asarray(jl)[:length],
                                   atol=LOGIT_ATOL, rtol=0)
    else:
        assert tl is None and jl is None
    assert_pools_close(tpool, jpool)


def test_paged_prefill_window_matches_reference(model):
    """Three slots' same-bucket chunks in one window: ragged lengths, one
    inactive lane, per-row base positions."""
    jcfg, jparams, tcfg, tparams = model
    pools = random_pools(jcfg, 4)
    table = table_for(4, 5, 5)
    rng = np.random.RandomState(6)
    w = 16
    tokens = rng.randint(0, jcfg.vocab, size=(4, w)).astype(np.int32)
    pos = np.array([0, 16, 5, 24], np.int32)
    lengths = np.array([16, 9, 16, 3], np.int32)
    mask = np.array([True, True, False, True])
    window_args = dict(table=jnp.asarray(table), pos=jnp.asarray(pos),
                       lengths=jnp.asarray(lengths), mask=jnp.asarray(mask))
    jpool = jitted(jd.paged_prefill_window, cfg=jcfg, block_size=BS)(
        jparams, jnp.asarray(tokens), pcache=as_jax(pools), **window_args)
    tpool = as_torch(pools)
    td.paged_prefill_window(tparams, torch.from_numpy(tokens), tcfg, tpool,
                            torch.from_numpy(table), torch.from_numpy(pos),
                            torch.from_numpy(lengths), torch.from_numpy(mask), BS)
    assert_pools_close(tpool, jpool)
    # The window core's activations too (the verify program's input).
    jx, _ = jitted(jd._paged_window_core, cfg=jcfg, block_size=BS)(
        jparams, jnp.asarray(tokens), pcache=as_jax(pools), **window_args)
    tx, _ = td._paged_window_core(tparams, torch.from_numpy(tokens), tcfg,
                                  as_torch(pools), torch.from_numpy(table),
                                  torch.from_numpy(pos), torch.from_numpy(lengths),
                                  torch.from_numpy(mask), BS)
    for row in np.flatnonzero(mask):
        n = lengths[row]
        np.testing.assert_allclose(tx.numpy()[row, :n], np.asarray(jx)[row, :n],
                                   atol=LOGIT_ATOL, rtol=0)
