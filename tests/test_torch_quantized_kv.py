"""The port's int8 KV pool against the JAX package's, on the CPU: the write
funnel and block movers (nos_tpu_torch/ops/quantized_kv.py against
nos_tpu/ops/quantized_kv.py), the int8 `init_paged_cache` leaves, the four
paged programs over an int8 pool (nos_tpu_torch/models/decode.py), the
bounded-divergence oracle (runtime/divergence.py) and the int8 engine
(`DecodeServer(kv_dtype="int8")`).

The funnel and the movers must give the reference's codes and scales BIT
FOR BIT from the same inputs (made from a numpy seed), and write in place.
The programs compute their K/V rows through the projections, whose float32
results already differ between XLA and PyTorch in the last bit (the native
pool tests hold them to atol 1e-5), so a row's max|value|, and with it its
block's scale, may differ by a float32 rounding: the programs' codes must
be equal and their scales within rtol 1e-6 (about 8 float32 steps);
logits as the native tests hold them, atol 1e-4. Under tp=2 the two shards'
scale copies must be equal to each other and to tp=1's scales. The oracle's
per-token deltas within 1e-5 of the reference's report and its agreement
equal (the reference's own `within()` gate is red on one seed, so its
report, not the gate, is the yardstick). The engines must give EQUAL
tokens and equal counters on the same schedule."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.models import decode as jd
from nos_tpu.ops import quantized_kv as jq
from nos_tpu.runtime import divergence as jdiv
from nos_tpu.runtime.decode_server import DecodeServer as JaxServer
from nos_tpu.runtime.radix_tree import prompt_chain_keys
from nos_tpu_torch import DecodeServer, GPTConfig, from_numpy_params
from nos_tpu_torch.models import decode as td
from nos_tpu_torch.ops import quantized_kv as tq
from nos_tpu_torch.parallel import build_mesh
from nos_tpu_torch.runtime import divergence as tdiv

from conftest import serving_test_config, serving_test_params

BS = 8
TOTAL = 24
LOGIT_ATOL = 1e-4
SCALE_RTOL = 1e-6
# The oracle's deltas, port against reference. Where no int8 code differs
# between the two packages' pools the deltas agree to ~3e-6 (the native
# logits' gap), but the projections' float32 rounding can put one element
# of the reference's prompt on the other side of a rounding boundary: on
# the third prompt one code of one layer-1 K row differs by 1, which moves
# the int8 arm's logits by up to 3.6e-3 and a per-token delta by 6.0e-4.
# One code step is the resolution of the int8 pool, so the bound is 2e-3.
ORACLE_ATOL = 2e-3
JAX_OFF = dict(surgical_recovery=False)
ENGINE = dict(n_slots=2, max_len=64, prompt_buckets=(8, 16), block_size=8, seed=11)
COUNTERS = ("prefix_lookups", "prefix_hit_blocks", "prefix_hit_tokens", "prefix_evictions",
            "prefix_cow_hits", "prefix_cow_tokens", "output_blocks_registered",
            "radix_nodes", "spills", "revives", "spill_drops", "spill_host_bytes",
            "prefill_tokens", "prefill_dispatches", "steps_run", "macro_dispatches",
            "burst_dispatches", "h2d_uploads", "blocking_syncs", "kv_quant_enabled",
            "kv_pool_bytes", "kv_quant_payload_rejected")
SPEC_COUNTERS = ("spec_rounds", "spec_tokens_accepted", "spec_demotions",
                 "spec_tree_rounds", "spec_history_rounds")

PROMPTS = [[1 + (i * 7 + j) % 90 for j in range(5 + i)] for i in range(4)]
DONOR = [((i * 5) % 91) + 1 for i in range(24)]
DIV = DONOR[:12] + [((i * 7) % 91) + 2 for i in range(12)]
SPILL_DONOR = DONOR + [77, 78, 79, 80]
FILLER = [((i * 11) % 91) + 3 for i in range(28)]
REPEAT = [3, 1, 4, 1, 5, 9, 2, 6] * 3


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


# -- the funnel and the block movers, bit for bit ---------------------------------------
def _rows(seed, n, nkv=2, hd=8, scale=1.0):
    return (np.random.RandomState(seed).randn(n, nkv, hd) * scale).astype(np.float32)


def _pool(total=5, nkv=2, bs=4, hd=8):
    return np.zeros((total, nkv, bs, hd), np.int8), np.zeros((total,), np.float32)


class Funnel:
    """One pool written by both funnels from the same inputs: the JAX side
    returns new arrays, the port's writes in place (its addresses are
    checked on every write)."""

    def __init__(self, pool, scale):
        self.j = (jnp.asarray(pool), jnp.asarray(scale))
        self.t = (torch.from_numpy(pool.copy()), torch.from_numpy(scale.copy()))
        self.ptrs = [x.data_ptr() for x in self.t]

    def write(self, pages, offs, vals):
        pages, offs = np.asarray(pages, np.int32), np.asarray(offs, np.int32)
        self.j = jq.scatter_tokens(*self.j, jnp.asarray(pages), jnp.asarray(offs),
                                   jnp.asarray(vals))
        tq.scatter_tokens(*self.t, torch.from_numpy(pages), torch.from_numpy(offs),
                          torch.from_numpy(vals))
        assert [x.data_ptr() for x in self.t] == self.ptrs

    def assert_equal(self, blocks=slice(None)):
        for j, t in zip(self.j, self.t):
            np.testing.assert_array_equal(t.numpy()[blocks], np.asarray(j)[blocks])

    def scale(self, block):
        assert float(self.t[1][block]) == float(self.j[1][block])
        return float(self.t[1][block])


def test_quantize_helpers_round_half_to_even():
    """`safe_scale`, `quantize_rows` (ties at +-0.5, +-1.5, +-2.5, clamping)
    and `dequantize` give the reference's values."""
    vals = np.array([[0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 300.0, -300.0, 0.49, 7.3]],
                    np.float32)
    for s in (0.0, 1.0, 0.25):
        scale = np.float32(s)
        want = np.asarray(jq.quantize_rows(jnp.asarray(vals), jnp.asarray(scale)))
        got = tq.quantize_rows(torch.from_numpy(vals), torch.tensor(scale)).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int8
        np.testing.assert_array_equal(
            tq.dequantize(torch.from_numpy(got), tq.safe_scale(torch.tensor(scale))).numpy(),
            np.asarray(jq.dequantize(jnp.asarray(want), jq.safe_scale(jnp.asarray(scale)))))


def test_fresh_write_at_offset_zero_resets_a_stale_scale():
    f = Funnel(*_pool())
    f.write([2], [0], _rows(2, 1, scale=100.0))
    stale = f.scale(2)
    f.write([2], [0], _rows(3, 1, scale=0.01))  # a new occupancy, tiny rows
    assert f.scale(2) < stale / 100
    f.assert_equal()


def test_scale_growth_requantizes_existing_rows():
    f = Funnel(*_pool())
    f.write([1], [0], _rows(4, 1, scale=0.5))
    before = f.scale(1)
    f.write([1], [1], _rows(5, 1, scale=5.0))
    assert f.scale(1) > before
    f.assert_equal()
    # A smaller row after growth keeps the scale and leaves the rows alone.
    f.write([1], [2], _rows(6, 1, scale=0.1))
    f.assert_equal()


def test_rewriting_identical_rows_is_idempotent():
    f = Funnel(*_pool())
    vals = _rows(1, 4)
    f.write([1] * 4, [0, 1, 2, 3], vals)
    codes, scale = (t.clone() for t in f.t)
    f.write([1] * 4, [0, 1, 2, 3], vals)
    f.assert_equal()
    assert torch.equal(f.t[0], codes) and torch.equal(f.t[1], scale)


def test_never_written_blocks_decode_to_zero():
    f = Funnel(*_pool())
    f.write([3, 3], [0, 1], _rows(7, 2))
    for b in (0, 1, 2, 4):
        dec = tq.dequantize(f.t[0][b], tq.safe_scale(f.t[1][b]))
        assert float(f.t[1][b]) == 0.0 and not dec.any()
    f.assert_equal()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_duplicates_on_the_scratch_page(seed):
    """Masked lanes and padding write page 0 at clashing offsets while real
    rows fill several blocks, some at offset 0 and some growing: every
    block but the scratch page equals the reference's, codes and scale."""
    rng = np.random.RandomState(seed)
    f = Funnel(*_pool(total=6))
    for step in range(6):
        n = 9
        pages = rng.choice([0, 0, 0, 1, 2, 3, 4, 5], size=n)
        offs = rng.randint(0, 4, size=n)
        offs[pages == 0] = rng.randint(0, 2, size=int((pages == 0).sum()))
        f.write(pages, offs, _rows(100 * seed + step, n, scale=rng.choice([0.01, 1.0, 50.0])))
        f.assert_equal(slice(1, None))


def _int8_caches(jcfg, tcfg, seed, total=6, bs=4):
    """A written int8 pool per package: every layer's block 2 holds three
    rows, block 3 four."""
    jc = jd.init_paged_cache(jcfg, total, bs, kv_dtype="int8")
    tc = td.init_paged_cache(tcfg, total, bs, kv_dtype="int8", device="cpu")
    for i in range(jcfg.layers):
        for name, vals in (("k", _rows(seed + i, 7, jcfg.n_kv, jcfg.head_dim)),
                           ("v", _rows(seed + 9 + i, 7, jcfg.n_kv, jcfg.head_dim, 3.0))):
            pages = np.array([2, 2, 2, 3, 3, 3, 3], np.int32)
            offs = np.array([0, 1, 2, 0, 1, 2, 3], np.int32)
            lj = jc[str(i)]
            lj[name], lj[name + "_scale"] = jq.scatter_tokens(
                lj[name], lj[name + "_scale"], jnp.asarray(pages), jnp.asarray(offs),
                jnp.asarray(vals))
            lt = tc[str(i)]
            tq.scatter_tokens(lt[name], lt[name + "_scale"], torch.from_numpy(pages),
                              torch.from_numpy(offs), torch.from_numpy(vals))
    return jc, tc


def _assert_caches_equal(tc, jc, blocks=slice(None)):
    for i, lj in jc.items():
        assert set(tc[i]) == set(lj)
        for name, arr in lj.items():
            np.testing.assert_array_equal(tc[i][name].numpy()[blocks],
                                          np.asarray(arr)[blocks])


def test_extract_and_revive_match_the_reference_and_round_trip(model):
    jcfg, _, tcfg, _ = model
    jc, tc = _int8_caches(jcfg, tcfg, 10)
    _assert_caches_equal(tc, jc)
    want = jq.extract_block(jc, 3, jcfg.layers)
    got = tq.extract_block(tc, 3, tcfg.layers)
    for g, w in zip(got, want):
        assert g.dtype == (torch.int8 if g.dim() == 4 else torch.float32)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ptrs = [t.data_ptr() for lc in tc.values() for t in lc.values()]
    jc = jq.revive_block(jc, *want, 5)
    tq.revive_block(tc, *got, 5)
    _assert_caches_equal(tc, jc)
    assert ptrs == [t.data_ptr() for lc in tc.values() for t in lc.values()]
    for g, back in zip(got, tq.extract_block(tc, 5, tcfg.layers)):
        assert torch.equal(g, back)


@pytest.mark.parametrize("length", [1, 3])
def test_cow_copy_zeroes_the_tail_and_copies_the_scale(model, length):
    jcfg, _, tcfg, _ = model
    jc, tc = _int8_caches(jcfg, tcfg, 20)
    tq.cow_copy_block(tc, 3, 2, length)  # dst 2 holds rows of its own
    jc = jq.cow_copy_block(jc, 3, 2, length, 4)
    _assert_caches_equal(tc, jc)
    for lc in tc.values():
        assert not lc["k"][2, :, length:].any() and not lc["v"][2, :, length:].any()
        assert torch.equal(lc["k"][2, :, :length], lc["k"][3, :, :length])
        assert lc["k_scale"][2] == lc["k_scale"][3] and lc["v_scale"][2] == lc["v_scale"][3]


# -- the int8 pool leaves ----------------------------------------------------------------
@pytest.mark.parametrize("tp", [1, 2])
def test_init_paged_cache_int8_leaves(model, mesh, tp):
    jcfg, _, tcfg, _ = model
    want = jd.init_paged_cache(jcfg, TOTAL, BS, kv_dtype="int8")
    pools = (td.init_paged_cache(tcfg, TOTAL, BS, kv_dtype="int8", mesh=mesh) if tp == 2
             else [td.init_paged_cache(tcfg, TOTAL, BS, kv_dtype="int8", device="cpu")])
    assert len(pools) == tp
    for pool in pools:
        assert set(pool) == set(want)
        for i, lj in want.items():
            assert set(pool[i]) == set(lj) == {"k", "v", "k_scale", "v_scale"}
            for name, arr in lj.items():
                t = pool[i][name]
                shape = list(arr.shape)
                if name in ("k", "v"):
                    shape[1] //= tp
                assert list(t.shape) == shape and not t.any()
                assert t.dtype == (torch.int8 if name in ("k", "v") else torch.float32)
    native = td.init_paged_cache(tcfg, TOTAL, BS, kv_dtype="fp16", device="cpu")
    assert set(native["0"]) == {"k", "v"} and native["0"]["k"].dtype == torch.float32


# -- the paged programs over an int8 pool ------------------------------------------------
def _table(b, n_pages, seed):
    perm = np.random.RandomState(seed).permutation(np.arange(1, TOTAL))
    return perm[: b * n_pages].reshape(b, n_pages).astype(np.int32)


def _prefilled(jcfg, jparams, tcfg, tparams, table, seed):
    """Both packages' int8 pools after a prefill chunk of 13-20 tokens per
    table row (each row's own pages): the state the other programs read."""
    jc = jd.init_paged_cache(jcfg, TOTAL, BS, kv_dtype="int8")
    tc = td.init_paged_cache(tcfg, TOTAL, BS, kv_dtype="int8", device="cpu")
    rng = np.random.RandomState(seed)
    chunk = jax.jit(functools.partial(jd.paged_prefill_chunk, cfg=jcfg, block_size=BS,
                                      with_logits=False))
    lengths = []
    for row in range(table.shape[0]):
        n = int(rng.randint(13, 21))
        toks = np.zeros((1, 24), np.int32)
        toks[0, :n] = rng.randint(0, jcfg.vocab, size=n)
        _, jc = chunk(jparams, jnp.asarray(toks), pcache=jc,
                      table_row=jnp.asarray(table[row]), start=0, length=n)
        td.paged_prefill_chunk(tparams, torch.from_numpy(toks), tcfg, tc,
                               torch.from_numpy(table[row]), 0, n, BS, with_logits=False)
        lengths.append(n)
    return jc, tc, np.array(lengths, np.int32)


def assert_int8_pools_close(tpool, jpool):
    """Codes equal and scales within SCALE_RTOL, outside the scratch page."""
    for layer, lc in jpool.items():
        for name, arr in lc.items():
            got, want = tpool[layer][name].numpy()[1:], np.asarray(arr)[1:]
            if name.endswith("_scale"):
                np.testing.assert_allclose(got, want, rtol=SCALE_RTOL, atol=0)
            else:
                np.testing.assert_array_equal(got, want)


def test_paged_prefill_chunk_int8_matches_reference(model):
    """A chunk mid-prompt (start 13: the block it starts in grows its scale)
    with logits, over a pool a first chunk wrote."""
    jcfg, jparams, tcfg, tparams = model
    table = _table(1, 5, 1)
    jc, tc, lengths = _prefilled(jcfg, jparams, tcfg, tparams, table, 2)
    assert_int8_pools_close(tc, jc)
    start, length = int(lengths[0]), 11
    toks = np.zeros((1, 16), np.int32)
    toks[0, :length] = np.random.RandomState(3).randint(0, jcfg.vocab, size=length)
    jl, jc = jax.jit(functools.partial(jd.paged_prefill_chunk, cfg=jcfg, block_size=BS))(
        jparams, jnp.asarray(toks), pcache=jc, table_row=jnp.asarray(table[0]),
        start=start, length=length)
    tl, _ = td.paged_prefill_chunk(tparams, torch.from_numpy(toks), tcfg, tc,
                                   torch.from_numpy(table[0]), start, length, BS)
    np.testing.assert_allclose(tl.numpy()[:length], np.asarray(jl)[:length],
                               atol=LOGIT_ATOL, rtol=0)
    assert_int8_pools_close(tc, jc)


def test_paged_decode_step_int8_matches_reference(model):
    """Three decode steps over three prefilled rows and one masked lane (its
    writes land on scratch), one row crossing into a fresh block."""
    jcfg, jparams, tcfg, tparams = model
    table = _table(4, 5, 4)
    jc, tc, lengths = _prefilled(jcfg, jparams, tcfg, tparams, table[:3], 5)
    step = jax.jit(functools.partial(jd.paged_decode_step, cfg=jcfg, block_size=BS))
    pos = np.append(lengths, 0).astype(np.int32)
    pos[0] = 15  # steps at 15, 16 (offset 0 of a new block), 17
    mask = np.array([True, True, True, False])
    token = np.array([3, 50, 96, 7], np.int32)
    ptrs = [t.data_ptr() for lc in tc.values() for t in lc.values()]
    for k in range(3):
        jl, jc = step(jparams, jnp.asarray(token), pcache=jc, table=jnp.asarray(table),
                      pos=jnp.asarray(pos + k), mask=jnp.asarray(mask))
        tl, out = td.paged_decode_step(tparams, torch.from_numpy(token), tcfg, tc,
                                       torch.from_numpy(table), torch.from_numpy(pos + k),
                                       torch.from_numpy(mask), BS)
        assert out is tc
        np.testing.assert_allclose(tl.numpy()[mask], np.asarray(jl)[mask],
                                   atol=LOGIT_ATOL, rtol=0)
        assert_int8_pools_close(tc, jc)
        token = np.asarray(jl).argmax(-1).astype(np.int32)
    assert ptrs == [t.data_ptr() for lc in tc.values() for t in lc.values()]


@pytest.mark.parametrize("program", ["prefill_window", "verify_window"])
def test_paged_window_programs_int8_match_reference(model, program):
    """The batched window programs: ragged lengths, one inactive lane,
    windows starting mid-block over prefilled rows."""
    jcfg, jparams, tcfg, tparams = model
    table = _table(4, 5, 6)
    jc, tc, lengths = _prefilled(jcfg, jparams, tcfg, tparams, table, 7)
    w = 8
    tokens = np.random.RandomState(8).randint(0, jcfg.vocab, size=(4, w)).astype(np.int32)
    pos = lengths.copy()
    win = np.array([8, 5, 8, 3], np.int32)
    mask = np.array([True, True, False, True])
    args = dict(table=jnp.asarray(table), pos=jnp.asarray(pos), lengths=jnp.asarray(win),
                mask=jnp.asarray(mask))
    targs = [torch.from_numpy(x) for x in (table, pos, win, mask)]
    fn = getattr(jd, "paged_" + program)
    out = jax.jit(functools.partial(fn, cfg=jcfg, block_size=BS))(
        jparams, jnp.asarray(tokens), pcache=jc, **args)
    got = getattr(td, "paged_" + program)(tparams, torch.from_numpy(tokens), tcfg, tc,
                                          *targs, BS)
    if program == "verify_window":
        (jl, jc), (tl, _) = out, got
        for row in np.flatnonzero(mask):
            n = win[row]
            np.testing.assert_allclose(tl.numpy()[row, :n], np.asarray(jl)[row, :n],
                                       atol=LOGIT_ATOL, rtol=0)
    else:
        jc = out
    assert_int8_pools_close(tc, jc)


def _scales(pool):
    return [lc[n] for lc in pool.values() for n in ("k_scale", "v_scale")]


@pytest.mark.multidevice
@pytest.mark.parametrize("program", ["prefill_chunk", "decode_step", "prefill_window"])
def test_tp2_programs_keep_the_shards_scales_equal(model, mesh, program):
    """At tp=2 the funnel takes the max over the shards: after each program
    the two shards' scale copies are equal to each other and to tp=1's, the
    shards' codes are tp=1's KV-head halves, and the logits tp=1's."""
    _, _, tcfg, tparams = model
    params2, _, tp = td.place_tp(tparams, tcfg, mesh)
    one = td.init_paged_cache(tcfg, TOTAL, BS, kv_dtype="int8", device="cpu")
    two = td.init_paged_cache(tcfg, TOTAL, BS, kv_dtype="int8", mesh=mesh)
    table = torch.from_numpy(_table(3, 5, 9))
    rng = np.random.RandomState(10)
    toks = torch.from_numpy(rng.randint(0, tcfg.vocab, size=(1, 16)).astype(np.int32))
    for (pool, params, tp_) in ((one, tparams, None), (two, params2, tp)):
        for row in range(3):
            td.paged_prefill_chunk(params, toks, tcfg, pool, table[row], 0, 13, BS,
                                   with_logits=False, tp=tp_)
    logits = []
    for (pool, params, tp_) in ((one, tparams, None), (two, params2, tp)):
        if program == "prefill_chunk":
            lg, _ = td.paged_prefill_chunk(params, toks, tcfg, pool, table[1], 13, 9, BS,
                                           tp=tp_)
        elif program == "decode_step":
            lg = None
            for k in range(3):
                lg, _ = td.paged_decode_step(params, toks[0, :3].contiguous(), tcfg, pool,
                                             table, torch.tensor([13, 14, 15]) + k,
                                             torch.tensor([True, False, True]), BS, tp=tp_)
        else:
            td.paged_prefill_window(params, toks[:, :8].repeat(3, 1), tcfg, pool, table,
                                    torch.tensor([13, 13, 20], dtype=torch.int32),
                                    torch.tensor([8, 4, 6], dtype=torch.int32),
                                    torch.tensor([True, True, False]), BS, tp=tp_)
            lg = None
        logits.append(lg)
    if logits[0] is not None:
        np.testing.assert_allclose(logits[1].numpy(), logits[0].numpy(), atol=LOGIT_ATOL,
                                   rtol=0)
    for a, b, c in zip(_scales(two[0]), _scales(two[1]), _scales(one)):
        assert torch.equal(a, b) and torch.equal(a[1:], c[1:])
    half = tcfg.n_kv // 2
    for s, pool in enumerate(two):
        for i, lc in pool.items():
            for n in ("k", "v"):
                assert torch.equal(lc[n][1:], one[i][n][1:, s * half:(s + 1) * half])


# -- the bounded-divergence oracle -------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_measure_divergence_matches_the_reference_report(model, seed):
    """The reference test's three prompts: the port's report against the
    JAX report (not its gate: seed 1 measures top-1 agreement 8/9 there)."""
    jcfg, jparams, tcfg, tparams = model
    prompt = [1 + (seed * 11 + j * 5) % 90 for j in range(9)]
    want = jdiv.measure_divergence(jparams, jcfg, prompt, steps=8, block_size=8)
    got = tdiv.measure_divergence(tparams, tcfg, prompt, steps=8, block_size=8, device="cpu")
    assert got.tokens_compared == want.tokens_compared == 9
    np.testing.assert_allclose(got.per_token_delta, want.per_token_delta,
                               atol=ORACLE_ATOL, rtol=0)
    assert got.top1_agreement == want.top1_agreement
    assert abs(got.mean_abs_logit_delta - want.mean_abs_logit_delta) <= ORACLE_ATOL
    assert got.max_abs_logit_delta > 0.0 and got.within(max_delta=tdiv.MAX_ABS_LOGIT_DELTA,
                                                        min_agreement=0.0)


def test_divergence_report_and_stream_comparison_as_the_reference():
    assert (tdiv.MAX_ABS_LOGIT_DELTA, tdiv.MIN_TOP1_AGREEMENT) == (
        jdiv.MAX_ABS_LOGIT_DELTA, jdiv.MIN_TOP1_AGREEMENT)
    for args in ((4, 0.7, 0.1, 1.0, [0.7] * 4), (9, 0.07, 0.01, 8 / 9, [0.07] * 9)):
        got, want = tdiv.DivergenceReport(*args), jdiv.DivergenceReport(*args)
        assert got.within() == want.within() and got.summary() == want.summary()
        assert got.within(max_delta=1.0, min_agreement=0.5) == want.within(1.0, 0.5)
    for a, b in (([1, 2, 3, 4], [1, 2, 9, 4]), ([], []), ([1, 2], [1, 2, 3])):
        assert tdiv.compare_output_streams(a, b) == jdiv.compare_output_streams(a, b)


# -- the int8 engine against the JAX int8 engine -----------------------------------------
def port(model, mesh=None, **kw):
    _, _, tcfg, tparams = model
    kw = dict(ENGINE, **kw)
    if mesh is None:
        kw["device"] = "cpu"
    return DecodeServer(tparams, tcfg, mesh=mesh, **kw)


def ref(model, **kw):
    jcfg, jparams, _, _ = model
    return JaxServer(jparams, jcfg, **JAX_OFF, **dict(ENGINE, **kw))


def drive(server, reqs, idle_ticks=4):
    """Submit everything, tick to completion on this thread, then idle."""
    futs = [server.submit(p, max_new=n) for p, n in reqs]
    for _ in range(4000):
        if all(f.done() for f in futs):
            break
        server._tick()
    outs = [f.result(timeout=5) for f in futs]
    for _ in range(idle_ticks):
        server._tick()
    return outs


def run_seq(server, reqs):
    """Serve `reqs` one after another (each turn sees the last one's tree)."""
    return [drive(server, [r])[0] for r in reqs]


def counters(server, names=COUNTERS):
    return {c: getattr(server, c) for c in names}


CASES = {
    # name: (engine kwargs, requests, served one by one)
    "defaults": ({}, [(p, 6) for p in PROMPTS], False),
    "radix_cow": ({}, [(DONOR, 6), (DIV, 6), (DONOR[:20], 6)], True),
    "spill": (dict(total_blocks=1 + 6, n_slots=1),
              [(SPILL_DONOR, 4), (FILLER, 4), (SPILL_DONOR, 4), (DIV, 4)], True),
    "bursts": (dict(steps_per_dispatch=2), [(p, 14 + 4 * i) for i, p in enumerate(PROMPTS)],
               False),
    "spec": (dict(spec_k=4, spec_sync=True),
             [(DONOR, 16), (DONOR, 16), (REPEAT, 20)], True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_int8_engine_equals_the_jax_int8_engine(model, case):
    kw, reqs, serial = CASES[case]
    serve = run_seq if serial else drive
    jsrv = ref(model, kv_dtype="int8", **kw)
    want = serve(jsrv, reqs)
    tsrv = port(model, kv_dtype="int8", **kw)
    assert serve(tsrv, reqs) == want
    names = COUNTERS + (SPEC_COUNTERS if "spec_k" in kw else ())
    assert counters(tsrv, names) == counters(jsrv, names)
    engaged = {"defaults": tsrv.steps_run, "radix_cow": tsrv.prefix_cow_hits,
               "spill": tsrv.revives, "bursts": tsrv.burst_dispatches,
               "spec": tsrv.spec_tokens_accepted}
    assert engaged[case] > 0 and tsrv.kv_quant_enabled == 1


@pytest.mark.multidevice
@pytest.mark.parametrize("case", ["defaults", "spill"])
def test_int8_engine_at_tp2_equals_the_jax_engine(model, mesh, case):
    """tp=2 (two CPU shards): the JAX int8 engine's tokens and counters, and
    the shards' scale copies equal after serving."""
    kw, reqs, serial = CASES[case]
    serve = run_seq if serial else drive
    jsrv = ref(model, kv_dtype="int8", **kw)
    want = serve(jsrv, reqs)
    shd = port(model, mesh=mesh, kv_dtype="int8", **kw)
    assert serve(shd, reqs) == want
    assert counters(shd) == counters(jsrv)
    for a, b in zip(_scales(shd.cache[0]), _scales(shd.cache[1])):
        assert torch.equal(a, b)
    assert any(s[1:].any() for s in _scales(shd.cache[0]))


# -- the int8 engine's byte accounting ---------------------------------------------------
def test_payload_tag_rejection_both_ways(model):
    q = port(model, kv_dtype="int8")
    k = torch.zeros((2, 2, 8, 8))
    assert not q._payload_matches((k, k)) and not q._dispatch_revive((k, k), 1)
    assert not q._payload_matches(("fp16", k, k, k[0, 0, 0], k[0, 0, 0]))
    assert not q._dispatch_revive(("fp16", k, k, k[0, 0, 0], k[0, 0, 0]), 1)
    assert q.kv_quant_payload_rejected == 2 and q.h2d_uploads == 0
    n = port(model)
    codes, s = torch.zeros((2, 2, 8, 8), dtype=torch.int8), torch.ones(2)
    assert not n._payload_matches(("int8", codes, codes, s, s))
    assert not n._dispatch_revive(("int8", codes, codes, s, s), 1)
    assert n.kv_quant_payload_rejected == 1


def test_chain_keys_are_salted_with_the_pool_dtype(model):
    """An int8 engine keys its blocks in the reference's "int8:" key space,
    disjoint from a native engine's."""
    q, n = port(model, kv_dtype="int8"), port(model)
    assert q._block_mgr.key_salt == ref(model, kv_dtype="int8")._block_mgr.key_salt == "int8:"
    assert n._block_mgr.key_salt == ref(model)._block_mgr.key_salt == ""
    drive(q, [(DONOR, 4)])
    drive(n, [(DONOR, 4)])
    want = set(prompt_chain_keys(DONOR, 8, salt="int8:"))
    assert want and want <= q.prefix_keys()
    assert q.prefix_keys().isdisjoint(n.prefix_keys())


def test_bytes_per_block_and_spill_bytes_follow_the_reference(model):
    """`_bytes_per_block` is the reference's formula (codes plus one f32
    scale per layer and k|v), the spilled payloads' nbytes and the tier's
    host bytes add up to it, and an int8 block is under 0.55x a native
    one (f32 here, so about a quarter)."""
    jcfg = model[0]
    tight = dict(total_blocks=1 + 6, n_slots=1, spill_blocks=16)
    q, n = port(model, kv_dtype="int8", **tight), port(model, **tight)
    jsrv = ref(model, kv_dtype="int8", **tight)
    assert q._bytes_per_block == jsrv._bytes_per_block == jcfg.layers * 2 * (
        jcfg.n_kv * 8 * jcfg.head_dim + 4)
    assert n._bytes_per_block == ref(model, **tight)._bytes_per_block
    assert q._bytes_per_block < 0.55 * n._bytes_per_block
    run_seq(q, [(SPILL_DONOR, 4), (FILLER, 4), (SPILL_DONOR, 4)])
    assert len(q.spill_tier) > 0
    assert q.spill_host_bytes == len(q.spill_tier) * q._bytes_per_block
    payload, nbytes = q._extract_block(1)
    assert payload[0] == "int8" and nbytes == q._bytes_per_block
    assert [t.dtype for t in payload[1:]] == [torch.int8] * 2 + [torch.float32] * 2


def test_default_engine_is_the_explicit_fp16_engine(model):
    """The default pool is the native one, bit for bit the explicit "fp16"
    engine's, and an int8 pool of the same shape takes at most 1/1.9 of its
    bytes (the reference's gate; about a quarter against f32)."""
    reqs = [(p, 5) for p in PROMPTS]
    a, b = port(model), port(model, kv_dtype="fp16")
    assert drive(a, reqs) == drive(b, reqs)
    assert counters(a) == counters(b) and a.kv_quant_enabled == 0
    for la, lb in zip(a.cache.values(), b.cache.values()):
        for n in ("k", "v"):
            assert torch.equal(la[n], lb[n])
    q = port(model, kv_dtype="int8")
    assert a.kv_pool_bytes / q.kv_pool_bytes >= 1.9
    assert q.kv_pool_bytes == ref(model, kv_dtype="int8").kv_pool_bytes


def test_block_copies_and_reset_write_the_int8_pool_in_place(model):
    """`_extract_block` then `_dispatch_revive` (four counted uploads)
    round-trips a block's codes and scales; `_cow_copy` zeroes the
    destination's tail and copies the source's scales; an error reset zeroes
    codes and scales. No pool tensor is rebound."""
    server = port(model, kv_dtype="int8", total_blocks=8)
    gen = torch.Generator().manual_seed(0)
    for layer in server.cache.values():
        for name, t in layer.items():
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen) if name in ("k", "v")
                    else torch.rand(t.shape, generator=gen))
    ptrs = [t.data_ptr() for layer in server.cache.values() for t in layer.values()]
    before = {i: {n: t.clone() for n, t in layer.items()} for i, layer in server.cache.items()}
    payload, nbytes = server._extract_block(3)
    assert nbytes == server._bytes_per_block and server.blocking_syncs == 1
    assert server._dispatch_revive(payload, 5) and server.h2d_uploads == 4
    server._cow_copy(2, 6, 5)
    for i, layer in server.cache.items():
        old = before[i]
        for n, t in layer.items():
            assert torch.equal(t[5], old[n][3])
            assert torch.equal(t[6], old[n][2]) if n.endswith("_scale") else (
                torch.equal(t[6, :, :5], old[n][2, :, :5]) and not t[6, :, 5:].any())
    assert ptrs == [t.data_ptr() for layer in server.cache.values() for t in layer.values()]
    server._reset_device_state()
    assert all(not t.any() for layer in server.cache.values() for t in layer.values())
    assert ptrs == [t.data_ptr() for layer in server.cache.values() for t in layer.values()]
