"""The port's paged attention (nos_tpu_torch/ops/paged_attention.py) against
the JAX reference (nos_tpu/ops/paged_attention.py) on the CPU.

The port's plain versions are held against the reference's gather
formulations (`_reference`, `_window_reference`) and against its Pallas
kernels run in interpret mode, as tests/test_paged_attention.py runs them:
native and int8-scaled pools, GQA, ragged limits and window lengths, masked
lanes and tables that point past a sequence's allocation at the scratch
page. float32 throughout, atol 1e-5 (summation order only).

The CUDA kernels themselves run only on the card: tests/test_torch_kernels.py
holds them against these plain versions there (and skips here)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.ops import paged_attention as jpa
from nos_tpu_torch.ops import paged_attention as tpa

from test_torch_dense_decode import SPLIT_KEYS, split_decode

ATOL = 1e-5

# The reference's functions compiled whole: one compile per shape instead
# of one per eager op (the Pallas kernels in interpret mode, as
# tests/test_paged_attention.py runs them).
J_REF = jax.jit(jpa._reference)
J_PALLAS = jax.jit(functools.partial(jpa._pallas, interpret=True))
J_WINDOW_REF = jax.jit(jpa._window_reference)
J_WINDOW_PALLAS = jax.jit(functools.partial(jpa._window_pallas, interpret=True))


def make_pool(rng, total, nkv, bs, hd, quant):
    """Native f32 pools, or int8 codes with per-block f32 scales."""
    if quant:
        k = rng.randint(-127, 128, size=(total, nkv, bs, hd)).astype(np.int8)
        v = rng.randint(-127, 128, size=(total, nkv, bs, hd)).astype(np.int8)
        ks = (rng.rand(total) * 0.05 + 0.001).astype(np.float32)
        vs = (rng.rand(total) * 0.05 + 0.001).astype(np.float32)
        return k, v, ks, vs
    k = rng.randn(total, nkv, bs, hd).astype(np.float32)
    v = rng.randn(total, nkv, bs, hd).astype(np.float32)
    return k, v, None, None


def make_table(rng, b, n_pages, total, shared=True):
    """Random page ownership; rows beyond a row's allocation point at the
    scratch page 0; with `shared`, row 1 maps row 0's first page (prefix
    sharing: one block in two tables)."""
    perm = rng.permutation(np.arange(1, total))
    table = np.zeros((b, n_pages), dtype=np.int32)
    owned = rng.randint(1, n_pages + 1, size=b)
    k = 0
    for row in range(b):
        for p in range(owned[row]):
            table[row, p] = perm[k % len(perm)]
            k += 1
    if shared and b > 1:
        table[1, 0] = table[0, 0]
        owned[1] = max(owned[1], 1)
    return table, owned


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


DECODE_SHAPES = [
    (4, 8, 8, 64, 32, 4, 24),    # MHA
    (8, 8, 2, 64, 32, 4, 40),    # GQA rep=4, the serving model's head layout
    (2, 16, 16, 128, 16, 8, 20), # wide heads, small blocks
    (1, 4, 4, 64, 64, 2, 4),     # single row
]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("b,nh,nkv,hd,bs,n_pages,total", DECODE_SHAPES)
def test_decode_plain_matches_reference_and_pallas(b, nh, nkv, hd, bs, n_pages, total, quant):
    rng = np.random.RandomState(b * 100 + hd)
    q = rng.randn(b, nh, hd).astype(np.float32)
    k, v, ks, vs = make_pool(rng, total, nkv, bs, hd, quant)
    table, owned = make_table(rng, b, n_pages, total)
    limit = np.array([rng.randint(1, o * bs + 1) for o in owned], dtype=np.int32)
    got = tpa._reference(_t(q), _t(k), _t(v), _t(table), _t(limit), _t(ks), _t(vs))
    args = (_j(q), _j(k), _j(v), _j(table), _j(limit))
    want_ref = J_REF(*args, k_scale=_j(ks), v_scale=_j(vs))
    want_pallas = J_PALLAS(*args, k_scale=_j(ks), v_scale=_j(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), atol=ATOL, rtol=0)


def test_decode_limit_one_and_scratch_rows():
    """limit=1 attends exactly the first position of page 0; rows whose
    tables run into the scratch page stay row-local."""
    rng = np.random.RandomState(7)
    q = rng.randn(3, 8, 64).astype(np.float32)
    k, v, _, _ = make_pool(rng, 10, 4, 32, 64, False)
    table, _ = make_table(rng, 3, 6, 10, shared=False)
    for limit in ([1, 1, 1], [5, 40, 33]):
        limit = np.asarray(limit, np.int32)
        got = tpa._reference(_t(q), _t(k), _t(v), _t(table), _t(limit))
        want = J_PALLAS(_j(q), _j(k), _j(v), _j(table), _j(limit))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


WINDOW_SHAPES = [
    (3, 8, 2, 64, 32, 6, 30, 16),   # GQA rep=4, a bucket-16 window
    (2, 4, 4, 64, 16, 8, 20, 8),    # MHA, small blocks
    (1, 8, 2, 64, 32, 4, 8, 32),    # one sequence (the prefill-chunk shape)
]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("b,nh,nkv,hd,bs,n_pages,total,w", WINDOW_SHAPES)
def test_window_plain_matches_reference_and_pallas(b, nh, nkv, hd, bs, n_pages, total, w,
                                                   quant):
    rng = np.random.RandomState(b * 10 + w)
    q = rng.randn(b, nh, w, hd).astype(np.float32)
    k, v, ks, vs = make_pool(rng, total, nkv, bs, hd, quant)
    table, owned = make_table(rng, b, n_pages, total)
    # Ragged windows inside each row's allocation, one masked lane.
    lengths = np.array([rng.randint(1, w + 1) for _ in range(b)], np.int32)
    pos = np.array(
        [rng.randint(0, max(1, o * bs - w) + 1) for o in owned], np.int32
    )
    mask = np.ones((b,), bool)
    if b > 1:
        mask[-1] = False
    t_args = (_t(q), _t(k), _t(v), _t(table), _t(pos), _t(lengths), _t(mask))
    j_args = (_j(q), _j(k), _j(v), _j(table), _j(pos), _j(lengths), _j(mask))
    got = tpa._window_reference(*t_args, _t(ks), _t(vs))
    want_ref = J_WINDOW_REF(*j_args, k_scale=_j(ks), v_scale=_j(vs))
    want_pallas = J_WINDOW_PALLAS(*j_args, k_scale=_j(ks), v_scale=_j(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), atol=ATOL, rtol=0)


def test_public_entry_points_take_the_plain_version_on_cpu():
    """CPU tensors reach the plain versions and launch nothing."""
    rng = np.random.RandomState(3)
    q = rng.randn(2, 4, 2, 16).astype(np.float32)
    k, v, _, _ = make_pool(rng, 6, 2, 8, 16, False)
    table, _ = make_table(rng, 2, 3, 6)
    pos = np.array([0, 3], np.int32)
    lengths = np.array([2, 1], np.int32)
    mask = np.array([True, True])
    before = dict(tpa.LAUNCHES)
    got = tpa.paged_window_attention(_t(q), _t(k), _t(v), _t(table), _t(pos),
                                     _t(lengths), _t(mask))
    want = tpa._window_reference(_t(q), _t(k), _t(v), _t(table), _t(pos),
                                 _t(lengths), _t(mask))
    assert torch.equal(got, want)
    got = tpa.paged_decode_attention(_t(q[:, :, 0]), _t(k), _t(v), _t(table), _t(pos + 1))
    want = tpa._reference(_t(q[:, :, 0]), _t(k), _t(v), _t(table), _t(pos + 1))
    assert torch.equal(got, want)
    assert tpa.LAUNCHES == before


# -- the window kernel's routes and its mma route's arithmetic -----------------
@pytest.mark.parametrize("q_dtype,pool_dtype,hd,route", [
    ("bfloat16", "bfloat16", 64, "mma"),
    ("bfloat16", "bfloat16", 128, "mma"),
    ("bfloat16", "bfloat16", 256, "mma"),
    ("float32", "float32", 64, "simt"),
    ("float32", "float32", 256, "simt"),
    ("bfloat16", "int8", 64, "mma"),
    ("bfloat16", "int8", 128, "mma"),
    ("bfloat16", "int8", 256, "mma"),
    ("bfloat16", "int8", 96, "simt"),
    ("float32", "int8", 128, "simt"),
    ("bfloat16", "bfloat16", 96, "simt"),
    ("bfloat16", "bfloat16", 32, "simt"),
])
def test_window_route(q_dtype, pool_dtype, hd, route):
    """`_window_route` depends on dtypes and head_dim alone: the tensor-core
    kernel for a bf16 q over a bf16 pool, or over an int8 pool with its
    scales, at head_dim 64, 128 or 256."""
    q = torch.zeros((1, 4, 2, hd), dtype=getattr(torch, q_dtype))
    pool = torch.zeros((3, 2, 8, hd), dtype=getattr(torch, pool_dtype))
    scale = torch.ones(3) if pool_dtype == "int8" else None
    assert tpa._window_route(q, pool, scale) == route


# chip_smoke.py's `held` bounds for a bf16 window against its plain version.
HELD_TOL, HELD_RTOL = 5e-3, 2e-2


def _mma_window(q, pool_k, pool_v, table, pos, lengths, mask, tile=64, parts=2, terms=3):
    """The window kernel's mma-route arithmetic on the CPU: per (b, g) the
    group's rows stream the keys in `tile`-key stages, each cut into
    `parts` slices with their own online softmax (one warp each), merged at
    the end; S is the bf16 q k^T summed in f32, then times the scale; the
    weights are exp2((s - m) log2 e), zeroed where masked; P enters PV as
    `terms` bf16 terms (hi, mid, lo); out = acc / max(l, 1e-30) in bf16."""
    b, nh, w, hd = q.shape
    nkv = pool_k.shape[1]
    rep = nh // nkv
    keys = tpa._gather_pool(pool_k, table, None, q.dtype).float()  # [B, nkv, S, hd]
    vals = tpa._gather_pool(pool_v, table, None, q.dtype).float()
    n_stream = keys.shape[2]
    offs = torch.arange(w)
    out = torch.empty((b, nh, w, hd))
    for bi in range(b):
        valid = (offs < int(lengths[bi])) & bool(mask[bi])
        lim = torch.where(valid, int(pos[bi]) + offs + 1, torch.ones_like(offs))
        lim = lim.clamp(max=n_stream).repeat(rep)  # rows r * W + w
        n_keys = int(lim.max())
        for g in range(nkv):
            rows = q[bi, g * rep:(g + 1) * rep].float().reshape(rep * w, hd)
            states = []
            for part in range(parts):
                m = torch.full((rep * w,), NEG_INF)
                l = torch.zeros(rep * w)
                acc = torch.zeros((rep * w, hd))
                for j0 in range(part * tile // parts, n_keys, tile):
                    idx = torch.arange(j0, min(j0 + tile // parts, n_stream))
                    ok = idx[None, :] < lim[:, None]
                    s = torch.where(ok, (rows @ keys[bi, g, idx].T) * hd ** -0.5,
                                    torch.tensor(NEG_INF))
                    m_new = torch.maximum(m, s.max(dim=1).values)
                    p = torch.where(ok, torch.exp2((s - m_new[:, None]) * LOG2E),
                                    torch.tensor(0.0))
                    alpha = torch.exp2((m - m_new) * LOG2E)
                    l = l * alpha + p.sum(dim=1)
                    pv = torch.zeros_like(acc)
                    for _ in range(terms):
                        term = p.to(torch.bfloat16).float()
                        pv += term @ vals[bi, g, idx]
                        p = p - term
                    acc = acc * alpha[:, None] + pv
                    m = m_new
                states.append((m, l, acc))
            m, l, acc = states[0]
            for m2, l2, acc2 in states[1:]:
                m_new = torch.maximum(m, m2)
                a1, a2 = torch.exp(m - m_new), torch.exp(m2 - m_new)
                m, l, acc = m_new, l * a1 + l2 * a2, acc * a1[:, None] + acc2 * a2[:, None]
            o = acc / l.clamp_min(1e-30)[:, None]
            out[bi, g * rep:(g + 1) * rep] = o.reshape(rep, w, hd)
    return out.to(q.dtype)


NEG_INF = -1e30
LOG2E = 1.4426950408889634


@pytest.mark.parametrize("w", [16, 64])
def test_window_mma_arithmetic_within_the_card_bounds(w):
    """The mma route's arithmetic (bf16 inputs, scale after the product,
    three bf16 terms of P, two key slices merged) against the plain
    version at the kernel phase's heads (nh 8, nkv 2, hd 64, bs 32) on a
    reduced pool, ragged lengths and masked lanes: within chip_smoke.py's
    bf16 `held` bounds, the gate the card holds the kernel to."""
    rng = np.random.RandomState(w)
    nh, nkv, hd, bs = 8, 2, 64, 32
    pos = np.array([0, 31, 33, 70, 100, 5], np.int32)
    lengths = np.array([w, 1, w - 3, w, 5, w // 2], np.int32)
    mask = np.array([True, True, True, False, True, False])
    b = len(pos)
    n_pages = -(-(int(pos.max()) + w) // bs) + 1
    total = 1 + b * n_pages
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    q = bf(rng.randn(b, nh, w, hd))
    k, v = bf(rng.randn(total, nkv, bs, hd)), bf(rng.randn(total, nkv, bs, hd))
    table = torch.from_numpy(rng.permutation(np.arange(1, total))[: b * n_pages]
                             .reshape(b, n_pages).astype(np.int32))
    args = (table, torch.from_numpy(pos), torch.from_numpy(lengths), torch.from_numpy(mask))
    got = _mma_window(q, k, v, *args)
    want = tpa._window_reference(q, k, v, *args)
    err = (got.float() - want.float()).abs().max().item()
    assert torch.isfinite(got.float()).all()
    assert err <= HELD_TOL and err / want.float().abs().max().item() <= HELD_RTOL, err


def test_window_one_bf16_term_of_p_would_miss_the_bound():
    """Why P enters PV as three bf16 terms: on the same inputs, one bf16
    rounding of P moves outputs near 1 by a bf16 step, past the bound."""
    rng = np.random.RandomState(64)
    w, nh, nkv, hd, bs = 64, 8, 2, 64, 32
    pos = np.array([0, 31, 33, 70, 100, 5], np.int32)
    lengths = np.array([w, 1, w - 3, w, 5, w // 2], np.int32)
    mask = np.array([True, True, True, False, True, False])
    b = len(pos)
    n_pages = -(-(int(pos.max()) + w) // bs) + 1
    total = 1 + b * n_pages
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    q = bf(rng.randn(b, nh, w, hd))
    k, v = bf(rng.randn(total, nkv, bs, hd)), bf(rng.randn(total, nkv, bs, hd))
    table = torch.from_numpy(rng.permutation(np.arange(1, total))[: b * n_pages]
                             .reshape(b, n_pages).astype(np.int32))
    args = (table, torch.from_numpy(pos), torch.from_numpy(lengths), torch.from_numpy(mask))
    want = tpa._window_reference(q, k, v, *args)
    err = (_mma_window(q, k, v, *args, terms=1).float() - want.float()).abs().max().item()
    assert err > HELD_TOL


def test_window_two_bf16_terms_of_p_can_miss_the_bound():
    """Why a third term: at the card gate's shapes (chip_smoke.py
    phase_kernels, W 16: an 8192-position pool of 32-key pages, eight lanes
    with ragged lengths and two masked), on this draw hi + lo of P (16 bits)
    moves an output in [1, 2) by a bf16 step (2^-7), past the bound; three
    terms stay within it."""
    rng = np.random.RandomState(3)
    b, w, nh, nkv, hd, bs = 8, 16, 8, 2, 64, 32
    n_pages = 8192 // bs
    total = 1 + b * n_pages
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    k, v = bf(rng.randn(total, nkv, bs, hd)), bf(rng.randn(total, nkv, bs, hd))
    table = torch.from_numpy(rng.permutation(np.arange(1, total))[: b * n_pages]
                             .reshape(b, n_pages).astype(np.int32))
    table[1, :8] = table[0, :8]  # a shared prefix, as the gate's table has
    q = bf(rng.randn(b, nh, w, hd))
    pos = torch.tensor([0, 31, 33, 1000, 2047, 4096, 7000, 8192 - w], dtype=torch.int32)
    lengths = torch.tensor([w, 1, w - 3, w, 5, w, w // 2, w], dtype=torch.int32)
    mask = torch.tensor([True, True, True, False, True, True, False, True])
    args = (table, pos, lengths, mask)
    want = tpa._window_reference(q, k, v, *args).float()
    err = {t: (_mma_window(q, k, v, *args, terms=t).float() - want).abs().max().item()
           for t in (2, 3)}
    assert err[2] > HELD_TOL and err[3] <= HELD_TOL, err


# -- the split decode kernel's arithmetic (csrc/split_decode.cuh) ----------------
K = SPLIT_KEYS


def paged_split_decode(q, pool_k, pool_v, table, limit, k_scale=None, v_scale=None):
    """`split_decode` as the paged kernel runs it: key j of lane b is row
    j % bs of page table[b, j / bs], an int8 pool dequantized by its
    block's scale in f32, n_keys = min(limit, n_pages bs); limit <= 0
    leaves no key (zeros)."""
    keys = tpa._gather_pool(pool_k, table, k_scale, torch.float32).float()
    vals = tpa._gather_pool(pool_v, table, v_scale, torch.float32).float()
    n_keys = limit.long().clamp(min=0, max=keys.shape[2])
    return split_decode(q, keys, vals, n_keys, [False] * q.shape[0])


def _split_case(seed, nkv, quant, bs=32):
    """Four lanes of nh 8 at head_dim 32 over a pool whose tables address
    3 K + 10 keys, from a numpy seed."""
    rng = np.random.RandomState(seed)
    b, nh, hd = 4, 8, 32
    n_pages = -(-(3 * K + 10) // bs)
    total = 1 + b * n_pages
    q = rng.randn(b, nh, hd).astype(np.float32)
    k, v, ks, vs = make_pool(rng, total, nkv, bs, hd, quant)
    table = rng.permutation(np.arange(1, total))[: b * n_pages].reshape(b, n_pages)
    return q, k, v, ks, vs, table.astype(np.int32), n_pages * bs


@pytest.mark.parametrize("limits", [
    [1, K - 1, K, K + 1],                  # the first split's edge
    [2 * K - 1, 2 * K, 2 * K + 1, 3 * K],  # the second's, and three splits
    [5, 2 * K + 3, K, 77],                 # a ragged mix
    ["keys", "keys+9", 2 * K, 0],          # every key, past them, and 0 (zeros)
])
@pytest.mark.parametrize("quant", [False, True])
def test_split_arithmetic_matches_jax(limits, quant):
    """The split-and-combine arithmetic over the pool against the JAX
    package's `_pallas` (interpret mode) and `_reference`, f32 q, native or
    int8 pools with per-block scales, at the split boundaries: atol 1e-5
    (summation order only). Limit 0: zeros, as `_pallas` gives (every
    weight masked); `_reference` is held on the other lanes."""
    q, k, v, ks, vs, table, keys = _split_case(3, 2, quant)
    lim = np.array([keys if x == "keys" else keys + 9 if x == "keys+9" else x for x in limits],
                   np.int32)
    got = paged_split_decode(_t(q), _t(k), _t(v), _t(table), _t(lim), _t(ks), _t(vs)).numpy()
    args = (_j(q), _j(k), _j(v), _j(table), _j(lim))
    want_pallas = np.asarray(J_PALLAS(*args, k_scale=_j(ks), v_scale=_j(vs)))
    want_ref = np.asarray(J_REF(*args, k_scale=_j(ks), v_scale=_j(vs)))
    np.testing.assert_allclose(got, want_pallas, atol=ATOL, rtol=0)
    live = lim > 0
    np.testing.assert_allclose(got[live], want_ref[live], atol=ATOL, rtol=0)
    assert (got[~live] == 0).all()


@pytest.mark.parametrize("quant", [False, True])
def test_split_bits_equal_per_head_across_nkv(quant):
    """The split boundaries depend on the position alone: each head's output
    from the whole pool (nkv 2) equals, bit for bit, its shard's output
    (nkv 1 per shard, the head slices of every block) at the split edges."""
    q, k, v, ks, vs, table, keys = _split_case(5, 2, quant)
    lim = _t(np.array([K - 1, K + 1, 2 * K, keys], np.int32))
    whole = paged_split_decode(_t(q), _t(k), _t(v), _t(table), lim, _t(ks), _t(vs))
    for s in range(2):
        heads = slice(4 * s, 4 * s + 4)
        shard = paged_split_decode(_t(q[:, heads]), _t(k[:, s:s + 1]), _t(v[:, s:s + 1]),
                                   _t(table), lim, _t(ks), _t(vs))
        assert torch.equal(shard, whole[:, heads])


def test_split_combine_planted_faults_fail():
    """The check above can fail: dropping a lane's last split, or combining
    the splits without their e^{m_s - M} weights, moves the output past
    atol 1e-5 against `_pallas`."""
    q, k, v, _, _, table, keys = _split_case(9, 2, False)
    lim = np.array([K + 1, 2 * K + 1, 3 * K, keys], np.int32)
    want = np.asarray(J_PALLAS(_j(q), _j(k), _j(v), _j(table), _j(lim)))
    short = paged_split_decode(_t(q), _t(k), _t(v), _t(table), _t(lim - 1))
    assert np.abs(short.numpy() - want).max() > ATOL
    keys_f = tpa._gather_pool(_t(k), _t(table), None, torch.float32)
    vals_f = tpa._gather_pool(_t(v), _t(table), None, torch.float32)
    unweighted = torch.zeros_like(_t(q))
    for bi in range(4):
        for g in range(2):
            rows = _t(q)[bi, 4 * g:4 * g + 4]
            num, den = 0, 0
            for s0 in range(0, int(lim[bi]), K):
                idx = torch.arange(s0, min(s0 + K, int(lim[bi])))
                p = torch.softmax((rows @ keys_f[bi, g, idx].T) * 32 ** -0.5, dim=1)
                num, den = num + p @ vals_f[bi, g, idx], den + 1
            unweighted[bi, 4 * g:4 * g + 4] = num / den
    assert np.abs(unweighted.numpy() - want).max() > ATOL
