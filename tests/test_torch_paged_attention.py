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
