"""The port's flash attention (nos_tpu_torch/ops/flash_attention.py) against
the JAX reference (nos_tpu/ops/flash_attention.py) on the CPU.

The same numpy inputs go to both sides. The port's plain versions of the
three kernels are held against the Pallas kernels run in interpret mode
(as tests/test_flash_attention.py runs them), and the port's autograd
(`_Flash` through the plain versions) against `jax.vjp` through the
reference's `flash_attention`. Bound: max|err| <= tol * max(1, max|want|),
tol 1e-5 in f32 (summation order) and 2e-2 in bf16 (JAX's own criterion,
tests/test_flash_attention.py:45: one bf16 rounding of each output, and the
weights' rounding before PV taken at a different max)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu_torch.ops import flash_attention as tfa

FA = importlib.import_module("nos_tpu.ops.flash_attention")

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CASES = [
    ((1, 2, 256, 64), True),
    ((1, 2, 256, 64), False),
    ((1, 2, 177, 64), True),   # ragged: the reference pads, the port masks
    ((1, 2, 160, 128), True),
]


def _inputs(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(*shape).astype(np.float32) for _ in range(4)]
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    jx = [jnp.asarray(a).astype(jdt) for a in arrs]
    # bf16 from the JAX side's rounding, so both see the same values.
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt) for a in jx]
    return jx, tx


def _held(got, want, dtype, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    bound = TOL[dtype] * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, (what, err, bound)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal", CASES)
def test_forward_reference_matches_pallas_kernel(shape, causal, dtype):
    """(o, lse) of `_flash_fwd_reference` against `_flash_fwd_pallas`."""
    (q, k, v, _), (tq, tk, tv, _) = _inputs(shape, dtype, 1)
    scale = shape[-1] ** -0.5
    o, lse = FA._flash_fwd_pallas(q, k, v, causal, scale, 128, 128, return_lse=True,
                                  interpret=True)
    to, tlse = tfa._flash_fwd_reference(tq, tk, tv, causal, scale)
    assert to.dtype == tq.dtype and tlse.dtype == torch.float32
    assert tuple(tlse.shape) == shape[:3]
    _held(to, o, dtype, "o")
    _held(tlse, lse, dtype, "lse")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal", CASES)
def test_backward_reference_matches_pallas_kernels(shape, causal, dtype):
    """(dq, dk, dv) of `_flash_bwd_reference` against `_flash_bwd_pallas`,
    both from the Pallas forward's o and lse."""
    (q, k, v, g), (tq, tk, tv, tg) = _inputs(shape, dtype, 2)
    scale = shape[-1] ** -0.5
    o, lse = FA._flash_fwd_pallas(q, k, v, causal, scale, 128, 128, return_lse=True,
                                  interpret=True)
    want = FA._flash_bwd_pallas(q, k, v, o, lse, g, causal, scale, 128, 128, interpret=True)
    to = torch.from_numpy(np.array(o.astype(jnp.float32))).to(tq.dtype)
    tlse = torch.from_numpy(np.array(lse, np.float32))
    got = tfa._flash_bwd_reference(tq, tk, tv, to, tlse, tg, causal, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == tq.dtype
        _held(a, b, dtype, name)


@pytest.mark.parametrize("shape,causal", CASES)
def test_autograd_matches_jax_vjp(shape, causal):
    """`flash_attention` forward and gradients on the CPU (through `_Flash`
    and the plain versions) against jax.vjp through the reference's
    `flash_attention`, f32, with a non-contiguous q as _attention gives."""
    (q, k, v, g), (tq, tk, tv, tg) = _inputs(shape, "float32", 3)
    out, vjp = jax.vjp(lambda q, k, v: FA.flash_attention(q, k, v, causal=causal), q, k, v)
    want = vjp(g)
    tq = tq.transpose(1, 2).contiguous().transpose(1, 2).requires_grad_(True)
    tk, tv = tk.requires_grad_(True), tv.requires_grad_(True)
    tout = tfa.flash_attention(tq, tk, tv, causal=causal)
    grads = torch.autograd.grad(tout, (tq, tk, tv), tg)
    _held(tout.detach(), out, "float32", "o")
    for name, a, b in zip(("dq", "dk", "dv"), grads, want):
        _held(a, b, "float32", name)


def test_reference_attention_matches_op_for_op():
    """`_reference_attention` against the reference's, bf16 (q*scale
    rounded in q's dtype, weights cast to v's dtype before PV)."""
    (q, k, v, _), (tq, tk, tv, _) = _inputs((2, 2, 96, 64), "bfloat16", 4)
    for causal in (True, False):
        want = FA._reference_attention(q, k, v, causal, 0.125)
        got = tfa._reference_attention(tq, tk, tv, causal, 0.125)
        assert got.dtype == torch.bfloat16
        _held(got, want, "bfloat16", "o")


@pytest.mark.parametrize("fault", [0.95, 0.0])
def test_flash_err_catches_faults_on_small_rows(fault):
    """`flash_err`, the measure the kernels are held to on the card: 0 on
    equal tensors; half the rows (or keys) of a causal output off by 5% or
    zeroed exceed the bf16 bound (2e-2) although those rows are the small
    ones; rounding noise in dq's first row, zero in exact arithmetic, is
    held at the tensor's scale and stays far below it."""
    _, (tq, tk, tv, tg) = _inputs((1, 2, 256, 64), "float32", 5)
    o, lse = tfa._flash_fwd_reference(tq, tk, tv, True, 0.125)
    dq, dk, dv = tfa._flash_bwd_reference(tq, tk, tv, o, lse, tg, True, 0.125)
    for x in (o, lse, dq, dk, dv):
        assert tfa.flash_err(x, x) == 0.0
    for x in (o, dq, dk, dv):
        bad = x.clone()
        bad[:, :, 128:] *= fault
        assert tfa.flash_err(bad, x) > 2e-2
    noisy = dq.clone()
    noisy[:, :, 0] += 1e-7 * torch.randn(noisy[:, :, 0].shape,
                                         generator=torch.Generator().manual_seed(0))
    assert tfa.flash_err(noisy, dq) < 1e-3


def test_cpu_runs_no_kernel_and_defaults_match_reference():
    assert (tfa.NEG_INF, tfa.DEFAULT_BLOCK_Q, tfa.DEFAULT_BLOCK_K) == (
        FA.NEG_INF, FA.DEFAULT_BLOCK_Q, FA.DEFAULT_BLOCK_K)
    before = dict(tfa.LAUNCHES)
    x = torch.randn(1, 1, 8, 64, requires_grad=True)
    tfa.flash_attention(x, x, x, causal=True).sum().backward()
    assert tfa.LAUNCHES == before
    with pytest.raises(ValueError):
        tfa.flash_attention(x, x, x, block_q=0)


# -- the forward's routes and its mma route's arithmetic -----------------------
@pytest.mark.parametrize("dtype,d,route", [
    ("bfloat16", 64, "mma"), ("bfloat16", 128, "mma"), ("bfloat16", 256, "mma"),
    ("float32", 64, "simt"), ("float32", 128, "simt"), ("float32", 256, "simt"),
    ("bfloat16", 96, "simt"),
])
def test_flash_route(dtype, d, route):
    """`_flash_route` depends on dtype and head_dim alone: the tensor-core
    forward for bf16 at head_dim 64, 128 or 256 (the kernels take no other
    head_dim; `_check` refuses it before any launch)."""
    assert tfa._flash_route(torch.zeros((1, 2, 8, d), dtype=getattr(torch, dtype))) == route


# chip_smoke.py's FLASH_TOL for the bf16 forward.
FWD_TOL = {"o": 2e-2, "lse": 4.0e-7}


def _mma_fwd(q, k, v, causal, scale, tile=64):
    """The forward's mma-route arithmetic on the CPU, per 64-row q tile over
    `tile`-key stages (64; 32 at head_dim 256): S = (q k^T) * scale in f32
    from bf16 inputs, the mask k < T and, causal, q >= k, the weights
    exp2((s - m) log2 e) zeroed where masked, l summed from them, P rounded
    to bf16 for PV, o = acc / max(l, 1e-30) in bf16, lse = m + log(l) or
    NEG_INF where l = 0."""
    t = q.shape[-2]
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full(q.shape[:3], NEG_INF)
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros(q.shape[:3] + (q.shape[-1],))
    rows = torch.arange(t)
    for k0 in range(0, t, tile):
        idx = torch.arange(k0, min(k0 + tile, t))
        ok = (rows[:, None] >= idx[None, :]) if causal else torch.ones((t, len(idx)), dtype=bool)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, idx]) * scale
        s = torch.where(ok, s, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(ok, torch.exp2((s - m_new[..., None]) * LOG2E), torch.tensor(0.0))
        alpha = torch.exp2((m - m_new) * LOG2E)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), vf[:, :, idx])
        m = m_new
    den = l.clamp_min(1e-30)
    lse = torch.where(l > 0, m + torch.log(den), torch.full_like(l, NEG_INF))
    return (acc / den[..., None]).to(q.dtype), lse


NEG_INF = -1e30
LOG2E = 1.4426950408889634


@pytest.mark.parametrize("t,causal", [(256, True), (256, False), (177, True)])
def test_flash_fwd_mma_arithmetic_within_the_card_bounds(t, causal):
    """The mma route's arithmetic at head_dim 128, whose scale 2^-3.5 is not
    a power of two (applied after the product, where the reference scales
    q first), against `_flash_fwd_reference`: o and lse by `flash_err`
    within chip_smoke.py's bf16 FLASH_TOL, the gate the card holds the
    kernel to."""
    _, (tq, tk, tv, _) = _inputs((1, 2, t, 128), "bfloat16", 6)
    o, lse = _mma_fwd(tq, tk, tv, causal, 128 ** -0.5)
    o_want, lse_want = tfa._flash_fwd_reference(tq, tk, tv, causal, 128 ** -0.5)
    assert o.dtype == torch.bfloat16
    assert tfa.flash_err(o, o_want) <= FWD_TOL["o"]
    assert tfa.flash_err(lse, lse_want) <= FWD_TOL["lse"]
