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
    kernels (forward, dq and dk/dv alike) for bf16 at head_dim 64, 128 or
    256 (the kernels take no other head_dim; `_check` refuses it before any
    launch)."""
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


# -- the backward's mma route: its arithmetic -----------------------------------
# chip_smoke.py's FLASH_TOL for the bf16 backward.
BWD_TOL = {"dq": 1.4e-2, "dk": 1.2e-2, "dv": 8.3e-3}
BWD_TERMS = 2  # bf16 terms of P and dS (csrc/flash_attention.cu, kBwdTerms)


def _terms(x, n):
    """f32 `x` as n bf16 terms (a_terms in csrc/mma.cuh): the rounding of
    x, then the rounding of each remainder."""
    out = []
    for _ in range(n):
        out.append(x.to(torch.bfloat16).float())
        x = x - out[-1]
    return out


def _mma_p_ds(q, k, v, do, lse, dvec, causal, scale):
    """P and dS as the mma backward forms them in f32: S = q k^T from bf16
    inputs, P = 2^(S scale log2 e - lse log2 e) zeroed where masked, dS = P
    (dO v^T - D)."""
    t = q.shape[-2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    p = torch.exp2(s * (scale * LOG2E) - (lse * LOG2E)[..., None])
    if causal:
        p = p.masked_fill(~torch.ones((t, t), dtype=torch.bool).tril(), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    return p, p * (dp - dvec[..., None])


def _stream_tiles(t, d):
    """The mma backward's streamed tiles: 32 rows at head_dim 256, else 64."""
    tile = 32 if d == 256 else 64
    return [slice(a, a + tile) for a in range(0, t, tile)]


def _mma_dq(q, k, v, do, lse, dvec, causal, scale, terms=BWD_TERMS):
    """dq on the mma route: over key tiles in order, dQ += (dS as `terms`
    bf16 terms) K in f32; dq = dQ * scale in q's dtype."""
    _, ds = _mma_p_ds(q, k, v, do, lse, dvec, causal, scale)
    acc = torch.zeros(q.shape)
    for sl in _stream_tiles(*q.shape[-2:]):
        for x in _terms(ds[..., sl], terms):
            acc += torch.einsum("bhqk,bhkd->bhqd", x, k[..., sl, :].float())
    return (acc * scale).to(q.dtype)


def _mma_dkv(q, k, v, do, lse, dvec, causal, scale, terms=BWD_TERMS):
    """dk, dv on the mma route: over q tiles in order, dK += (dS^T as
    `terms` bf16 terms) Q and dV += (P^T as `terms` terms) dO in f32; dk =
    dK * scale and dv = dV in k's and v's dtype."""
    p, ds = _mma_p_ds(q, k, v, do, lse, dvec, causal, scale)
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    for sl in _stream_tiles(*q.shape[-2:]):
        for x in _terms(ds[..., sl, :], terms):
            dk += torch.einsum("bhqk,bhqd->bhkd", x, q[..., sl, :].float())
        for x in _terms(p[..., sl, :], terms):
            dv += torch.einsum("bhqk,bhqd->bhkd", x, do[..., sl, :].float())
    return (dk * scale).to(k.dtype), dv.to(v.dtype)


def _bwd_case(shape, causal, seed):
    """bf16 inputs and the plain forward's lse and D, as check_flash makes
    them on the card."""
    _, (q, k, v, do) = _inputs(shape, "bfloat16", seed)
    scale = shape[-1] ** -0.5
    o, lse = tfa._flash_fwd_reference(q, k, v, causal, scale)
    return (q, k, v, do, lse, tfa._dvec(o, do)), causal, scale


def _bwd_errs(args, causal, scale, terms=BWD_TERMS):
    """flash_err of the emulated mma dq, dk, dv against the plain versions."""
    got = (_mma_dq(*args, causal, scale, terms), *_mma_dkv(*args, causal, scale, terms))
    want = (tfa._dq_reference(*args, causal, scale), *tfa._dkv_reference(*args, causal, scale))
    assert all(g.dtype == torch.bfloat16 for g in got)
    return {n: tfa.flash_err(g, w) for n, g, w in zip(("dq", "dk", "dv"), got, want)}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,h", [(256, 2), (177, 2), (2048, 1)])
@pytest.mark.parametrize("d", [128, 256])
def test_flash_bwd_mma_arithmetic_within_the_card_bounds(d, t, h, causal):
    """The mma backward's arithmetic (two bf16 terms of P and dS, the scale
    after the product, exp2, tile order) against `_dq_reference` and
    `_dkv_reference` by `flash_err`, within chip_smoke.py's bf16 FLASH_TOL,
    the gate the card holds the kernels to."""
    args, causal, scale = _bwd_case((1, h, t, d), causal, 7)
    errs = _bwd_errs(args, causal, scale)
    assert all(errs[n] <= BWD_TOL[n] for n in BWD_TOL), errs


def test_flash_bwd_mma_arithmetic_matches_pallas_kernels():
    """The emulated mma dq, dk, dv against `_flash_bwd_pallas` (interpret
    mode) from the Pallas forward's o and lse, bf16, at JAX's own bound."""
    (q, k, v, g), (tq, tk, tv, tg) = _inputs((1, 2, 256, 128), "bfloat16", 8)
    scale = 128 ** -0.5
    o, lse = FA._flash_fwd_pallas(q, k, v, True, scale, 128, 128, return_lse=True,
                                  interpret=True)
    want = FA._flash_bwd_pallas(q, k, v, o, lse, g, True, scale, 128, 128, interpret=True)
    to = torch.from_numpy(np.array(o.astype(jnp.float32))).bfloat16()
    args = (tq, tk, tv, tg, torch.from_numpy(np.array(lse, np.float32)), tfa._dvec(to, tg))
    got = (_mma_dq(*args, True, scale), *_mma_dkv(*args, True, scale))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _held(a, b, "bfloat16", name)


def test_flash_bwd_one_bf16_term_of_p_would_miss_the_bound():
    """One bf16 rounding of P (2^-9) before dV += P^T dO puts dv past its
    bound on this draw, where the kernel's two terms hold it: the reason
    the mma backward feeds P (and dS) as hi + lo."""
    args, causal, scale = _bwd_case((1, 4, 1000, 128), True, 0)
    assert _bwd_errs(args, causal, scale, terms=1)["dv"] > BWD_TOL["dv"]
    assert _bwd_errs(args, causal, scale)["dv"] <= BWD_TOL["dv"]


def sweep(seed=0, terms=(1, 2, 3)):
    """The emulated mma backward's worst flash_err over chip_smoke.py's bf16
    FLASH_CHECKS, per count of bf16 terms of P and dS, inputs from a CPU
    generator seeded `seed` (the card's draws differ), one head at a time.

        python -m tests.test_torch_flash_attention [seed]
    """
    from chip_smoke import FLASH_CHECKS

    for b, h, t, d, dtype, causal in FLASH_CHECKS:
        if dtype != "bfloat16":
            continue
        gen = torch.Generator().manual_seed(seed * 100 + t + d)
        q, k, v, do = (torch.randn((b, h, t, d), generator=gen).bfloat16() for _ in range(4))
        scale = d ** -0.5
        want = [torch.empty_like(q) for _ in range(3)]
        got = {n: [torch.empty_like(q) for _ in range(3)] for n in terms}
        for i in range(b):
            for j in range(h):
                at = (slice(i, i + 1), slice(j, j + 1))
                x = [a[at] for a in (q, k, v, do)]
                o, lse = tfa._flash_fwd_reference(*x[:3], causal, scale)
                args = (*x, lse, tfa._dvec(o, x[3]))
                want[0][at] = tfa._dq_reference(*args, causal, scale)
                want[1][at], want[2][at] = tfa._dkv_reference(*args, causal, scale)
                for n in terms:
                    got[n][0][at] = _mma_dq(*args, causal, scale, n)
                    got[n][1][at], got[n][2][at] = _mma_dkv(*args, causal, scale, n)
        for n in terms:
            errs = {x: tfa.flash_err(g, w) for x, g, w in zip(("dq", "dk", "dv"), got[n], want)}
            print(f"[{b},{h},{t},{d}] causal={causal} terms={n} {errs}", flush=True)


if __name__ == "__main__":
    import sys

    sweep(int(sys.argv[1]) if len(sys.argv) > 1 else 0)
