"""The port's CUDA kernels (nos_tpu_torch/ops/csrc/paged_attention.cu,
flash_attention.cu and decode_attention.cu) against their plain PyTorch
versions, on the card, and the routes each entry point takes.

Torch and numpy only (the card's machine has no JAX), so it runs there
without the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

The tests carry the `cuda` marker; without a CUDA device every test skips
(decided in a fixture): a kernel has no CPU mode. Paged kernels: f32 is
held to atol 1e-4 (summation order); bf16 and int8 pools to 2e-2 (one bf16
rounding of the output, and the plain version's bf16 rounding of the
dequantized int8 values); the window's mma route (bf16 q over a bf16
pool) to chip_smoke.py's `held` bounds, max|err| 5e-3 and 2e-2 of
max|want|, and over an int8 pool to its int8 bounds, 2e-2 and 2e-2 of
max|want|, with block scales over 2.5 decades. Flash kernels: each output entry by entry
(`flash_err`) within FLASH_TOL, chip_smoke.py's bounds. Dense decode
kernel: entry by entry (`flash_err`) within DECODE_TOL, chip_smoke.py's
bounds. The sharded paged kernels bit for bit against the unsharded kernel
on the same heads, and a tp=2 engine on one card against tp=1. The engine's
captured decode window (a CUDA graph) against its eager `_macro` on one
state: tokens and the state they advance equal, the pool's written pages
byte for byte, the launch counts equal; a capture that copies from host
memory raises, and a dead engine's graph in a reference cycle is
collected before a capture, never inside it. The spill tier's and the
radix tree's block copies byte for byte on the card (tp=1 and tp=2), a
verify window (W = 9) on the mma route against the plain version, and a
spec-armed engine with the radix cache on the card against spec-off. And
the f32 rows the engine's programs of different shapes give for the same
inputs (ROADMAP C). For the serving plane: an engine prewarmed before it
serves, and one built (its window captured) while two engines tick on
their own threads, its launch delta that of an idle build. For the workload
plane: the ViT's flash route (512 px, bf16) through the kernel against its
plain version, and the sharded train step (dp 2 x tp 2 on one card)
against the single-device step, its flash launches all on "mma". For the
measurement layer: measure_mfu on a bf16 matrix product, its FLOPs
counted by FlopCounterMode and its step time against a plain CUDA-event
loop."""

import time

import numpy as np
import pytest
import torch

from nos_tpu_torch.ops import paged_attention as tpa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _case(rng, b, nkv, hd, bs, n_pages, total, quant, qdt, dev):
    if quant:
        k = torch.from_numpy(rng.randint(-127, 128, (total, nkv, bs, hd)).astype(np.int8))
        v = torch.from_numpy(rng.randint(-127, 128, (total, nkv, bs, hd)).astype(np.int8))
        ks = torch.from_numpy((rng.rand(total) * 0.02 + 0.001).astype(np.float32)).to(dev)
        vs = torch.from_numpy((rng.rand(total) * 0.02 + 0.001).astype(np.float32)).to(dev)
        k, v = k.to(dev), v.to(dev)
    else:
        k = torch.from_numpy(rng.randn(total, nkv, bs, hd).astype(np.float32)).to(dev, qdt)
        v = torch.from_numpy(rng.randn(total, nkv, bs, hd).astype(np.float32)).to(dev, qdt)
        ks = vs = None
    # Disjoint pages per row, row 1 sharing row 0's first page, tails at
    # the scratch page 0.
    perm = rng.permutation(np.arange(1, total))
    owned = rng.randint(1, n_pages + 1, size=b)
    table = np.zeros((b, n_pages), np.int32)
    used = 0
    for row in range(b):
        table[row, : owned[row]] = perm[used : used + owned[row]]
        used += owned[row]
    table[1, 0] = table[0, 0]
    return k, v, ks, vs, torch.from_numpy(table).to(dev), owned


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("nh,nkv,hd,bs", [(8, 2, 64, 32), (8, 8, 128, 16), (4, 1, 256, 8)])
def test_kernels_match_plain(cuda_device, dtype, nh, nkv, hd, bs):
    rng = np.random.RandomState(11)
    b, n_pages, total, w = 4, 6, 40, 16
    quant = dtype == "int8"
    qdt = torch.float32 if dtype == "float32" else torch.bfloat16
    k, v, ks, vs, table, owned = _case(rng, b, nkv, hd, bs, n_pages, total, quant, qdt,
                                       cuda_device)
    tol = 1e-4 if dtype == "float32" else 2e-2
    q = torch.from_numpy(rng.randn(b, nh, hd).astype(np.float32)).to(cuda_device, qdt)
    limit = torch.tensor([rng.randint(1, o * bs + 1) for o in owned], dtype=torch.int32,
                         device=cuda_device)
    before = dict(tpa.LAUNCHES)
    routes = {n: dict(r) for n, r in tpa.ROUTE_LAUNCHES.items()}
    got = tpa.paged_decode_attention(q, k, v, table, limit, ks, vs)
    want = tpa._reference(q, k, v, table, limit, ks, vs)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= tol
    qw = torch.from_numpy(rng.randn(b, nh, w, hd).astype(np.float32)).to(cuda_device, qdt)
    pos = torch.tensor([rng.randint(0, max(1, o * bs - w) + 1) for o in owned],
                       dtype=torch.int32, device=cuda_device)
    lengths = torch.tensor([w, 3, 1, w], dtype=torch.int32, device=cuda_device)
    mask = torch.tensor([True, True, False, True], device=cuda_device)
    got = tpa.paged_window_attention(qw, k, v, table, pos, lengths, mask, ks, vs)
    want = tpa._window_reference(qw, k, v, table, pos, lengths, mask, ks, vs)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert tpa.LAUNCHES["paged_decode_attention"] == before["paged_decode_attention"] + 1
    assert tpa.LAUNCHES["paged_window_attention"] == before["paged_window_attention"] + 1
    # Every head_dim here is 64/128/256: a bf16 q (over a bf16 or an int8
    # pool) takes the mma route, an f32 q the simt route.
    route = "simt" if dtype == "float32" else "mma"
    assert tpa.ROUTE_LAUNCHES["paged_window_attention"][route] == \
        routes["paged_window_attention"][route] + 1
    assert tpa.ROUTE_LAUNCHES["paged_decode_attention"]["split"] == \
        routes["paged_decode_attention"]["split"] + 1


# (nh, nkv, hd, bs, w): rep 1, 2, 4 and 8; head_dim 64, 128 and 256; blocks
# of 8, 16, 32 and 64 positions; windows of 1, 5, 16, 37 and 256 rows.
WINDOW_MMA_CASES = [
    (8, 2, 64, 32, 16),    # the serving heads, a bucket-16 chunk
    (8, 2, 64, 32, 256),   # the main path's 256-token chunk
    (4, 4, 64, 8, 37),     # rep 1, 8-position blocks, a ragged last warp tile
    (8, 4, 128, 16, 5),    # rep 2
    (8, 1, 128, 64, 1),    # rep 8, one row
    (4, 2, 256, 16, 37),   # rep 2 at head_dim 256
    (8, 1, 256, 8, 16),    # rep 8 at head_dim 256
    (4, 1, 64, 64, 256),   # rep 4 over 64-position blocks
]


@pytest.mark.parametrize("nh,nkv,hd,bs,w", WINDOW_MMA_CASES)
def test_window_mma_route_matches_plain(cuda_device, nh, nkv, hd, bs, w):
    """The window kernel's mma route against the plain version, one launch
    over five lanes: length 1; a length that ends inside a 16-row warp
    tile; a masked lane; a full window whose positions cross a page
    boundary; a full window from position 0. Held to max|err| 5e-3 and 2e-2
    of max|want| (chip_smoke.py's `held`)."""
    rng = np.random.RandomState(hd + bs + w)
    pos = [3 * bs + 5, bs - 1, 7, 2 * bs - 2, 0]
    lengths = [1, min(w, 11), w, w, w]
    n_pages = -(-(max(pos) + w) // bs) + 1
    b = len(pos)
    total = 1 + b * n_pages
    pool = [torch.from_numpy(rng.randn(total, nkv, bs, hd).astype(np.float32))
            .to(cuda_device, torch.bfloat16) for _ in range(2)]
    table = torch.from_numpy(rng.permutation(np.arange(1, total))[: b * n_pages]
                             .reshape(b, n_pages).astype(np.int32)).to(cuda_device)
    qw = torch.from_numpy(rng.randn(b, nh, w, hd).astype(np.float32)).to(cuda_device,
                                                                        torch.bfloat16)
    args = (table, torch.tensor(pos, dtype=torch.int32, device=cuda_device),
            torch.tensor(lengths, dtype=torch.int32, device=cuda_device),
            torch.tensor([True, True, False, True, True], device=cuda_device))
    assert tpa._window_route(qw, pool[0], None) == "mma"
    before = tpa.ROUTE_LAUNCHES["paged_window_attention"]["mma"]
    got = tpa.paged_window_attention(qw, *pool, *args)
    want = tpa._window_reference(qw, *pool, *args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert err <= 5e-3 and err / want.float().abs().max().item() <= 2e-2, err
    assert tpa.ROUTE_LAUNCHES["paged_window_attention"]["mma"] == before + 1


def _int8_window_case(rng, dev, b, nh, nkv, hd, bs, w, pos):
    """An int8 pool whose per-block scales spread over 2.5 decades
    (10^-4.5 to 10^-2, so a scale applied to another page's keys moves the
    output far past the bound while the dequantized values stay within
    1.3), disjoint pages per lane, and a bf16 window."""
    n_pages = -(-(max(pos) + w) // bs) + 1
    total = 1 + b * n_pages
    k, v = (torch.from_numpy(rng.randint(-127, 128, (total, nkv, bs, hd)).astype(np.int8))
            .to(dev) for _ in range(2))
    ks, vs = (torch.from_numpy((10.0 ** rng.uniform(-4.5, -2.0, total)).astype(np.float32))
              .to(dev) for _ in range(2))
    table = torch.from_numpy(rng.permutation(np.arange(1, total))[: b * n_pages]
                             .reshape(b, n_pages).astype(np.int32)).to(dev)
    qw = torch.from_numpy(rng.randn(b, nh, w, hd).astype(np.float32)).to(dev, torch.bfloat16)
    return qw, k, v, ks, vs, table


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("bs,w", [(8, 9), (32, 9), (8, 256), (32, 256)])
def test_window_mma_int8_route_matches_plain(cuda_device, hd, bs, w):
    """The window kernel's mma route over an int8 pool (bf16 q, codes
    widened to bf16 in shared memory, each key's block scales applied to
    S's and P's columns in f32) against the plain version (the gather
    dequantized to bf16): one launch, counted under "mma", over four lanes
    (a full window crossing pages, a short one, a masked lane, a full one
    from position 0), held to the int8 bounds of chip_smoke.py's `held`:
    max|err| 2e-2 and 2e-2 of max|want| on the live rows."""
    rng = np.random.RandomState(hd + bs + w)
    nh, nkv = 8, 2
    pos = [3 * bs + 5, bs - 1, 7, 0]
    lengths = [w, min(w, 5), w, w]
    qw, k, v, ks, vs, table = _int8_window_case(rng, cuda_device, len(pos), nh, nkv, hd, bs,
                                                w, pos)
    args = (table, torch.tensor(pos, dtype=torch.int32, device=cuda_device),
            torch.tensor(lengths, dtype=torch.int32, device=cuda_device),
            torch.tensor([True, True, False, True], device=cuda_device), ks, vs)
    assert tpa._window_route(qw, k, ks) == "mma"
    assert tpa._window_route(qw.float(), k, ks) == "simt"
    before = dict(tpa.ROUTE_LAUNCHES["paged_window_attention"])
    got = tpa.paged_window_attention(qw, k, v, *args)
    torch.cuda.synchronize()
    assert tpa.ROUTE_LAUNCHES["paged_window_attention"] == dict(before, mma=before["mma"] + 1)
    want = tpa._window_reference(qw, k, v, *args)
    live = ((torch.arange(w, device=cuda_device)[None, :] < args[2][:, None])
            & args[3][:, None])[:, None, :, None].expand_as(got)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    err = (got.float() - want.float()).abs()[live].max().item()
    top = want.float().abs()[live].max().item()
    assert err <= 2e-2 and err <= 2e-2 * top, (err, top)
    # The masked lane attends key 0 of its first page only.
    first = (v[table[2, 0], :].float()[:, 0] * vs[table[2, 0]]).repeat_interleave(nh // nkv, 0)
    assert (got[2, :, 0].float() - first).abs().max().item() <= 2e-2


def test_window_mma_int8_sharded_bit_identical_per_head(cuda_device):
    """The sharded window over an int8 pool (two shards, one KV head each,
    each with its own copy of the scales) takes the mma route once per
    shard, and each shard's output equals the unsharded kernel's on its
    heads bit for bit."""
    rng = np.random.RandomState(5)
    pos = [70, 31, 0, 200]
    qw, k, v, ks, vs, table = _int8_window_case(rng, cuda_device, 4, 8, 2, 64, 32, 256, pos)
    rest = (torch.tensor(pos, dtype=torch.int32, device=cuda_device),
            torch.tensor([256, 40, 256, 1], dtype=torch.int32, device=cuda_device),
            torch.tensor([True, True, False, True], device=cuda_device))

    def heads(x):
        return [t.contiguous() for t in x.chunk(2, dim=1)]

    before = dict(tpa.ROUTE_LAUNCHES["paged_window_attention_sharded"])
    got = tpa.paged_window_attention_sharded(heads(qw), heads(k), heads(v), table, *rest,
                                             [ks, ks.clone()], [vs, vs.clone()])
    whole = tpa.paged_window_attention(qw, k, v, table, *rest, ks, vs)
    torch.cuda.synchronize()
    assert all(torch.equal(g, x) for g, x in zip(got, heads(whole)))
    assert tpa.ROUTE_LAUNCHES["paged_window_attention_sharded"] == dict(
        before, mma=before["mma"] + 2)


def test_kernels_reject_what_they_do_not_take(cuda_device):
    rng = np.random.RandomState(3)
    k, v, _, _, table, _ = _case(rng, 2, 2, 64, 32, 4, 12, False, torch.bfloat16,
                                 cuda_device)
    q = torch.zeros((2, 8, 64), dtype=torch.bfloat16, device=cuda_device)
    limit = torch.ones((2,), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):  # pool dtype differs from q's
        tpa.paged_decode_attention(q.float(), k, v, table, limit)
    with pytest.raises(ValueError):  # a table in int64
        tpa.paged_decode_attention(q, k, v, table.long(), limit)
    with pytest.raises(ValueError):  # a non-contiguous q
        tpa.paged_decode_attention(q.transpose(0, 1).contiguous().transpose(0, 1), k, v,
                                   table, limit)
    with pytest.raises(ValueError):  # a CPU limit
        tpa.paged_decode_attention(q, k, v, table, limit.cpu())
    # A block of 256 positions x head_dim 256 would need more shared memory
    # than a CUDA block of the window's simt kernel has: the launcher refuses
    # it and the wrapper raises. The split decode kernel keeps no page in
    # shared memory and takes it.
    big = torch.ones((3, 1, 256, 256), device=cuda_device)
    qb = torch.ones((1, 4, 256), device=cuda_device)
    one = torch.ones((1,), dtype=torch.int32, device=cuda_device)
    with pytest.raises(RuntimeError):
        tpa.paged_window_attention(qb[:, :, None, :].contiguous(), big, big,
                                   table[:1, :1].contiguous(), one - 1, one,
                                   torch.ones((1,), dtype=torch.bool, device=cuda_device))
    got = tpa.paged_decode_attention(qb, big, big, one[:, None], one + 299)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.ones_like(qb))


# -- flash attention (nos_tpu_torch/ops/csrc/flash_attention.cu) ---------------
FLASH_CASES = [
    # (b, h, t, d, dtype, causal): the training shape, then head_dim 64 and
    # 128, ragged T (177, 1000), non-causal and f32.
    (8, 8, 2048, 256, "bfloat16", True),
    (2, 4, 177, 64, "float32", True),
    (2, 4, 177, 64, "bfloat16", False),
    (1, 3, 1000, 128, "float32", False),
    (1, 3, 1000, 128, "bfloat16", True),
    (1, 2, 300, 256, "float32", True),
    # The ViT's flash arm (512 px: 1024 patches + 100 detection tokens).
    (7, 6, 1124, 64, "bfloat16", False),
]


# chip_smoke.py's FLASH_TOL: a bound for each output, by input dtype.
FLASH_TOL = {
    "float32": {"o": 1.3e-5, "lse": 1.7e-7, "dq": 3.3e-6, "dk": 2.7e-6, "dv": 2.6e-6},
    "bfloat16": {"o": 2e-2, "lse": 4.0e-7, "dq": 1.4e-2, "dk": 1.2e-2, "dv": 8.3e-3},
}


def _flash_held(got, want, dtype, what):
    from nos_tpu_torch.ops.flash_attention import flash_err

    err = flash_err(got, want)
    assert err <= FLASH_TOL[dtype][what], (what, err, FLASH_TOL[dtype][what])


@pytest.mark.parametrize("b,h,t,d,dtype,causal", FLASH_CASES)
def test_flash_kernels_match_plain(cuda_device, b, h, t, d, dtype, causal):
    """Forward (o, lse), dq and dk/dv against their plain versions within
    FLASH_TOL. At the training shape, faults planted in the plain outputs
    (half the rows or keys off by 5%, or zeroed) must fail those bounds."""
    from nos_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(t + d)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn((b, h, t, d), generator=gen, device="cuda").to(dt)
                   for _ in range(4))
    scale = d ** -0.5
    before = dict(fa.LAUNCHES)
    routes = {n: dict(r) for n, r in fa.ROUTE_LAUNCHES.items()}
    o, lse = fa.flash_fwd(q, k, v, causal, scale)
    o_want, lse_want = fa._flash_fwd_reference(q, k, v, causal, scale)
    torch.cuda.synchronize()
    _flash_held(o, o_want, dtype, "o")
    _flash_held(lse, lse_want, dtype, "lse")
    dvec = fa._dvec(o_want, do)
    dq = fa.flash_bwd_dq(q, k, v, do, lse_want, dvec, causal, scale)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_want, dvec, causal, scale)
    dq_want = fa._dq_reference(q, k, v, do, lse_want, dvec, causal, scale)
    dk_want, dv_want = fa._dkv_reference(q, k, v, do, lse_want, dvec, causal, scale)
    torch.cuda.synchronize()
    outputs = {"o": o_want, "dq": dq_want, "dk": dk_want, "dv": dv_want}
    for name, got in (("dq", dq), ("dk", dk), ("dv", dv)):
        _flash_held(got, outputs[name], dtype, name)
    if t == 2048:
        for name, want in outputs.items():
            for fault in (0.95, 0.0):
                bad = want.clone()
                bad[:, :, t // 2:] *= fault
                with pytest.raises(AssertionError):
                    _flash_held(bad, want, dtype, name)
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    route = "mma" if dtype == "bfloat16" else "simt"
    for name in before:
        assert fa.ROUTE_LAUNCHES[name] == dict(routes[name], **{route: routes[name][route] + 1})


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [177, 1000, 2048])
def test_flash_fwd_routes(cuda_device, t, causal, d):
    """The forward in bf16 takes the mma route, in f32 the simt route; each
    against its plain version within FLASH_TOL (o and lse), one launch on
    its route's count."""
    from nos_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(t * 7 + d + causal)
    base = [torch.randn((1, 2, t, d), generator=gen, device="cuda") for _ in range(3)]
    for dtype, route in (("bfloat16", "mma"), ("float32", "simt")):
        q, k, v = (x.to(getattr(torch, dtype)) for x in base)
        assert fa._flash_route(q) == route
        before = dict(fa.ROUTE_LAUNCHES["flash_fwd"])
        o, lse = fa.flash_fwd(q, k, v, causal, d ** -0.5)
        o_want, lse_want = fa._flash_fwd_reference(q, k, v, causal, d ** -0.5)
        torch.cuda.synchronize()
        _flash_held(o, o_want, dtype, "o")
        _flash_held(lse, lse_want, dtype, "lse")
        want = dict(before, **{route: before[route] + 1})
        assert fa.ROUTE_LAUNCHES["flash_fwd"] == want


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [177, 1000, 2048])
def test_flash_bwd_routes(cuda_device, t, causal, d):
    """dq and dk/dv in bf16 take the mma route, in f32 the simt route; each
    against its plain version within FLASH_TOL from the plain forward's lse
    and D, one launch on its route's count."""
    from nos_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(t * 11 + d + causal)
    base = [torch.randn((1, 2, t, d), generator=gen, device="cuda") for _ in range(4)]
    scale = d ** -0.5
    for dtype, route in (("bfloat16", "mma"), ("float32", "simt")):
        q, k, v, do = (x.to(getattr(torch, dtype)) for x in base)
        o, lse = fa._flash_fwd_reference(q, k, v, causal, scale)
        dvec = fa._dvec(o, do)
        before = {n: dict(fa.ROUTE_LAUNCHES[n]) for n in ("flash_bwd_dq", "flash_bwd_dkv")}
        dq = fa.flash_bwd_dq(q, k, v, do, lse, dvec, causal, scale)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, dvec, causal, scale)
        dk_want, dv_want = fa._dkv_reference(q, k, v, do, lse, dvec, causal, scale)
        torch.cuda.synchronize()
        _flash_held(dq, fa._dq_reference(q, k, v, do, lse, dvec, causal, scale), dtype, "dq")
        _flash_held(dk, dk_want, dtype, "dk")
        _flash_held(dv, dv_want, dtype, "dv")
        for name, counts in before.items():
            assert fa.ROUTE_LAUNCHES[name] == dict(counts, **{route: counts[route] + 1})


def test_flash_simt_entry_points_refuse_bf16(cuda_device):
    """The simt launchers take f32 only: bf16 must go the mma route, so a
    bf16 call to nos_flash_fwd, nos_flash_bwd_dq or nos_flash_bwd_dkv
    returns an error and launches nothing."""
    from nos_tpu_torch.ops import _build
    from nos_tpu_torch.ops import flash_attention as fa

    x = torch.ones((1, 2, 64, 64), device="cuda", dtype=torch.bfloat16)
    rows = torch.zeros((1, 2, 64), device="cuda")
    out = [torch.full_like(x, 7.0) for _ in range(2)]
    lib = fa._lib()
    vp = [_build.VP(a.data_ptr()) for a in (x, x, x, x, rows, rows, *out)]
    stream = _build.stream(x)
    assert lib.nos_flash_fwd(*vp[:3], vp[6], vp[4], 2, 64, 64, 1, 1, 0.125, stream) != 0
    assert lib.nos_flash_bwd_dq(*vp[:7], 2, 64, 64, 1, 1, 0.125, stream) != 0
    assert lib.nos_flash_bwd_dkv(*vp, 2, 64, 64, 1, 1, 0.125, stream) != 0
    torch.cuda.synchronize()
    assert all(bool((o == 7.0).all()) for o in out)


def test_flash_autograd_launches_the_kernels(cuda_device):
    """flash_attention on CUDA tensors: one forward launch, one of each
    backward kernel, gradients as the plain backward gives them, with a
    non-contiguous incoming gradient."""
    from nos_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((2, 2, 130, 64), generator=gen, device="cuda")
               .requires_grad_(True) for _ in range(3))
    g = torch.randn((2, 130, 2, 64), generator=gen, device="cuda").transpose(1, 2)
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention(q, k, v, causal=True)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
    o_want, lse = fa._flash_fwd_reference(q.detach(), k.detach(), v.detach(), True, 64 ** -0.5)
    want = fa._flash_bwd_reference(q.detach(), k.detach(), v.detach(), o_want, lse,
                                   g.contiguous(), True, 64 ** -0.5)
    torch.cuda.synchronize()
    _flash_held(out, o_want, "float32", "o")
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        _flash_held(got, w, "float32", name)
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


def test_flash_kernels_reject_what_they_do_not_take(cuda_device):
    from nos_tpu_torch.ops import flash_attention as fa

    x = torch.zeros((1, 2, 64, 64), device="cuda")
    with pytest.raises(ValueError):  # head_dim 96
        fa.flash_fwd(*(torch.zeros((1, 2, 64, 96), device="cuda"),) * 3, True, 0.1)
    with pytest.raises(ValueError):  # mixed dtypes
        fa.flash_fwd(x, x.bfloat16(), x, True, 0.1)
    with pytest.raises(ValueError):  # a non-contiguous k
        fa.flash_fwd(x, x.transpose(2, 3), x, True, 0.1)
    with pytest.raises(ValueError):  # lse in bf16
        fa.flash_bwd_dq(x, x, x, x, torch.zeros((1, 2, 64), device="cuda").bfloat16(),
                        torch.zeros((1, 2, 64), device="cuda"), True, 0.1)


# -- dense decode attention (nos_tpu_torch/ops/csrc/decode_attention.cu) -------
# chip_smoke.py's DECODE_TOL: flash_err bounds by dtype (bf16: one output
# rounding step, at most 2^-7 of the entry).
DECODE_TOL = {"float32": 1.0e-5, "bfloat16": 2.0 ** -7}
DECODE_LIMITS = [0, 1, 31, 32, 33, 1000, 2048, 8191, 8192, 9000]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nh,nkv,hd,max_len,limits", [
    (8, 2, 64, 8192, DECODE_LIMITS),          # the bench GPT's heads, the edge limits
    (4, 4, 128, 2048, [0, 63, 2047, 3000]),   # MHA, rep 1
    (2, 2, 256, 2048, [1, 64, 65, 2048]),
    (6, 3, 64, 512, [0, 300, 512]),           # the reference test's uneven rep 2
])
def test_decode_kernel_matches_plain(cuda_device, dtype, nh, nkv, hd, max_len, limits):
    """Limit 0 (the uniform mean of V over every row), limits below, at and
    past 32 and 64 positions, max - 1, max and past max, one row
    each; one launch."""
    from nos_tpu_torch.ops import decode_attention as tda
    from nos_tpu_torch.ops.flash_attention import flash_err

    gen = torch.Generator(device="cuda").manual_seed(hd + max_len)
    dt = getattr(torch, dtype)
    b = len(limits)
    q = torch.randn((b, nh, hd), generator=gen, device="cuda").to(dt)
    k, v = (torch.randn((b, nkv, max_len, hd), generator=gen, device="cuda").to(dt)
            for _ in range(2))
    limit = torch.tensor(limits, dtype=torch.int32, device="cuda")
    before = tda.LAUNCHES["decode_attention"]
    split = tda.ROUTE_LAUNCHES["decode_attention"]["split"]
    got = tda.decode_attention(q, k, v, limit)
    want = tda._reference(q, k, v, limit)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == q.shape
    assert flash_err(got, want) <= DECODE_TOL[dtype]
    assert tda.LAUNCHES["decode_attention"] == before + 1
    assert tda.ROUTE_LAUNCHES["decode_attention"]["split"] == split + 1


def test_decode_kernel_rejects_what_it_does_not_take(cuda_device):
    from nos_tpu_torch.ops import decode_attention as tda

    q = torch.zeros((2, 8, 64), dtype=torch.bfloat16, device="cuda")
    k = torch.zeros((2, 2, 32, 64), dtype=torch.bfloat16, device="cuda")
    limit = torch.ones((2,), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):  # the cache's dtype differs from q's
        tda.decode_attention(q, k.float(), k.float(), limit)
    with pytest.raises(ValueError):  # a non-contiguous q
        tda.decode_attention(q.transpose(0, 1).contiguous().transpose(0, 1), k, k, limit)
    with pytest.raises(ValueError):  # a CPU limit
        tda.decode_attention(q, k, k, limit.cpu())
    with pytest.raises(ValueError):  # an int64 limit
        tda.decode_attention(q, k, k, limit.long())
    with pytest.raises(ValueError):  # head_dim 100, not a multiple of 8
        tda.decode_attention(torch.zeros((2, 8, 100), device="cuda"),
                             *(torch.zeros((2, 2, 32, 100), device="cuda"),) * 2, limit)


# -- the split decode kernels at their split boundaries (csrc/split_decode.cuh) --
def _split_limits():
    from nos_tpu_torch.ops import _build

    k = _build.split_keys()
    return [1, k - 1, k, k + 1, 2 * k - 1, 2 * k, 2 * k + 1, 4 * k + 5]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("nh,nkv,hd,bs", [(8, 2, 64, 32), (4, 4, 128, 16), (12, 1, 256, 24)])
def test_paged_decode_split_boundaries(cuda_device, dtype, nh, nkv, hd, bs):
    """The paged decode kernel at one key short of, at and one past the
    first and second split, and past the table's keys (block sizes 32 and
    16; 24 stops short of them): within the bounds
    of test_kernels_match_plain, two launches equal bit for bit, each on
    the "split" route; limit 0 gives zeros (every weight masked, as the
    Pallas kernel's)."""
    limits = _split_limits()
    rng = np.random.RandomState(hd + bs)
    b, total = len(limits), 1 + len(limits) * (-(-max(limits) // bs))
    n_pages = -(-(max(limits) - 5) // bs)
    quant = dtype == "int8"
    qdt = torch.float32 if dtype == "float32" else torch.bfloat16
    k, v, ks, vs, _, _ = _case(rng, b, nkv, hd, bs, n_pages, total, quant, qdt, cuda_device)
    table = torch.from_numpy(rng.permutation(np.arange(1, total))[: b * n_pages]
                             .reshape(b, n_pages).astype(np.int32)).to(cuda_device)
    q = torch.from_numpy(rng.randn(b, nh, hd).astype(np.float32)).to(cuda_device, qdt)
    lim = torch.tensor(limits, dtype=torch.int32, device=cuda_device)
    before = dict(tpa.ROUTE_LAUNCHES["paged_decode_attention"])
    got = tpa.paged_decode_attention(q, k, v, table, lim, ks, vs)
    again = tpa.paged_decode_attention(q, k, v, table, lim, ks, vs)
    zero = tpa.paged_decode_attention(q, k, v, table, lim * 0, ks, vs)
    want = tpa._reference(q, k, v, table, lim, ks, vs)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(got, again) and bool((zero == 0).all())
    assert tpa.ROUTE_LAUNCHES["paged_decode_attention"] == {"split": before["split"] + 3}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nh,nkv,hd", [(8, 2, 64), (4, 4, 128), (12, 1, 256)])
def test_dense_decode_split_boundaries(cuda_device, dtype, nh, nkv, hd):
    """The dense decode kernel at the split boundaries, at limit 0 (the
    mean of V over every position) and past max: within DECODE_TOL, two
    launches equal bit for bit, each on the "split" route."""
    from nos_tpu_torch.ops import decode_attention as tda
    from nos_tpu_torch.ops.flash_attention import flash_err

    limits = [0] + _split_limits()
    max_len = limits[-1] - 5
    gen = torch.Generator(device="cuda").manual_seed(hd + nh)
    dt = getattr(torch, dtype)
    b = len(limits)
    q = torch.randn((b, nh, hd), generator=gen, device="cuda").to(dt)
    kc, vc = (torch.randn((b, nkv, max_len, hd), generator=gen, device="cuda").to(dt)
              for _ in range(2))
    lim = torch.tensor(limits, dtype=torch.int32, device="cuda")
    before = dict(tda.ROUTE_LAUNCHES["decode_attention"])
    got = tda.decode_attention(q, kc, vc, lim)
    again = tda.decode_attention(q, kc, vc, lim)
    want = tda._reference(q, kc, vc, lim)
    torch.cuda.synchronize()
    assert flash_err(got, want) <= DECODE_TOL[dtype]
    assert torch.equal(got, again)
    assert tda.ROUTE_LAUNCHES["decode_attention"] == {"split": before["split"] + 2}


# -- tensor parallelism: the sharded paged kernels and a tp=2 engine ---------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nkv", [2, 4], ids=["nkv_per_shard_1", "nkv_per_shard_2"])
def test_sharded_kernels_bit_identical_per_head(cuda_device, dtype, nkv):
    """Two shards, each with nh/2 query heads and nkv/2 KV heads of every
    block: each shard's output equals the unsharded kernel's on its heads,
    bit for bit, and each shard is one launch on the sharded count."""
    rng = np.random.RandomState(21)
    b, nh, hd, bs, n_pages, total, w = 4, 8, 64, 32, 6, 40, 16
    qdt = getattr(torch, dtype)
    k, v, _, _, table, owned = _case(rng, b, nkv, hd, bs, n_pages, total, False, qdt,
                                     cuda_device)

    def heads(x):
        return [t.contiguous() for t in x.chunk(2, dim=1)]

    q = torch.from_numpy(rng.randn(b, nh, hd).astype(np.float32)).to(cuda_device, qdt)
    limit = torch.tensor([rng.randint(1, o * bs + 1) for o in owned], dtype=torch.int32,
                         device=cuda_device)
    before = dict(tpa.LAUNCHES)
    got = tpa.paged_decode_attention_sharded(heads(q), heads(k), heads(v), table, limit)
    whole = tpa.paged_decode_attention(q, k, v, table, limit)
    torch.cuda.synchronize()
    assert all(torch.equal(g, x) for g, x in zip(got, heads(whole)))
    qw = torch.from_numpy(rng.randn(b, nh, w, hd).astype(np.float32)).to(cuda_device, qdt)
    pos = torch.tensor([rng.randint(0, max(1, o * bs - w) + 1) for o in owned],
                       dtype=torch.int32, device=cuda_device)
    lengths = torch.tensor([w, 3, 1, w], dtype=torch.int32, device=cuda_device)
    mask = torch.tensor([True, True, False, True], device=cuda_device)
    routes = dict(tpa.ROUTE_LAUNCHES["paged_window_attention_sharded"])
    got = tpa.paged_window_attention_sharded(heads(qw), heads(k), heads(v), table, pos,
                                             lengths, mask)
    whole = tpa.paged_window_attention(qw, k, v, table, pos, lengths, mask)
    torch.cuda.synchronize()
    assert all(torch.equal(g, x) for g, x in zip(got, heads(whole)))
    for name in ("paged_decode_attention", "paged_window_attention"):
        assert tpa.LAUNCHES[name + "_sharded"] == before[name + "_sharded"] + 2
        assert tpa.LAUNCHES[name] == before[name] + 1
    route = "mma" if dtype == "bfloat16" else "simt"
    assert tpa.ROUTE_LAUNCHES["paged_window_attention_sharded"][route] == routes[route] + 2


def test_tp2_engine_tokens_equal_tp1(cuda_device):
    """A small f32 model served at tp=2 with both shards on one card gives
    the tp=1 engine's tokens, through the sharded kernels."""
    from nos_tpu_torch import DecodeServer, GPTConfig, init_gpt
    from nos_tpu_torch.parallel import build_mesh

    cfg = GPTConfig(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2, max_seq=256,
                    dtype="float32")
    params = init_gpt(cfg, torch.Generator().manual_seed(0), device=cuda_device)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 96, size=n).tolist() for n in (5, 20, 40)]

    def serve(mesh):
        server = DecodeServer(params, cfg, mesh=mesh, device=None if mesh else cuda_device,
                              n_slots=3, max_len=128, prompt_buckets=(8, 16),
                              steps_per_dispatch=4, block_size=8)
        futs = [server.submit(p, max_new=12) for p in prompts]
        while not all(f.done() for f in futs):
            server._tick()
        return [f.result() for f in futs]

    want = serve(None)
    before = dict(tpa.LAUNCHES)
    assert serve(build_mesh({"tp": 2}, devices=["cuda:0", "cuda:0"])) == want
    for name in ("paged_decode_attention_sharded", "paged_window_attention_sharded"):
        assert tpa.LAUNCHES[name] > before[name]
    assert tpa.LAUNCHES["paged_decode_attention"] == before["paged_decode_attention"]


def _graph_engine(cuda_device, dtype, temperature, mesh=None, kv_dtype="fp16"):
    """A small engine on the card after one tick (every prompt prefilled
    unbudgeted, one window run), lane 1 cut to 3 steps so that it ends
    mid-window, its tick state synced: the state a window runs from."""
    from nos_tpu_torch import DecodeServer, GPTConfig, init_gpt

    cfg = GPTConfig(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2, max_seq=256,
                    dtype=dtype)
    params = init_gpt(cfg, torch.Generator().manual_seed(0), device=cuda_device)
    server = DecodeServer(params, cfg, mesh=mesh, device=None if mesh else cuda_device,
                          n_slots=3, max_len=128, prompt_buckets=(8, 16),
                          steps_per_dispatch=8, block_size=8, temperature=temperature,
                          seed=3, eos_id=95, prefill_budget_tokens=0, kv_dtype=kv_dtype)
    rng = np.random.RandomState(9)
    futs = [server.submit(rng.randint(1, 95, size=n).tolist(), max_new=40)
            for n in (5, 20, 33)]
    server._tick()
    assert all(s.active and s.phase == "decoding" for s in server._slots)
    server._slots[1].remaining = 3
    server._tick_state.mark_dirty()
    server._sync_tick_state()
    return server, futs


def _window_tensors(server):
    st = server._tick_state
    pools = server.cache if isinstance(server.cache, list) else [server.cache]
    return ([st.pos, st.step, st.steps_left, server._last_dev, server._finished]
            + [t for pool in pools for layer in pool.values() for t in layer.values()])


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "sampled"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tp", [1, 2])
def test_replayed_window_equals_eager_macro(cuda_device, dtype, temperature, tp):
    """From one engine state, the captured window's replay and the eager
    `_macro` give the same [K, n_slots] tokens, the same advanced pos /
    step / steps_left / last tokens / eos carry, and byte for byte the same
    pool outside the scratch page (block 0, which masked lanes write in an
    unspecified order); the replay adds the eager window's launch counts
    (at tp=2, through the sharded entry point, both shards in one graph)."""
    from nos_tpu_torch.parallel import build_mesh
    from nos_tpu_torch.runtime import decode_server as ds

    mesh = build_mesh({"tp": 2}, devices=["cuda:0", "cuda:0"]) if tp == 2 else None
    server, futs = _graph_engine(cuda_device, dtype, temperature, mesh)
    assert server.graph_captures == 1 and server.graph_replays > 0
    start = [t.clone() for t in _window_tensors(server)]
    runs = []
    for run in (server._macro, server._window):
        for t, v in zip(_window_tensors(server), start):
            t.copy_(v)
        before = ds._launch_counts()
        toks = run().clone()
        torch.cuda.synchronize()
        after = ds._launch_counts()
        runs.append((toks, [t.clone() for t in _window_tensors(server)],
                     {k: n - before[k] for k, n in after.items() if n != before[k]}))
    (toks_e, state_e, launches_e), (toks_g, state_g, launches_g) = runs
    assert torch.equal(toks_g, toks_e)
    assert launches_g == launches_e and sum(launches_e.values()) == 8 * 2 * tp
    for got, want in zip(state_g[:5], state_e[:5]):
        assert torch.equal(got, want)
    for got, want in zip(state_g[5:], state_e[5:]):
        assert torch.equal(got[1:].view(torch.uint8), want[1:].view(torch.uint8))
    assert not torch.equal(state_e[0], start[0])  # the window advanced
    for f in futs:
        f.cancel()
    server.stop()


def test_engine_windows_replay_and_match_eager(cuda_device):
    """A served f32 greedy run on the card replays the graph for every window
    (per-tick and burst) and gives the tokens of the same engine run with
    eager windows."""
    from nos_tpu_torch import DecodeServer, GPTConfig, init_gpt

    cfg = GPTConfig(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2, max_seq=256,
                    dtype="float32")
    params = init_gpt(cfg, torch.Generator().manual_seed(0), device=cuda_device)
    rng = np.random.RandomState(4)
    reqs = [(rng.randint(1, 96, size=n).tolist(), m) for n, m in ((7, 30), (18, 45))]

    def serve(graph):
        server = DecodeServer(params, cfg, device=cuda_device, n_slots=2, max_len=96,
                              prompt_buckets=(8, 16), steps_per_dispatch=4, block_size=8)
        if not graph:
            server._graph = None
        futs = [server.submit(p, max_new=m) for p, m in reqs]
        while not all(f.done() for f in futs):
            server._tick()
        return [f.result() for f in futs], server

    want, eager = serve(graph=False)
    got, server = serve(graph=True)
    assert got == want and eager.graph_replays == 0
    assert server.burst_dispatches > 0
    assert server.graph_replays == server.macro_dispatches + server.burst_windows_run


def test_capture_that_copies_from_host_raises(cuda_device):
    """A window body that builds a tensor from host data cannot be
    captured: the capture raises (nothing falls back to eager windows)."""
    from nos_tpu_torch.runtime.decode_server import _WindowGraph

    x = torch.ones(4, device=cuda_device)

    def body():
        return x + torch.tensor([1.0, 2.0, 3.0, 4.0], device=cuda_device)

    with pytest.raises(RuntimeError):
        _WindowGraph(body, cuda_device)


@pytest.mark.parametrize("dead", ["graph", "engine"])
def test_capture_survives_a_dead_cycle_collected_mid_capture(cuda_device, dead):
    """A dead engine left in a reference cycle still holds its captured
    graph, its pool and its pinned token buffers until the cyclic collector
    runs. A collection during another window's capture would free them
    there and invalidate that capture, so the capture collects them first:
    a collection inside the capture then finds nothing of them, and the
    new window captures and replays."""
    import gc

    from nos_tpu_torch.runtime.decode_server import _WindowGraph

    x = torch.ones(4, device=cuda_device)

    class Cycle:
        pass

    held = Cycle()
    held.cycle = held
    if dead == "graph":
        held.graph = _WindowGraph(lambda: x * 2, cuda_device)
        held.pinned = torch.empty(4, pin_memory=True).copy_(x, non_blocking=True)
    else:
        held.server, held.futs = _graph_engine(cuda_device, "float32", 0.0)
        for f in held.futs:
            f.cancel()
        held.server.stop()
    del held

    def body():
        if torch.cuda.is_current_stream_capturing():
            gc.collect()
        return x + 1

    graph = _WindowGraph(body, cuda_device)
    assert torch.equal(graph.replay(), x + 1)


# -- the spill tier's and the radix tree's copies, and verify windows -----------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tp", [1, 2])
def test_block_copies_byte_for_byte(cuda_device, dtype, tp):
    """On the card, `_extract_block` then `_dispatch_revive` writes a block
    byte for byte its payload, `_cow_copy` copies exactly the first `length`
    rows of its source, nothing else in the pool moves, and a payload at
    tp=2 (two shards on one card) is byte for byte the tp=1 payload."""
    from nos_tpu_torch import DecodeServer, GPTConfig, init_gpt
    from nos_tpu_torch.parallel import build_mesh

    cfg = GPTConfig(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2, max_seq=256,
                    dtype=dtype)
    params = init_gpt(cfg, torch.Generator().manual_seed(0), device=cuda_device)

    def engine(width):
        mesh = build_mesh({"tp": 2}, devices=["cuda:0", "cuda:0"]) if width == 2 else None
        server = DecodeServer(params, cfg, mesh=mesh, device=None if mesh else cuda_device,
                              n_slots=2, max_len=64, prompt_buckets=(8, 16), block_size=8,
                              total_blocks=10)
        gen = torch.Generator(device="cuda").manual_seed(1)
        pools = server.cache if width == 2 else [server.cache]
        for pool in pools:
            for layer in pool.values():
                for t in layer.values():
                    t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
        return server, pools

    def raw(t):
        return t.contiguous().view(torch.uint8)

    server, pools = engine(tp)
    before = [[t.clone() for layer in pool.values() for t in layer.values()] for pool in pools]
    (k, v), nbytes = server._extract_block(3)
    assert k.device.type == "cpu" and nbytes == server._bytes_per_block
    assert server._dispatch_revive((k, v), 5)
    server._cow_copy(2, 6, 5)
    torch.cuda.synchronize()
    width = cfg.n_kv // tp
    for s, pool in enumerate(pools):
        tensors = [t for layer in pool.values() for t in layer.values()]
        for j, (t, old) in enumerate(zip(tensors, before[s])):
            layer, which = divmod(j, 2)
            payload = (k, v)[which][layer, s * width:(s + 1) * width]
            assert torch.equal(raw(t[5].cpu()), raw(payload))
            assert torch.equal(raw(t[5]), raw(old[3]))
            assert torch.equal(raw(t[6, :, :5]), raw(old[2, :, :5]))
            assert torch.equal(raw(t[6, :, 5:]), raw(old[6, :, 5:]))
            rest = [b for b in range(10) if b not in (5, 6)]
            assert torch.equal(raw(t[rest]), raw(old[rest]))
    if tp == 2:
        # The tp=1 pool holding the two shards' heads side by side.
        one, _ = engine(1)
        for name, layer in one.cache.items():
            for n, t in layer.items():
                t.copy_(torch.cat([pool[name][n] for pool in pools], dim=1))
        (k1, v1), _ = one._extract_block(4)
        (k2, v2), _ = server._extract_block(4)
        assert torch.equal(raw(k1), raw(k2)) and torch.equal(raw(v1), raw(v2))


@pytest.mark.parametrize("tp", [1, 2])
def test_verify_window_route_and_plain(cuda_device, tp):
    """A verify window (W = 9, bf16, head_dim 64) takes the window kernel's
    mma route (at tp=2 through the sharded entry point, once per shard) and
    is held to the plain version within chip_smoke.py's bf16 bounds."""
    rng = np.random.RandomState(3)
    b, nh, nkv, hd, bs, total, w = 8, 8, 2, 64, 32, 400, 9
    k = torch.from_numpy(rng.randn(total, nkv, bs, hd).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    v = torch.from_numpy(rng.randn(total, nkv, bs, hd).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    table = torch.from_numpy(rng.permutation(np.arange(1, total))[: b * 40]
                             .reshape(b, 40).astype(np.int32)).to(cuda_device)
    q = torch.from_numpy(rng.randn(b, nh, w, hd).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    pos = torch.tensor(rng.randint(1100, 1150, b), dtype=torch.int32, device=cuda_device)
    lengths = torch.tensor(rng.randint(1, w + 1, b), dtype=torch.int32, device=cuda_device)
    mask = torch.tensor([True] * (b - 1) + [False], device=cuda_device)
    want = tpa._window_reference(q, k, v, table, pos, lengths, mask)
    if tp == 1:
        name = "paged_window_attention"
        before = dict(tpa.ROUTE_LAUNCHES[name])
        got = tpa.paged_window_attention(q, k, v, table, pos, lengths, mask)
    else:
        name = "paged_window_attention_sharded"
        before = dict(tpa.ROUTE_LAUNCHES[name])
        half = nh // 2
        parts = tpa.paged_window_attention_sharded(
            [q[:, :half].contiguous(), q[:, half:].contiguous()],
            [k[:, :1].contiguous(), k[:, 1:].contiguous()],
            [v[:, :1].contiguous(), v[:, 1:].contiguous()],
            [table, table], [pos, pos], [lengths, lengths], [mask, mask])
        got = torch.cat(parts, dim=1)
    torch.cuda.synchronize()
    assert tpa.ROUTE_LAUNCHES[name]["mma"] - before["mma"] == tp
    live = (torch.arange(w, device=cuda_device)[None, :] < lengths[:, None]) & mask[:, None]
    err = (got.float() - want.float()).abs()[live[:, None, :, None].expand_as(got)]
    scale = want.float().abs()[live[:, None, :, None].expand_as(want)].max()
    assert err.max() <= 5e-3 and err.max() <= 2e-2 * scale, (err.max(), scale)


def test_engine_speculation_and_radix_on_card(cuda_device):
    """A small f32 engine on the card with its defaults (radix cache, spill
    tier) and spec_k=4: a regenerated request drafts from the tree and a
    repetitive one from its history, verify windows run the window kernel,
    every decode window is a graph replay, and the tokens equal spec-off's
    (f32 on a random model: cross-program rounding never flips a pick)."""
    from nos_tpu_torch import DecodeServer, GPTConfig, init_gpt

    cfg = GPTConfig(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2, max_seq=256,
                    dtype="float32")
    params = init_gpt(cfg, torch.Generator().manual_seed(0), device=cuda_device)
    donor = [((i * 5) % 91) + 1 for i in range(24)]
    reqs = [(donor, 16), (donor, 16), ([3, 1, 4, 1, 5, 9, 2, 6] * 3, 24)]

    def serve(**kw):
        server = DecodeServer(params, cfg, device=cuda_device, n_slots=2, max_len=96,
                              prompt_buckets=(8, 16), steps_per_dispatch=4, block_size=8,
                              **kw)
        outs = []
        for p, m in reqs:
            fut = server.submit(p, max_new=m)
            while not fut.done():
                server._tick()
            outs.append(fut.result())
        return outs, server

    want, _ = serve()
    before = dict(tpa.ROUTE_LAUNCHES["paged_window_attention"])
    got, server = serve(spec_k=4, spec_sync=True)
    assert got == want
    assert server.spec_tree_rounds > 0 and server.spec_tree_tokens_accepted > 0
    assert server.spec_history_rounds > 0
    assert tpa.ROUTE_LAUNCHES["paged_window_attention"]["simt"] > before["simt"]
    assert server.graph_replays == server.macro_dispatches + server.burst_windows_run


# -- the int8 pool ---------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tp", [1, 2])
def test_replayed_int8_window_equals_eager_macro(cuda_device, dtype, tp):
    """Over an int8 pool (the write funnel inside the captured window), the
    replay and the eager `_macro` from one engine state give the same
    tokens and state, and byte for byte the same codes and scales outside
    the scratch page; at tp=2 the shards' scale copies stay equal."""
    from nos_tpu_torch.parallel import build_mesh

    mesh = build_mesh({"tp": 2}, devices=["cuda:0", "cuda:0"]) if tp == 2 else None
    server, futs = _graph_engine(cuda_device, dtype, 0.0, mesh, kv_dtype="int8")
    assert server.graph_captures == 1 and server.kv_quant_enabled == 1
    start = [t.clone() for t in _window_tensors(server)]
    runs = []
    for run in (server._macro, server._window):
        for t, v in zip(_window_tensors(server), start):
            t.copy_(v)
        toks = run().clone()
        torch.cuda.synchronize()
        runs.append((toks, [t.clone() for t in _window_tensors(server)]))
    (toks_e, state_e), (toks_g, state_g) = runs
    assert torch.equal(toks_g, toks_e)
    for got, want in zip(state_g[:5], state_e[:5]):
        assert torch.equal(got, want)
    for got, want in zip(state_g[5:], state_e[5:]):
        assert torch.equal(got[1:].view(torch.uint8), want[1:].view(torch.uint8))
    assert not torch.equal(state_e[0], start[0])
    if tp == 2:
        for a, b in zip(server.cache[0].values(), server.cache[1].values()):
            assert torch.equal(a["k_scale"], b["k_scale"])
            assert torch.equal(a["v_scale"], b["v_scale"])
    for f in futs:
        f.cancel()
    server.stop()


def test_int8_engine_matches_its_plain_programs(cuda_device, monkeypatch):
    """A small f32 int8 engine on the card (its defaults, every window a
    replay): each served token is the greedy pick of a teacher-forced pass
    of the same programs over an int8 pool with the kernels' plain
    versions, chunked as the engine chunks (16-token chunks, 8-token
    blocks), and the engine launched the split decode kernel and the
    window's simt route."""
    from nos_tpu_torch import DecodeServer, GPTConfig, init_gpt
    from nos_tpu_torch.models import decode as D

    cfg = GPTConfig(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2, max_seq=256,
                    dtype="float32")
    params = init_gpt(cfg, torch.Generator().manual_seed(0), device=cuda_device)
    rng = np.random.RandomState(4)
    reqs = [(rng.randint(1, 96, size=n).tolist(), m) for n, m in ((7, 30), (18, 45), (33, 20))]
    server = DecodeServer(params, cfg, device=cuda_device, n_slots=2, max_len=96,
                          prompt_buckets=(8, 16), steps_per_dispatch=4, block_size=8,
                          kv_dtype="int8")
    before = {n: dict(r) for n, r in tpa.ROUTE_LAUNCHES.items()}
    futs = [server.submit(p, max_new=m) for p, m in reqs]
    while not all(f.done() for f in futs):
        server._tick()
    outs = [f.result() for f in futs]
    assert server.graph_replays == server.macro_dispatches + server.burst_windows_run > 0
    assert tpa.ROUTE_LAUNCHES["paged_decode_attention"]["split"] > before[
        "paged_decode_attention"]["split"]
    assert tpa.ROUTE_LAUNCHES["paged_window_attention"]["simt"] > before[
        "paged_window_attention"]["simt"]
    assert tpa.ROUTE_LAUNCHES["paged_window_attention"]["mma"] == before[
        "paged_window_attention"]["mma"]
    monkeypatch.setattr(tpa, "paged_decode_attention", tpa._reference)
    monkeypatch.setattr(tpa, "paged_window_attention", tpa._window_reference)
    for (prompt, m), out in zip(reqs, outs):
        n_pages = -(-(len(prompt) + m) // 8)
        cache = D.init_paged_cache(cfg, 1 + n_pages, 8, kv_dtype="int8", device=cuda_device)
        row = torch.arange(1, n_pages + 1, dtype=torch.int32, device=cuda_device)
        picks = []
        for start in range(0, len(prompt), 16):
            piece = prompt[start:start + 16]
            toks = torch.zeros((1, 8 if len(piece) <= 8 else 16), dtype=torch.int32,
                               device=cuda_device)
            toks[0, :len(piece)] = torch.tensor(piece, dtype=torch.int32)
            lg, _ = D.paged_prefill_chunk(params, toks, cfg, cache, row, start, len(piece), 8)
        picks.append(int(D.greedy(lg[len(piece) - 1][None, :])[0]))
        mask = torch.ones((1,), dtype=torch.bool, device=cuda_device)
        for t in range(m - 1):
            lg, _ = D.paged_decode_step(
                params, torch.tensor([out[t]], dtype=torch.int32, device=cuda_device), cfg,
                cache, row[None, :], torch.tensor([len(prompt) + t], dtype=torch.int32,
                                                  device=cuda_device), mask, 8)
            picks.append(int(D.greedy(lg)[0]))
        assert picks == out


# -- f32 across program shapes (ROADMAP C) ----------------------------------------
def _f32_steps(a, b):
    """|a - b| in f32 steps of each row's magnitude (the ulp of the row's
    largest |b|, as a logit's step is read at the top logit), entry by
    entry over the last axis."""
    a, b = a.double(), b.double()
    top = b.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    return (a - b).abs() / torch.exp2(torch.floor(torch.log2(top)) - 23)


def test_f32_rows_across_program_shapes(cuda_device):
    """The engine serves a float32 model through programs of several shapes:
    a decode step projects its 8 lanes' rows (M = 8), a verify window 8 x 9
    rows (M = 72), a prefill chunk 256 rows. The same 8 rows through an f32
    projection at M = 8, 72 and 256, and one position's attention through
    the split decode kernel and through the window kernel's simt route (W =
    1 at pos = limit - 1, and as the last row of a 16-row window), in f32
    steps of each row's magnitude. Both differ by shape on an H100: the
    projection (cuBLAS picks its kernel, and with it the summation order,
    by M) by up to 5.3 steps at 89% of the entries, the attention (the split
    kernel sums 128-key splits and combines them, the window walks a page
    at a time) by up to 20 steps at 94%. Held here to a bound of three times
    those: both differ, and neither by more."""
    rng = np.random.RandomState(7)
    dev = cuda_device
    hidden, out = 512, 1536  # the bench GPT's width and its MLP's
    x = torch.from_numpy(rng.randn(256, hidden).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.randn(hidden, out) / np.sqrt(hidden)).astype(np.float32)).to(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    at8 = x[:8] @ w
    proj = {m: _f32_steps((x[:m] @ w)[:8], at8) for m in (72, 256)}
    # Attention at the serving heads: 8 lanes, limits across pages.
    b, nh, nkv, hd, bs = 8, 8, 2, 64, 32
    limits = [128, 160, 192, 224, 288, 320, 1000, 2048]
    n_pages = -(-max(limits) // bs)
    total = 1 + b * n_pages
    k, v = (torch.from_numpy(rng.randn(total, nkv, bs, hd).astype(np.float32)).to(dev)
            for _ in range(2))
    table = torch.from_numpy(rng.permutation(np.arange(1, total))[: b * n_pages]
                             .reshape(b, n_pages).astype(np.int32)).to(dev)
    q = torch.from_numpy(rng.randn(b, nh, hd).astype(np.float32)).to(dev)
    lim = torch.tensor(limits, dtype=torch.int32, device=dev)
    split = tpa.paged_decode_attention(q, k, v, table, lim)
    ones = torch.ones((b,), dtype=torch.int32, device=dev)
    live = torch.ones((b,), dtype=torch.bool, device=dev)
    w1 = tpa.paged_window_attention(q[:, :, None].contiguous(), k, v, table, lim - 1, ones,
                                    live)[:, :, 0]
    q16 = torch.from_numpy(rng.randn(b, nh, 16, hd).astype(np.float32)).to(dev)
    q16[:, :, 15] = q
    w16 = tpa.paged_window_attention(q16, k, v, table, lim - 16, ones * 16, live)[:, :, 15]
    torch.cuda.synchronize()
    attn = {"window_w1": _f32_steps(w1, split), "window_w16": _f32_steps(w16, split)}
    report = {name: {k: {"max_steps": d.max().item(), "differ": (d > 0).float().mean().item()}
                     for k, d in part.items()}
              for name, part in (("projection", proj), ("attention", attn))}
    print("f32 steps across shapes:", report)
    for part, bound in (("projection", 16.0), ("attention", 60.0)):
        for r in report[part].values():
            assert 0.0 < r["max_steps"] <= bound and r["differ"] > 0.0, (part, report)


def _quota_engine(cuda_device, quota, **kw):
    """A small f32 engine on the card, with a QuotaPolicy from `quota`
    shares (None: no quota)."""
    from nos_tpu_torch import DecodeServer, GPTConfig, init_gpt
    from nos_tpu_torch.runtime.quota import QuotaPolicy, TenantShare

    cfg = GPTConfig(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2, max_seq=256,
                    dtype="float32")
    params = init_gpt(cfg, torch.Generator().manual_seed(0), device=cuda_device)
    policy = None
    if quota is not None:
        policy = QuotaPolicy({t: TenantShare(*a) for t, a in quota.items()}, window_ticks=64)
    return DecodeServer(params, cfg, device=cuda_device, quota=policy, **kw)


def test_burst_counts_on_card_equal_host_bookkeeping(cuda_device):
    """The window writes each lane's executed steps into `_win_counts`
    inside the captured graph; a quota-armed burst copies them row by row
    and reads the [N, n_slots] counts back in exactly one blocking read,
    and they equal the host's nominal bookkeeping (a lane runs
    contiguously from the burst's first step until it runs out), as do
    the quota window's per-window entries. The same traffic without a
    quota reads nothing more back."""
    kw = dict(n_slots=3, max_len=128, prompt_buckets=(8, 16), steps_per_dispatch=4,
              block_size=8, burst_windows=4)
    on = _quota_engine(cuda_device, {"t": (0.2, 1.0)}, **kw)
    off = _quota_engine(cuda_device, None, **kw)
    rng = np.random.RandomState(6)
    reqs = [(rng.randint(1, 96, size=n).tolist(), m) for n, m in ((6, 13), (17, 30), (9, 45))]
    futs = {id(s): [s.submit(p, max_new=m, tenant="t") for p, m in reqs] for s in (on, off)}
    K, checked = 4, 0
    while not all(f.done() for f in futs[id(on)]):
        before = [(s.remaining, s.pos, s.active) for s in on._slots]
        b0, ob0, w0 = on.burst_dispatches, off.burst_dispatches, on.burst_windows_run
        s_on, s_off = on.blocking_syncs, off.blocking_syncs
        on._tick()
        off._tick()
        burst = on.burst_dispatches - b0
        assert burst == off.burst_dispatches - ob0
        assert (on.blocking_syncs - s_on) - (off.blocking_syncs - s_off) == burst
        if not burst:
            continue
        n = on.burst_windows_run - w0
        counts = on._burst_counts[:n].cpu().numpy()
        want = np.zeros_like(counts)
        for idx, (rem, pos, active) in enumerate(before):
            if active:
                total = min(n * K, rem, on.max_len - pos)
                want[:, idx] = [min(K, max(0, total - w * K)) for w in range(n)]
        assert np.array_equal(counts, want)
        entries = [dict(e) for e in list(on._quota._window)[-n:]]
        assert [e.get("t", 0) for e in entries] == want.sum(axis=1).tolist()
        checked += 1
    assert checked > 0
    assert [f.result() for f in futs[id(on)]] == [f.result() for f in futs[id(off)]]
    for s in (on, off):
        assert s.graph_captures == 1
        assert s.graph_replays == s.macro_dispatches + s.burst_windows_run


def test_preemption_mid_burst_keeps_one_capture_and_revives_bytes(cuda_device, monkeypatch):
    """A guaranteed tenant's arrival preempts the borrower while its first
    burst's refs are in flight: the checkpoint materializes through them,
    the spill copies follow the replays on the stream (each spilled
    payload is byte for byte the block as the windows left it), every
    revive writes its payload back byte for byte, and the engine keeps its
    one capture, every window a replay of it."""
    from nos_tpu_torch.runtime import decode_server as ds

    server = _quota_engine(cuda_device, {"gold": (0.6, 1.0), "free": (0.0, 1.0)}, n_slots=2,
                           total_blocks=8, max_len=48, prompt_buckets=(8, 16), block_size=8,
                           steps_per_dispatch=4, burst_windows=6)
    revived = []
    original = ds.DecodeServer._dispatch_revive

    def revive(self, payload, block):
        ok = original(self, payload, block)
        revived.append((block, [t.clone() for t in payload],
                        [t[:, 0].cpu() for t in self._gather_blocks([block])]))
        return ok

    monkeypatch.setattr(ds.DecodeServer, "_dispatch_revive", revive)
    rng = np.random.RandomState(8)
    free = server.submit(rng.randint(1, 96, size=10).tolist(), max_new=36, tenant="free")
    server._tick()
    server._tick()
    assert server.burst_dispatches > 0 and server._inflight
    idx = next(i for i, s in enumerate(server._slots) if s.active)
    held = {b: [t[:, 0].clone() for t in server._gather_blocks([b])]
            for b in server._block_mgr.slot_blocks(idx)}
    gold = server.submit(rng.randint(1, 96, size=8).tolist(), max_new=6, tenant="gold")
    spilled = []
    reader = server._block_mgr._spill_reader

    def spy(block):
        payload = reader(block)
        spilled.append((block, payload))
        return payload

    server._block_mgr._spill_reader = spy
    server._tick()  # quota enforcement preempts the borrower, its burst in flight
    assert server.preemptions == 1 and spilled
    for block, (payload, _) in spilled:
        assert block in held
        for got, want in zip(payload, held[block]):
            assert torch.equal(got.view(torch.uint8), want.cpu().view(torch.uint8))
    while not (free.done() and gold.done()):
        server._tick()
    assert revived
    for _, payload, written in revived:
        for got, want in zip(written, payload):
            assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert len(free.result()) == 36 and len(gold.result()) == 6
    assert server.graph_captures == 1
    assert server.graph_replays == server.macro_dispatches + server.burst_windows_run
    assert server._block_mgr.conserved()


def _fleet_engine(cuda_device, params, cfg, **kw):
    from nos_tpu_torch import DecodeServer

    return DecodeServer(params, cfg, device=cuda_device, n_slots=2, max_len=96,
                        prompt_buckets=(8, 16), steps_per_dispatch=4, block_size=8, **kw)


def test_prewarm_then_serve_on_card(cuda_device):
    """`prewarm()` runs every bucket's prefill programs on the scratch page
    of an engine about to serve: the traffic after it gives the tokens of
    an engine without it, every window a replay of the one capture."""
    from nos_tpu_torch import GPTConfig, init_gpt

    cfg = GPTConfig(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2, max_seq=256,
                    dtype="float32")
    params = init_gpt(cfg, torch.Generator().manual_seed(0), device=cuda_device)
    rng = np.random.RandomState(6)
    reqs = [(rng.randint(1, 96, size=n).tolist(), m) for n, m in ((7, 30), (18, 25))]

    def serve(server):
        futs = [server.submit(p, max_new=m) for p, m in reqs]
        while not all(f.done() for f in futs):
            server._tick()
        return [f.result() for f in futs]

    want = serve(_fleet_engine(cuda_device, params, cfg))
    warm = _fleet_engine(cuda_device, params, cfg).prewarm()
    assert serve(warm) == want
    assert warm.graph_captures == 1
    assert warm.graph_replays == warm.macro_dispatches + warm.burst_windows_run > 0


def test_capture_under_live_engine_threads(cuda_device, monkeypatch):
    """Engines sharing the card each tick on their own thread while another
    engine is built, which captures its window meanwhile (a replica added
    under load): the new graph's launch delta is the one an engine built
    on an idle card captures, the serving engines' tokens are those of a
    run with no capture beside it, and every engine's windows are replays
    of its one capture. The serving engines' decoding slots and unresolved
    requests at the moment the capture began are printed, and some request
    must still be unresolved then (the capture ran under load)."""
    from nos_tpu_torch import GPTConfig, init_gpt
    from nos_tpu_torch.runtime import decode_server as ds

    cfg = GPTConfig(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2, max_seq=256,
                    dtype="float32")
    params = init_gpt(cfg, torch.Generator().manual_seed(0), device=cuda_device)
    rng = np.random.RandomState(7)
    reqs = [(rng.randint(1, 96, size=n).tolist(), 80) for n in (5, 9, 14, 6, 11, 3)]
    idle = _fleet_engine(cuda_device, params, cfg)
    want = []
    for _ in range(2):
        server = _fleet_engine(cuda_device, params, cfg)
        futs = [server.submit(p, max_new=m) for p, m in reqs]
        while not all(f.done() for f in futs):
            server._tick()
        want.append([f.result() for f in futs])
    engines = [_fleet_engine(cuda_device, params, cfg) for _ in range(2)]
    futs = [[e.submit(p, max_new=m) for p, m in reqs] for e in engines]
    for e in engines:
        e.start()
    # Both engines decoding (a slot each at least: waiting for every slot
    # at one instant could miss the overlap and spin past the traffic).
    deadline = time.monotonic() + 120
    while not all(any(s.active and s.phase == "decoding" for s in e._slots) for e in engines):
        assert time.monotonic() < deadline, "the serving engines never decoded"
        time.sleep(0.001)
    at_capture = []
    init = ds._WindowGraph.__init__

    def recording(self, body, device):
        at_capture.append({
            "decoding_slots": [sum(s.active and s.phase == "decoding" for s in e._slots)
                               for e in engines],
            "unresolved": [sum(not f.done() for f in fs) for fs in futs]})
        init(self, body, device)

    monkeypatch.setattr(ds._WindowGraph, "__init__", recording)
    new = _fleet_engine(cuda_device, params, cfg)  # built while both engines decode
    monkeypatch.undo()
    got = [[f.result(timeout=300) for f in fs] for fs in futs]
    for e in engines:
        e.stop()
    print(f"serving engines when the new engine's capture began: {at_capture}")
    assert len(at_capture) == 1 and sum(at_capture[0]["unresolved"]) > 0, at_capture
    assert got == want
    assert new._graph.delta == idle._graph.delta
    for e in engines + [new, idle]:
        assert e.graph_captures == 1
        assert e.graph_replays == e.macro_dispatches + e.burst_windows_run


@pytest.mark.parametrize("kv_dtype", ["fp16", "int8"], ids=["bf16", "int8"])
def test_handoff_payloads_equal_the_source_blocks(cuda_device, kv_dtype):
    """A bf16 engine's (and an int8 engine's) handoff export on the card: at
    the moment the hook receives the checkpoint, every payload the store
    holds for the exported prompt is byte for byte the source pool's block
    under that chain key (codes and scales for the int8 pool)."""
    from nos_tpu_torch import DecodeServer, GPTConfig, constants, init_gpt
    from nos_tpu_torch.serving import FleetKVStore

    cfg = GPTConfig(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2, max_seq=256,
                    dtype="bfloat16")
    params = init_gpt(cfg, torch.Generator().manual_seed(0), device=cuda_device)
    store = FleetKVStore(1 << 24)
    server = DecodeServer(params, cfg, device=cuda_device, n_slots=2, max_len=96,
                          prompt_buckets=(8, 16), steps_per_dispatch=4, block_size=8,
                          kv_store=store, kv_dtype=kv_dtype)
    names = ("k", "v", "k_scale", "v_scale") if kv_dtype == "int8" else ("k", "v")
    seen, mismatched = [], []

    def hook(ck):
        # The engine contains a raising hook, so the checks record instead.
        torch.cuda.synchronize()
        index = server._block_mgr._prefix_index
        for key in store.keys():
            payload = store.get(key)
            if kv_dtype == "int8":
                if payload[0] != constants.KV_DTYPE_INT8:
                    mismatched.append((key, "tag"))
                payload = payload[1:]
            block = index[key]
            for got, name in zip(payload, names):
                want = torch.stack([server.cache[str(i)][name][block]
                                    for i in range(cfg.layers)])
                if not torch.equal(got.contiguous().view(torch.uint8),
                                   want.cpu().contiguous().view(torch.uint8)):
                    mismatched.append((key, name))
            seen.append(key)
        ck.future.set_result(list(ck.generated))

    server.set_handoff_hook(hook)
    rng = np.random.RandomState(8)
    futs = [server.transfer_in_request(rng.randint(1, 96, size=n).tolist(), 6, handoff=True)
            for n in (27, 41)]
    for _ in range(2000):
        if all(f.done() for f in futs):
            break
        server._tick()
    assert all(f.done() for f in futs) and not mismatched, mismatched
    assert server.handoff_exports == 2 and len(seen) >= 3 + 5
    assert server._block_mgr.conserved()


def test_handed_off_stream_replays_on_a_second_engine(cuda_device):
    """A prefill engine and a decode engine on one card behind a
    HandoffCoordinator, ticked by hand: every stream resolves with its
    tokens, the decode engine revives the handed-off prompt blocks from the
    store instead of recomputing them, and every decode window of either
    engine is a replay of its one capture."""
    from nos_tpu_torch import DecodeServer, GPTConfig, constants, init_gpt
    from nos_tpu_torch.serving import (FleetKVStore, HandoffCoordinator, PrefixRouter,
                                       ReplicaSet)

    cfg = GPTConfig(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2, max_seq=256,
                    dtype="bfloat16")
    params = init_gpt(cfg, torch.Generator().manual_seed(0), device=cuda_device)
    store = FleetKVStore(1 << 24)
    engines = [_fleet_engine(cuda_device, params, cfg, kv_store=store) for _ in range(2)]
    rs = ReplicaSet(engines, roles=[constants.REPLICA_ROLE_PREFILL,
                                    constants.REPLICA_ROLE_DECODE])
    coord = HandoffCoordinator(rs, PrefixRouter(rs, kv_store=store))
    rng = np.random.RandomState(9)
    futs = [coord.submit(rng.randint(1, 96, size=n).tolist(), max_new=40) for n in (19, 33, 12)]
    for _ in range(5000):
        if all(f.done() for f in futs):
            break
        for e in engines:
            e._tick()
    assert [len(f.result(timeout=0)) for f in futs] == [40, 40, 40]
    pre, dec = engines
    assert coord.handoffs == 3 and pre.handoff_exports == 3 and dec.handoff_ingests == 3
    assert dec.handoff_revived_tokens > 0
    for e in engines:
        assert e.graph_captures == 1
        assert e.graph_replays == e.macro_dispatches + e.burst_windows_run
        assert e._block_mgr.conserved()
    assert dec.graph_replays > 0 and store.conserved()
    coord.detach()
    rs.stop()


def test_vit_flash_route_on_the_card(cuda_device):
    """A 512-pixel bf16 ViT (1124 tokens, head_dim 64) takes the flash
    forward on "mma" once a layer; its detections against the same forward
    through the kernel's plain version: logits within 0.25, boxes within
    0.05 (chip_smoke.py's first VIT_FLASH_TOL)."""
    from nos_tpu_torch.models import vit
    from nos_tpu_torch.ops import flash_attention as fa

    cfg = vit.ViTConfig(image_size=512, hidden=128, layers=2, heads=2)
    params = vit.init_vit(cfg, torch.Generator().manual_seed(0), device=cuda_device)
    images = torch.rand((2, 512, 512, 3), generator=torch.Generator().manual_seed(1))
    images = images.to(cuda_device)
    before = {n: dict(r) for n, r in fa.ROUTE_LAUNCHES.items()}
    logits, boxes = vit.vit_forward(params, images, cfg)
    assert fa.ROUTE_LAUNCHES["flash_fwd"]["mma"] == before["flash_fwd"]["mma"] + cfg.layers
    assert fa.ROUTE_LAUNCHES["flash_fwd"]["simt"] == before["flash_fwd"]["simt"]
    real = vit.flash_attention
    vit.flash_attention = lambda q, k, v, causal=False: fa._flash_fwd_reference(
        q, k, v, causal, q.shape[-1] ** -0.5)[0]
    try:
        p_logits, p_boxes = vit.vit_forward(params, images, cfg)
    finally:
        vit.flash_attention = real
    assert (logits - p_logits).abs().max().item() <= 0.25
    assert (boxes - p_boxes).abs().max().item() <= 0.05


def test_sharded_train_step_on_the_card(cuda_device):
    """dp 2 x tp 2 with every shard on one card, bf16, head_dim 64: one
    launch of each flash kernel a layer and a shard, all on "mma"; the loss
    of three steps within 1e-3 of the single-device step's and the replicas
    bit-identical."""
    from nos_tpu_torch.models import gpt, train
    from nos_tpu_torch.ops import flash_attention as fa
    from nos_tpu_torch.parallel import build_mesh
    from nos_tpu_torch.parallel.sharding import replica_groups, tree_leaves

    cfg = train.TrainConfig(model=gpt.GPTConfig(vocab=512, hidden=256, layers=2, heads=4,
                                                max_seq=256))
    mesh = build_mesh({"dp": 2, "tp": 2}, devices=[cuda_device] * 4)
    single, sopt = train.init_train_state(cfg, torch.Generator().manual_seed(0),
                                          device=cuda_device)
    sharded, mopt = train.init_train_state(cfg, torch.Generator().manual_seed(0), mesh=mesh)
    sstep, mstep = train.make_train_step(cfg), train.make_train_step(cfg, mesh)
    rng = np.random.RandomState(0)
    fa.reset_launch_counts()
    for _ in range(3):
        tokens = torch.from_numpy(rng.randint(0, 512, (4, 256)).astype(np.int32))
        tokens = tokens.to(cuda_device)
        single, sopt, a = sstep(single, sopt, tokens)
        sharded, mopt, b = mstep(sharded, mopt, tokens)
        assert abs(b["loss"].item() - a["loss"].item()) <= 1e-3 * abs(a["loss"].item())
    per_step = cfg.model.layers * (1 + 4)  # single device, then four shards
    assert fa.LAUNCHES == {n: 3 * per_step for n in fa.LAUNCHES}
    assert all(r["simt"] == 0 for r in fa.ROUTE_LAUNCHES.values())
    for path, spec in tree_leaves(sharded.specs):
        leaves = sharded.leaves(path)
        for group in replica_groups(mesh, spec):
            assert all(torch.equal(leaves[p], leaves[group[0]]) for p in group)


def test_measure_mfu_on_the_card(cuda_device):
    """runtime/mfu.py::measure_mfu on a [4096, 4096] x [4096, 4096] bf16
    product: the FLOP counter's 2 * n^3, the card's name and peak, an mfu
    in (0, 1] inside its range, and a step time within 25% of 50 products
    between two CUDA events."""
    from nos_tpu_torch.runtime import mfu

    n = 4096
    gen = torch.Generator().manual_seed(0)
    a, b = (torch.randn((n, n), generator=gen).to(cuda_device, torch.bfloat16)
            for _ in range(2))
    out = mfu.measure_mfu(torch.matmul, (a, b), device=cuda_device)
    assert out is not None
    assert out["device_kind"] == torch.cuda.get_device_name(cuda_device)
    assert out["peak_tflops"] * 1e12 == mfu.device_peak_flops(cuda_device)
    assert out["flops_source"] == "flop_counter" and out["flops_per_step"] == 2 * n ** 3
    lo, hi = out["mfu_range"]
    assert 0 < out["mfu"] <= 1 and lo <= out["mfu"] <= hi
    torch.matmul(a, b)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(50):
        torch.matmul(a, b)
    end.record()
    end.synchronize()
    events_s = start.elapsed_time(end) / 50 / 1e3
    assert abs(out["step_time_s"] / events_s - 1) <= 0.25, (out["step_time_s"], events_s)
