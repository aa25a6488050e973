"""The port's CUDA kernels (nos_tpu_torch/ops/csrc/paged_attention.cu)
against their plain PyTorch versions, on the card.

Torch and numpy only (the card's machine has no JAX), so it runs there
without the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

The tests carry the `cuda` marker; without a CUDA device every test skips
(decided in a fixture): a kernel has no CPU mode. f32 is
held to atol 1e-4 (summation order); bf16 and int8 pools to 2e-2 (one bf16
rounding of the output, and the plain version's bf16 rounding of the
dequantized int8 values)."""

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
    # than a CUDA block has: the launcher refuses it and the wrapper raises.
    big = torch.zeros((3, 1, 256, 256), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(RuntimeError):
        tpa.paged_decode_attention(q[:1, :4, :].repeat(1, 1, 4).contiguous(), big, big,
                                   table[:1, :1].contiguous(), limit[:1].contiguous())
