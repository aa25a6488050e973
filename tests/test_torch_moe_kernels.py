"""The expert layer's CUDA chain (nos_tpu_torch/ops/csrc/moe_experts.cu) and
the sliding-window bound of the paged kernels (csrc/split_decode.cuh,
csrc/paged_attention.cu) against their plain PyTorch versions, on the card;
and a small Mellum-layout engine served there.

Torch and numpy only, so it runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_moe_kernels.py

Every test carries the `cuda` marker and skips without a CUDA device
(decided in a fixture): the kernels have no CPU mode. Tolerances: the
expert chain in bf16 against the plain route, max|err| <= 2e-2 x max|want|
(the plain route rounds the gate and up products to bf16 before silu,
the kernel keeps them in f32: one bf16 rounding of the middle activation,
then of the expert outputs); the windowed kernels as test_torch_kernels.py
holds the unbounded ones (f32 1e-4, bf16 2e-2)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from nos_tpu_torch.ops import moe
from nos_tpu_torch.ops import paged_attention as tpa

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _experts(rng, t, h, f, e, dev, skew=True):
    """bf16 inputs of the expert layer. With `skew`, x > 0, the router's
    column 0 all +0.05 (every token picks expert 0) and its last all -0.05 (no
    token picks it)."""
    x = np.abs(rng.randn(t, h)).astype(np.float32) if skew else rng.randn(t, h).astype(
        np.float32)
    router = rng.randn(h, e).astype(np.float32) * h ** -0.5
    if skew:
        router[:, 0], router[:, -1] = 0.05, -0.05
    to = lambda a: torch.from_numpy(a).to(dev, torch.bfloat16)  # noqa: E731
    return (to(x), to(router), to(rng.randn(e, h, f).astype(np.float32) * h ** -0.5),
            to(rng.randn(e, h, f).astype(np.float32) * h ** -0.5),
            to(rng.randn(e, f, h).astype(np.float32) * f ** -0.5))


@pytest.mark.parametrize("t,masked,skew", [(8, False, True), (48, True, True),
                                           (200, True, False), (333, False, True)])
def test_expert_chain_matches_plain(cuda_device, t, masked, skew):
    """The chain against the plain route at both row tiles (16 and 64),
    with an expert every token takes, one none takes and masked rows; the
    tallies equal the plain route's counts, and two calls equal bit for
    bit."""
    rng = np.random.RandomState(t)
    h, f, e, k = 256, 128, 8, 4
    x, router, wg, wu, wd = _experts(rng, t, h, f, e, cuda_device, skew)
    valid = None
    if masked:
        valid = torch.from_numpy(rng.rand(t) > 0.3).to(cuda_device)
    tally = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    want_tally = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    before = moe.LAUNCHES["moe_experts"]
    got = moe.moe_experts(x, router, wg, wu, wd, k, True, valid=valid, tally=tally)
    again = moe.moe_experts(x, router, wg, wu, wd, k, True, valid=valid)
    want = moe._plain(x, router, wg, wu, wd, k, True, valid, want_tally)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-2 * want.float().abs().max().item(), err
    assert torch.equal(got, again)
    assert tally.tolist() == want_tally.tolist()
    assert moe.LAUNCHES["moe_experts"] == before + 2
    if valid is not None:
        assert bool((got[~valid] == 0).all())
    if skew:
        ids, _ = moe.route(x, router, k, True)
        assert bool((ids[:, 0] == 0).all()) and not bool((ids == e - 1).any())


def test_expert_chain_replays_as_a_graph(cuda_device):
    """A captured call replays to the eager call's bits, its tally adding
    on every replay; nothing reads back to the host during capture."""
    rng = np.random.RandomState(5)
    h, f, e, k, t = 256, 128, 8, 2, 48
    x, router, wg, wu, wd = _experts(rng, t, h, f, e, cuda_device, skew=False)
    valid = torch.ones(t, dtype=torch.bool, device=cuda_device)
    tally = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    eager = moe.moe_experts(x, router, wg, wu, wd, k, True, valid=valid, tally=tally)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    with torch.cuda.graph(graph, stream=side):
        out = moe.moe_experts(x, router, wg, wu, wd, k, True, valid=valid, tally=tally)
    torch.cuda.synchronize()
    first = tally.tolist()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert tally.tolist() == [first[0] * 4, first[1] * 4]


def _pool(rng, b, nkv, hd, bs, n_pages, qdt, dev):
    total = 1 + b * n_pages
    k = torch.from_numpy(rng.randn(total, nkv, bs, hd).astype(np.float32)).to(dev, qdt)
    v = torch.from_numpy(rng.randn(total, nkv, bs, hd).astype(np.float32)).to(dev, qdt)
    table = torch.from_numpy(rng.permutation(np.arange(1, total)).reshape(b, n_pages)
                             .astype(np.int32)).to(dev)
    return k, v, table


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nh,nkv,hd,bs,window", [(8, 2, 64, 32, 100), (32, 4, 128, 32, 1024),
                                                 (4, 4, 128, 16, 40)])
def test_windowed_decode_kernel(cuda_device, dtype, nh, nkv, hd, bs, window):
    """The split decode kernel with a window against the plain version, at
    limits whose bound lo = limit - window falls on a page boundary, just
    off it, at 0, below 0 and past a split; window 0 is the unbounded
    kernel bit for bit."""
    rng = np.random.RandomState(window)
    qdt = torch.float32 if dtype == "float32" else torch.bfloat16
    n_pages = -(-(window + 5 * bs) // bs)
    keys = n_pages * bs
    limits = [window + 2 * bs, window + 2 * bs + 1, window + 2 * bs - 1, window, window - 3,
              1, keys, keys - 129, window + 128]
    limits = [max(1, min(keys, x)) for x in limits]
    b = len(limits)
    k, v, table = _pool(rng, b, nkv, hd, bs, n_pages, qdt, cuda_device)
    q = torch.from_numpy(rng.randn(b, nh, hd).astype(np.float32)).to(cuda_device, qdt)
    lim = torch.tensor(limits, dtype=torch.int32, device=cuda_device)
    got = tpa.paged_decode_attention(q, k, v, table, lim, window=window)
    want = tpa._reference(q, k, v, table, lim, window=window)
    off = tpa.paged_decode_attention(q, k, v, table, lim, window=0)
    unbounded = tpa.paged_decode_attention(q, k, v, table, lim)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(off, unbounded)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nh,nkv,hd,bs,w,window", [(8, 2, 64, 32, 256, 100),
                                                   (32, 4, 128, 32, 64, 1024),
                                                   (8, 8, 128, 16, 37, 48)])
def test_windowed_window_kernel(cuda_device, dtype, nh, nkv, hd, bs, w, window):
    """The window kernel with a window (the mma route for bf16, simt for
    f32) against the plain version on every valid row, with bases whose
    rows' bounds fall on and off page and key-tile boundaries; window 0 is
    the unbounded kernel bit for bit."""
    rng = np.random.RandomState(w + window)
    qdt = torch.float32 if dtype == "float32" else torch.bfloat16
    n_pages = -(-(2 * window + w + 3 * bs) // bs)
    pos_list = [0, window - 7, window + bs, 2 * window + 1]
    b = len(pos_list)
    k, v, table = _pool(rng, b, nkv, hd, bs, n_pages, qdt, cuda_device)
    q = torch.from_numpy(rng.randn(b, nh, w, hd).astype(np.float32)).to(cuda_device, qdt)
    pos = torch.tensor([max(0, x) for x in pos_list], dtype=torch.int32, device=cuda_device)
    lengths = torch.tensor([w, w, max(1, w // 2), w], dtype=torch.int32, device=cuda_device)
    mask = torch.tensor([True, True, True, False], device=cuda_device)
    got = tpa.paged_window_attention(q, k, v, table, pos, lengths, mask, window=window)
    want = tpa._window_reference(q, k, v, table, pos, lengths, mask, window=window)
    off = tpa.paged_window_attention(q, k, v, table, pos, lengths, mask, window=0)
    unbounded = tpa.paged_window_attention(q, k, v, table, pos, lengths, mask)
    torch.cuda.synchronize()
    valid = (torch.arange(w, device=cuda_device)[None, :] < lengths[:, None]) & mask[:, None]
    diff = (got.float() - want.float()).abs().amax(dim=(1, 3))[valid]  # [rows]
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert diff.max().item() <= tol
    assert torch.equal(off, unbounded)


def _tiny_mellum():
    """The Mellum layout at a size the card serves in seconds: 4 layers (3
    sliding, 1 full), window 48, q width 512 over hidden 256, 8 experts
    top 4, YaRN at original 64."""
    from portbench import harness

    cfg = json.loads((ROOT / "portbench/configs/mellum2-12b-a2.5b.json").read_text())
    ropes = cfg["rope_parameters"]
    cfg.update(vocab_size=512, hidden_size=256, num_attention_heads=4, num_key_value_heads=2,
               head_dim=128, num_hidden_layers=4,
               layer_types=["sliding_attention"] * 3 + ["full_attention"],
               mlp_layer_types=["sparse"] * 4, sliding_window=48, num_experts=8,
               num_experts_per_tok=4, moe_intermediate_size=128, max_position_embeddings=256,
               rope_parameters={
                   "full_attention": dict(ropes["full_attention"], factor=4,
                                          original_max_position_embeddings=64),
                   "sliding_attention": ropes["sliding_attention"]})
    return cfg, harness.load_module("arch", "mellum"), harness.load_module("references",
                                                                           "mellum")


def test_mellum_engine_on_card(cuda_device):
    """A small Mellum-layout engine on the card: every decode window and
    batch-1 chunk a graph replay, the launch counts (zeroed just before the
    traffic) the host's count of programs times the layers, the tallies the
    exact row counts (prompt tokens and decode steps x top_k x layers), and
    every served token
    within 0.3 of the float32 reference's best logit (the benchmark's
    limit)."""
    from nos_tpu_torch.runtime.decode_server import DecodeServer

    cfg, arch, ref = _tiny_mellum()
    params = arch.make_params(cfg, 7, cuda_device)
    eng = DecodeServer(params, arch.engine_config(cfg), n_slots=4, max_len=224,
                       prompt_buckets=(32, 64), block_size=16, steps_per_dispatch=4,
                       prefill_budget_tokens=64, device=cuda_device, temperature=0.0)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, n).tolist() for n in (20, 64, 150, 90)]
    moe.reset_launch_counts()
    tpa.reset_launch_counts()
    eng.start()
    try:
        outs = [f.result(timeout=300) for f in [eng.submit(p, 40) for p in prompts]]
        counts = eng.expert_counts()
    finally:
        eng.stop()
    # Each window replay runs 4 steps of 4 layers, each chunk and wave 4
    # layers: the launch counts, replays included, are the host's.
    programs = eng.prefill_graph_replays + eng.prefill_eager_chunks + \
        eng.prefill_window_dispatches
    assert moe.LAUNCHES["moe_experts"] == 4 * (4 * eng.graph_replays + programs)
    assert tpa.LAUNCHES["paged_decode_attention"] == 4 * 4 * eng.graph_replays
    assert tpa.LAUNCHES["paged_window_attention"] == 4 * programs
    rows = 4 * 4  # top_k x layers
    assert counts["prefill_rows"] == rows * sum(len(p) for p in prompts)
    assert counts["decode_rows"] == rows * sum(len(o) - 1 for o in outs)
    assert 0 < counts["decode_expert_hits"] <= 8 * 4 * eng.graph_replays * 4
    assert eng.graph_replays > 0 and eng.prefill_graph_replays > 0
    assert eng.prefill_eager_chunks == 0
    for p, o in zip(prompts, outs):
        lg = ref.logits_at(params, cfg, p + list(o[:-1]), len(p) - 1)
        gap = lg.max(-1).values - lg.gather(1, torch.tensor(o, device=lg.device)[:, None])[:, 0]
        assert gap.max().item() <= 0.3
