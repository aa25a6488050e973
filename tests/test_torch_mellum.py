"""The Mellum 2 layout in the port against the benchmark's plain reference
(`portbench/references/mellum.py`), on the CPU in float32 at a small size:
4 layers of kinds [sliding x 3, full], head_dim 32 over a hidden size of 64
(q width 128), a window of 16 keys, 8 experts top 4, and YaRN at an
original length of 32. Also the pieces it rests on: YaRN's correction range
and attention factor at Mellum2's published numbers, the Llama layout's
bits through the new config fields, the paged kernels' plain versions with
and without a window against a plain masked attention, and the expert
layer's plain route against a token-by-token loop.

Tolerances: the port and the reference compute the same float32 math in
another order (fused QKV heads, blocked attention, per-expert row sets), so
logits agree to a few float32 ulps of their size: 1e-4 x max|logit|. The
engine's served tokens are the reference's best up to that (gap 1e-4)."""

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from nos_tpu_torch.models import decode as tdecode
from nos_tpu_torch.models import gpt as tgpt
from nos_tpu_torch.ops import moe
from nos_tpu_torch.ops import paged_attention as tpa
from portbench import harness

ROOT = Path(__file__).resolve().parent.parent
ARCH = harness.load_module("arch", "mellum")
REF = harness.load_module("references", "mellum")
WINDOW = 16


def tiny_config():
    cfg = json.loads((ROOT / "portbench/configs/mellum2-12b-a2.5b.json").read_text())
    ropes = cfg["rope_parameters"]
    cfg.update(vocab_size=97, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
               head_dim=32, num_hidden_layers=4,
               layer_types=["sliding_attention"] * 3 + ["full_attention"],
               mlp_layer_types=["sparse"] * 4, sliding_window=WINDOW, num_experts=8,
               num_experts_per_tok=4, moe_intermediate_size=32, max_position_embeddings=128,
               torch_dtype="float32",
               rope_parameters={
                   "full_attention": dict(ropes["full_attention"], factor=4,
                                          original_max_position_embeddings=32),
                   "sliding_attention": ropes["sliding_attention"]})
    return cfg


@pytest.fixture(scope="module")
def model():
    cfg = tiny_config()
    return cfg, ARCH.make_params(cfg, 11, torch.device("cpu")), ARCH.engine_config(cfg)


def test_yarn_at_mellum2s_published_numbers():
    """find_correction_range(32, 1, dim 128, theta 5e5, original 8192) with
    truncation gives 18 and 35; the attention factor is 0.1 ln 16 + 1; the
    port's frequencies equal the reference's to f32 rounding, the first 18
    extrapolated, from the 35th interpolated by the factor 16."""
    cfg = json.loads((ROOT / "portbench/configs/mellum2-12b-a2.5b.json").read_text())
    full = ARCH.engine_config(cfg).rope(3)
    assert full.yarn is not None and ARCH.engine_config(cfg).rope(0) == tgpt.RoPE(5e5)
    assert tgpt.yarn_correction_range(full, 128) == (18, 35)
    assert math.isclose(full.yarn.cos_sin_scale(), 0.1 * math.log(16) + 1, rel_tol=1e-15)
    got = tgpt._rope_freqs(64, full, torch.device("cpu")).double()
    want = REF.inv_freq(cfg["rope_parameters"]["full_attention"], 128, "cpu")
    assert torch.allclose(got, want, rtol=1e-6, atol=0)
    plain = 5e5 ** -(torch.arange(64, dtype=torch.float64) / 64)
    assert torch.allclose(got[:18], plain[:18], rtol=1e-6)
    assert torch.allclose(got[35:], plain[35:] / 16, rtol=1e-6)


def _llama_params(cfg):
    return tgpt.init_gpt(cfg, torch.Generator().manual_seed(3), device="cpu")


def test_llama_layout_same_bits_through_the_new_fields():
    """A Llama config spelled with the new fields at the values it implied
    (head_size = hidden // heads, every layer full, no YaRN, no experts) gives the same weights and the same logits, bit for
    bit, through a prefill chunk and a decode step."""
    base = tgpt.GPTConfig(vocab=61, hidden=64, layers=2, heads=4, kv_heads=2, dtype="float32",
                          rope_theta=5000.0)
    spelled = dataclasses.replace(base, head_size=16, layer_types=("full", "full"),
                                  sliding_window=7, rope_yarn=None, n_experts=0)
    outs = []
    for cfg in (base, spelled):
        params = _llama_params(cfg)
        pool = tdecode.init_paged_cache(cfg, 9, 8, device="cpu")
        table = torch.arange(1, 9, dtype=torch.int32)[None, :]
        toks = torch.arange(3, 23, dtype=torch.int32)[None, :]
        chunk, _ = tdecode.paged_prefill_chunk(params, toks, cfg, pool, table[0], 0, 20, 8)
        step, _ = tdecode.paged_decode_step(params, torch.tensor([5], dtype=torch.int32), cfg,
                                            pool, table, torch.tensor([20], dtype=torch.int32),
                                            torch.tensor([True]), 8)
        outs.append((params["layers"]["1"]["wq"], chunk, step))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _plain_masked(q, keys, values, lo, hi):
    """One query [nh, hd] over keys lo <= j < hi of [nkv, n, hd], grouped."""
    nh, hd = q.shape
    rep = nh // keys.shape[0]
    k = keys[:, lo:hi].repeat_interleave(rep, dim=0).double()
    v = values[:, lo:hi].repeat_interleave(rep, dim=0).double()
    s = torch.einsum("hd,hjd->hj", q.double(), k) * hd ** -0.5
    return torch.einsum("hj,hjd->hd", torch.softmax(s, dim=-1), v)


@pytest.mark.parametrize("window", [0, 5, 8, 9, 40])
def test_paged_plain_paths_with_and_without_a_window(window):
    """`_reference` and `_window_reference` against a plain masked attention
    per query over the lane's pages, keys max(0, L - window) <= j < L for a
    row of limit L (every key below L without a window), at limits whose
    bound falls on and off the 8-key page edge."""
    rng = np.random.RandomState(window)
    bs, n_pages, nkv, nh, hd = 8, 6, 2, 4, 16
    total = 1 + 3 * n_pages
    pk = torch.from_numpy(rng.randn(total, nkv, bs, hd).astype(np.float32))
    pv = torch.from_numpy(rng.randn(total, nkv, bs, hd).astype(np.float32))
    table = torch.from_numpy(rng.permutation(np.arange(1, total)).reshape(3, n_pages)
                             .astype(np.int32))
    lane_k = [pk[table[b].long()].permute(1, 0, 2, 3).reshape(nkv, -1, hd) for b in range(3)]
    lane_v = [pv[table[b].long()].permute(1, 0, 2, 3).reshape(nkv, -1, hd) for b in range(3)]
    limits = [17, min(16 + window, n_pages * bs), n_pages * bs]
    q = torch.from_numpy(rng.randn(3, nh, hd).astype(np.float32))
    got = tpa._reference(q, pk, pv, table, torch.tensor(limits, dtype=torch.int32),
                         window=window)
    for b, lim in enumerate(limits):
        lo = max(0, lim - window) if window else 0
        want = _plain_masked(q[b], lane_k[b], lane_v[b], lo, lim)
        assert torch.allclose(got[b].double(), want, atol=1e-5)
    w = 12
    qw = torch.from_numpy(rng.randn(3, nh, w, hd).astype(np.float32))
    pos = torch.tensor([0, 9, 30], dtype=torch.int32)
    lengths = torch.tensor([w, 5, w], dtype=torch.int32)
    got = tpa._window_reference(qw, pk, pv, table, pos, lengths, torch.ones(3, dtype=torch.bool),
                                window=window)
    for b in range(3):
        for r in range(int(lengths[b])):
            lim = int(pos[b]) + r + 1
            lo = max(0, lim - window) if window else 0
            want = _plain_masked(qw[b, :, r], lane_k[b], lane_v[b], lo, lim)
            assert torch.allclose(got[b, :, r].double(), want, atol=1e-5)


def test_expert_layer_plain_route_against_a_token_loop():
    """The plain route against each token's top-k experts summed one by
    one: masked rows give 0 and take no expert, and the tally counts the
    valid rows x top_k and the experts hit."""
    g = torch.Generator().manual_seed(4)
    t, h, f, e, k = 13, 16, 8, 6, 3
    x = torch.randn(t, h, generator=g)
    router = torch.randn(h, e, generator=g)
    wg, wu = torch.randn(e, h, f, generator=g), torch.randn(e, h, f, generator=g)
    wd = torch.randn(e, f, h, generator=g)
    valid = torch.arange(t) % 4 != 1
    tally = torch.zeros(2, dtype=torch.int64)
    got = moe.moe_experts(x, router, wg, wu, wd, k, True, valid=valid, tally=tally)
    hit = set()
    for i in range(t):
        if not valid[i]:
            assert bool((got[i] == 0).all())
            continue
        probs = torch.softmax(x[i] @ router, dim=-1)
        top = sorted(range(e), key=lambda j: (-float(probs[j]), j))[:k]
        hit.update(top)
        norm = sum(float(probs[j]) for j in top)
        want = sum(float(probs[j]) / norm
                   * ((torch.nn.functional.silu(x[i] @ wg[j]) * (x[i] @ wu[j])) @ wd[j])
                   for j in top)
        assert torch.allclose(got[i], want, rtol=1e-5, atol=1e-5)
    assert tally.tolist() == [int(valid.sum()) * k, len(hit)]


@pytest.mark.parametrize("chunk", [8, 16])
def test_prefill_then_decode_past_the_window_matches_reference(model, chunk):
    """Prefill in chunks through the paged pool (rows at positions 0 .. 22,
    so a chunk crosses the window's edge at 16), then decode steps at
    positions 23 .. 39 through the cache: every row's logits against the
    reference's full forward over the same tokens."""
    cfg, params, gcfg = model
    bs, prompt, steps = 8, 23, 17
    rng = np.random.default_rng(chunk)
    seq = rng.integers(0, cfg["vocab_size"], prompt + steps).tolist()
    want = REF.logits_at(params, cfg, seq, 0)
    pool = tdecode.init_paged_cache(gcfg, 1 + 8, bs, device="cpu")
    table = torch.arange(1, 9, dtype=torch.int32)
    rows = []
    for start in range(0, prompt, chunk):
        piece = seq[start:min(prompt, start + chunk)]
        toks = torch.tensor(piece + [0] * (chunk - len(piece)), dtype=torch.int32)[None, :]
        logits, _ = tdecode.paged_prefill_chunk(params, toks, gcfg, pool, table, start,
                                                len(piece), bs)
        rows.append(logits[:len(piece)])
    for p in range(prompt, prompt + steps):
        logits, _ = tdecode.paged_decode_step(
            params, torch.tensor([seq[p]], dtype=torch.int32), gcfg, pool, table[None, :],
            torch.tensor([p], dtype=torch.int32), torch.tensor([True]), bs)
        rows.append(logits)
    got = torch.cat(rows)
    assert got.shape == want.shape
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-4 * scale


def test_engine_serves_the_reference_tokens(model):
    """DecodeServer on the CPU (chunked prefill under a budget, K-step
    windows in bursts, the radix cache) serves tokens the reference puts
    first (gap <= 1e-4), and its expert tallies count every prompt token
    and decode step x top_k x layers."""
    from nos_tpu_torch.runtime.decode_server import DecodeServer

    cfg, params, gcfg = model
    eng = DecodeServer(params, gcfg, n_slots=3, max_len=64, prompt_buckets=(8, 16),
                       block_size=8, steps_per_dispatch=4, prefill_budget_tokens=16,
                       device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg["vocab_size"], n).tolist() for n in (5, 13, 30)]
    eng.start()
    try:
        outs = [f.result(timeout=120) for f in [eng.submit(p, 25) for p in prompts]]
        counts = eng.expert_counts()
    finally:
        eng.stop()
    per_row = gcfg.top_k * gcfg.layers
    assert counts["prefill_rows"] == per_row * sum(map(len, prompts))
    assert counts["decode_rows"] == per_row * sum(len(o) - 1 for o in outs)
    assert 0 < counts["decode_expert_hits"] <= gcfg.n_experts * gcfg.layers * 24 * 3
    for p, o in zip(prompts, outs):
        lg = REF.logits_at(params, cfg, p + list(o[:-1]), len(p) - 1)
        gap = lg.max(-1).values - lg.gather(1, torch.tensor(o)[:, None])[:, 0]
        assert gap.max().item() <= 1e-4


def test_mixed_layouts_are_refused_where_unsupported(model):
    """No tensor parallelism and no int8 pool for a layout with experts or
    windows, and the training forward and the dense cache refuse it."""
    from nos_tpu_torch.parallel.mesh import build_mesh
    from nos_tpu_torch.runtime.decode_server import DecodeServer

    _, params, gcfg = model
    with pytest.raises(ValueError, match="int8"):
        DecodeServer(params, gcfg, n_slots=2, max_len=32, prompt_buckets=(8,), block_size=8,
                     device="cpu", kv_dtype="int8")
    mesh = build_mesh({"tp": 2}, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="tensor"):
        DecodeServer(params, gcfg, n_slots=2, max_len=32, prompt_buckets=(8,), block_size=8,
                     mesh=mesh)
    with pytest.raises(ValueError, match="training|dense|mesh|gpt_hidden"):
        tgpt.gpt_forward(params, torch.zeros((1, 4), dtype=torch.int32), gcfg)
    with pytest.raises(ValueError, match="sliding"):
        tdecode.prefill(params, torch.zeros((1, 4), dtype=torch.int32), gcfg, 16)


@pytest.mark.parametrize("change", ["dense_layer", "sliding_yarn", "sliding_theta"])
def test_engine_config_refuses_layouts_outside_the_port(change):
    """The port's layout has every layer sparse, one theta for every
    layer and YaRN on the full layers only; `engine_config` refuses a
    config outside it rather than serve it as something else."""
    cfg = tiny_config()
    ropes = cfg["rope_parameters"]
    if change == "dense_layer":
        cfg["mlp_layer_types"] = ["dense"] + cfg["mlp_layer_types"][1:]
    elif change == "sliding_yarn":
        ropes["sliding_attention"] = dict(ropes["full_attention"])
    else:
        ropes["sliding_attention"] = dict(ropes["sliding_attention"], rope_theta=1e4)
    with pytest.raises(ValueError):
        ARCH.engine_config(cfg)


def test_prefill_wave_runs_only_its_lanes(model):
    """Mid chunks of several slots in one tick share a multi-slot wave,
    and the wave computes its own lanes only: its batch is the chunks it
    carries (not the engine's lane count), with their table rows, and
    the tokens served stay the reference's (gap <= 1e-4)."""
    from nos_tpu_torch.runtime.decode_server import DecodeServer

    cfg, params, gcfg = model
    eng = DecodeServer(params, gcfg, n_slots=5, max_len=64, prompt_buckets=(8, 16),
                       block_size=8, steps_per_dispatch=4, prefill_budget_tokens=64,
                       device="cpu")
    seen = []
    wave = eng._prefill_window

    def recording(tokens, table, pos, lengths, active):
        seen.append((tokens.shape[0], table.shape[0], int(active.sum())))
        wave(tokens, table, pos, lengths, active)

    eng._prefill_window = recording
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg["vocab_size"], n).tolist() for n in (40, 45, 50)]
    futs = [eng.submit(p, 6) for p in prompts]
    eng.start()
    try:
        outs = [f.result(timeout=120) for f in futs]
    finally:
        eng.stop()
    assert seen and eng.prefill_window_dispatches == len(seen)
    assert all(2 <= b == rows == act <= len(prompts) for b, rows, act in seen)
    for p, o in zip(prompts, outs):
        lg = REF.logits_at(params, cfg, p + list(o[:-1]), len(p) - 1)
        gap = lg.max(-1).values - lg.gather(1, torch.tensor(o)[:, None])[:, 0]
        assert gap.max().item() <= 1e-4
