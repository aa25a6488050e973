"""The Mellum 2 architecture's files on the CPU: `arch/mellum.py`'s counts
against hand sums at a tiny config and against `arch/llama.py`'s where the
window covers the whole sequence, `metrics/expert_gemm_roofline.py` on a
fabricated run, and `drivers/serve-experts.py` serving a tiny Mellum cell
through `DecodeServer(device="cpu")`, its counters serve's and the expert
tallies."""

import json
import time
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench import run as run_mod
from portbench.drivers import serve
from portbench.work import bound_s

ROOT = harness.ROOT
SPEC = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
MELLUM = harness.load_module("arch", "mellum")
LLAMA = harness.load_module("arch", "llama")


def tiny_config(window=16, dtype="float32"):
    cfg = json.loads((ROOT / "configs/mellum2-12b-a2.5b.json").read_text())
    ropes = cfg["rope_parameters"]
    cfg.update(name="tiny-mellum", vocab_size=512, hidden_size=64, num_attention_heads=4,
               num_key_value_heads=2, head_dim=32, num_hidden_layers=4,
               layer_types=["sliding_attention"] * 3 + ["full_attention"],
               mlp_layer_types=["sparse"] * 4, sliding_window=window, num_experts=8,
               num_experts_per_tok=4, moe_intermediate_size=32, max_position_embeddings=256,
               torch_dtype=dtype,
               rope_parameters={
                   "full_attention": dict(ropes["full_attention"], factor=4,
                                          original_max_position_embeddings=32),
                   "sliding_attention": ropes["sliding_attention"]})
    return cfg


def test_counts_against_hand_sums():
    """A tiny shape (3 sliding layers of window 4, 1 full; 2 heads over 1 KV
    head of 8; hidden 16; 4 experts top 2 of width 8) counted by hand."""
    cfg = tiny_config()
    cfg.update(hidden_size=16, num_attention_heads=2, num_key_value_heads=1, head_dim=8,
               sliding_window=4, num_experts=4, num_experts_per_tok=2,
               moe_intermediate_size=8, vocab_size=10, torch_dtype="bfloat16")
    s = MELLUM.shape(cfg)
    # q 16, kv 8: 2 (16 16 + 2 16 8 + 16 16 + 16 4) + 2 x 6 16 8, four layers.
    assert s.linear_flops() == 4 * (2 * (256 + 256 + 256 + 64) + 2 * 6 * 128)
    assert s.logits_flops() == 2 * 16 * 10
    # Queries at 2..6: full keys 3+4+5+6+7 = 25; sliding min(p+1, 4): 3+4+4+4+4 = 19.
    assert s.attention_flops(2, 7) == 4 * 2 * 8 * (25 + 3 * 19)
    assert s.decode_flops(7) == 4 * 2 * 8 * (7 + 3 * 4)
    # Window bytes for queries 2..6: full reads keys 0..6, sliding keys from 2 + 1 - 4 < 0,
    # so 0..6 too; then at 5..9, sliding from 2.
    row, io = 2 * 1 * 8, 2 * 2 * 8
    assert s.window_bytes(2, 7) == 2 * (4 * (7 * row + 5 * io))
    assert s.window_bytes(5, 10) == 2 * (10 * row + 5 * io + 3 * (8 * row + 5 * io))
    # Decode at limit 11, block 4: full pages 0..2 (3); sliding from page (11 - 4) // 4 = 1.
    def layer(pages):
        return pages * 1 * 4 * 8 * 2 * 2 + 2 * 2 * 8 * 2 + 4 * (pages + 1)
    assert s.decode_bytes(11, 4) == layer(3) + 3 * layer(2)
    assert s.expert_flops(10) == 6 * 16 * 8 * 10
    assert s.expert_bytes(3, 10) == 3 * 3 * 16 * 8 * 2 + 10 / 2 * 2 * 16 * 2


@pytest.mark.parametrize("lo,hi", [(0, 1), (0, 100), (37, 64), (63, 64)])
def test_a_window_as_long_as_the_sequence_counts_as_llama(lo, hi):
    """Where no key falls out of the window, every attention count equals
    arch/llama.py's at the same heads."""
    s = MELLUM.shape(tiny_config(window=128))
    ll = LLAMA.Shape(vocab=s.vocab, hidden=s.hidden, layers=s.layers, heads=s.heads,
                     kv_heads=s.kv_heads, head_dim=s.head_dim, ffn=1, itemsize=s.itemsize)
    assert s.attention_flops(lo, hi) == ll.attention_flops(lo, hi)
    assert s.window_bytes(lo, hi) == ll.window_bytes(lo, hi)
    assert s.decode_flops(hi) == ll.decode_flops(hi)
    assert s.decode_bytes(hi, 8) == ll.decode_bytes(hi, 8)


def test_expert_gemm_roofline_reads_a_fabricated_run():
    """Two kinds' bounds, summed, over the expert kernels' seconds; nothing
    without a trace, without the tallies or without expert kernels."""
    metric = harness.load_module("metrics", "expert_gemm_roofline")
    s = MELLUM.shape(json.loads((ROOT / "configs/mellum2-12b-a2.5b.json").read_text()))
    trace = SimpleNamespace(kernel_seconds=lambda *names: 0.5 if "moe_gemm_kernel" in names
                            else 0.0)
    zero = {"prefill_rows": 10, "prefill_expert_hits": 5, "decode_rows": 0,
            "decode_expert_hits": 0}
    after = {"prefill_rows": 10 + 2048 * 8 * 28, "prefill_expert_hits": 5 + 64 * 28,
             "decode_rows": 384 * 28 * 100, "decode_expert_hits": 64 * 28 * 100}
    run = SimpleNamespace(trace_data=trace, counters=(zero, after), shape=s)
    need = (bound_s(s.expert_flops(2048 * 8 * 28), s.expert_bytes(64 * 28, 2048 * 8 * 28))
            + bound_s(s.expert_flops(384 * 28 * 100), s.expert_bytes(64 * 28 * 100,
                                                                      384 * 28 * 100)))
    assert metric.read(run) == pytest.approx(100 * need / 0.5)
    assert metric.UNIT == "%" and "moe_gemm_kernel" in metric.KERNELS
    assert metric.read(SimpleNamespace(trace_data=None, counters=(zero, after), shape=s)) is None
    assert metric.read(SimpleNamespace(trace_data=trace, counters=({}, {"ticks": 1}),
                                       shape=s)) is None
    idle = SimpleNamespace(kernel_seconds=lambda *names: 0.0)
    assert metric.read(SimpleNamespace(trace_data=idle, counters=(zero, after), shape=s)) is None


def test_the_expert_driver_serves_a_tiny_cell(tmp_path):
    """`drivers/serve-experts.py` through the harness on the CPU: the run is
    correct, its counters hold serve's keys and the expert tallies, and the
    rows routed in the window are the window's prompt tokens and decode
    steps x top_k x layers."""
    for kind in ("configs", "cells", "traffic"):
        (tmp_path / kind).mkdir()
    cfg = tiny_config()
    (tmp_path / "configs/tiny-mellum.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic/tiny-code.json").write_text(json.dumps({
        "kind": "closed", "clients": 3, "requests_per_client": 2,
        "prompt": {"lo": 20, "hi": 70}, "output": {"lo": 4, "hi": 12}, "stagger": True}))
    (tmp_path / "cells/tiny-mellum.code.json").write_text(json.dumps({
        "name": "tiny-mellum.code", "config": "tiny-mellum", "traffic": "tiny-code",
        "driver": "serve-experts", "chips": 1,
        "engine": {"n_slots": 3, "max_len": 96, "prompt_buckets": [16, 32],
                   "steps_per_dispatch": 4, "burst_windows": 2, "block_size": 8,
                   "prefill_budget_tokens": 32, "spill_blocks": 0},
        "max_drain_s": 120, "check": {"max_logit_gap": 1e-3, "requests": 4}}))
    run = harness.Run("tiny-mellum.code", 2 ** 31 + 9, 1.5, False, time.monotonic(),
                      device="cpu", roots=[str(tmp_path)])
    harness.load_module("drivers", "serve-experts").run(run)
    res = run_mod.finish(run, harness.benchmark_metrics("tiny-mellum.code", False, SPEC))
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    before, after = run.counters
    fake = SimpleNamespace(**{k: 0 for k in ("tick_host_overhead_s", "ticks_profiled",
                                             "tick_wall_s", "prefix_hit_tokens",
                                             "prefix_cow_tokens", "prefill_tokens",
                                             "graph_replays")}, queue_wait_s=[])
    assert set(serve.counters(fake)) < set(after)
    assert {"prefill_rows", "decode_rows", "prefill_expert_hits",
            "decode_expert_hits"} <= set(after)
    rows = 4 * 4  # top_k x layers
    prompt = sum(len(r.prompt) for r in run.served.records)
    steps = sum(r.n_out - 1 for r in run.served.records if r.n_out)
    hit = after["prefix_hit_tokens"] - before["prefix_hit_tokens"]
    assert after["prefill_rows"] - before["prefill_rows"] == rows * (prompt - hit)
    assert after["decode_rows"] - before["decode_rows"] == rows * steps


@pytest.mark.cuda
def test_the_mellum_cell_on_the_card_is_correct_and_its_control_is_not(cuda):
    """The cell's program and its fp8 control on one seed (a shortened
    window): the program meets the limit, the control does not."""
    from portbench import control

    row = next(control.readings("mellum2-12b-a2.5b.repo-code", [2 ** 31 + 27], 4.0))
    assert row["unfinished"] == 0
    assert row["max_logit_gap"] <= row["limit"] < row["control_max_logit_gap"]
