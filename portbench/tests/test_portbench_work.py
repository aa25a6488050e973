"""The benchmark's work arithmetic (`portbench/work.py` over the dense
count of `portbench/arch/llama.py`) against direct counts."""

import math

import pytest

from portbench import harness
from portbench.arch.llama import (Shape, attention_flops, decode_bytes, linear_flops,
                                  logits_flops, window_bytes)
from portbench.work import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S, PrefixTrie, Work, bound_s

SMOL = Shape.from_gpt({"vocab": 49152, "hidden": 2048, "layers": 24, "heads": 32,
                       "kv_heads": 32, "mlp_ratio": 4, "dtype": "bfloat16"})
FALCON = Shape.from_gpt({"vocab": 131072, "hidden": 2048, "layers": 18, "heads": 8,
                         "kv_heads": 4, "mlp_ratio": 4, "dtype": "bfloat16"})


def test_shapes_from_the_configurations():
    assert SMOL.head_dim == 64 and SMOL.kv_bytes_per_token == 192 * 1024
    assert FALCON.head_dim == 256 and FALCON.kv_bytes_per_token == 72 * 1024


@pytest.mark.parametrize("shape,params", [(SMOL, 1.6106e9), (FALCON, 1.1325e9)])
def test_linear_flops_are_twice_the_layer_parameters(shape, params):
    # Layer parameters (projections and MLP) only; the embedding is a gather.
    assert linear_flops(shape) == pytest.approx(2 * params, rel=2e-3)
    assert logits_flops(shape) == 2 * shape.hidden * shape.vocab


@pytest.mark.parametrize("lo,hi", [(0, 1), (0, 37), (5, 64), (1000, 1040)])
def test_attention_flops_sum_each_query_over_its_keys(lo, hi):
    direct = sum(4 * SMOL.layers * SMOL.heads * SMOL.head_dim * (p + 1) for p in range(lo, hi))
    assert attention_flops(SMOL, lo, hi) == direct


def test_decode_bytes_is_chip_smokes_formula_per_layer():
    # chip_smoke.py decode_bytes(limits, nh, nkv, hd, bs, kv_itemsize, q_itemsize)
    limits, bs = [33], 32
    pages = sum(-(-x // bs) for x in limits)
    pool = pages * FALCON.kv_heads * bs * FALCON.head_dim * 2 * 2
    qo = 2 * len(limits) * FALCON.heads * FALCON.head_dim * 2
    per_layer = pool + qo + 4 * (pages + len(limits))
    assert decode_bytes(FALCON, 33, 32) == FALCON.layers * per_layer


def test_window_bytes_read_each_key_once():
    per_layer = 100 * 2 * 4 * 256 + 60 * 2 * 8 * 256
    assert window_bytes(FALCON, 40, 100) == 18 * per_layer * 2


def test_bound_takes_the_larger_limit():
    assert bound_s(PEAK_BF16_FLOPS, 0.0) == 1.0
    assert bound_s(0.0, 2 * PEAK_BYTES_PER_S) == 2.0


def test_work_of_one_request():
    w = Work()
    w.add(SMOL, prompt_len=10, cached=4, n_out=3, block=32)
    assert (w.prompt_tokens, w.cached_tokens, w.prefill_tokens, w.decode_tokens) == (10, 4, 6, 2)
    want = (6 * linear_flops(SMOL) + attention_flops(SMOL, 4, 10)
            + logits_flops(SMOL)
            + 2 * (linear_flops(SMOL) + logits_flops(SMOL)) + attention_flops(SMOL, 10, 12))
    assert w.model_flops == pytest.approx(want)
    dec = sum(bound_s(4.0 * 24 * 32 * 64 * (p + 1), decode_bytes(SMOL, p + 1, 32))
              for p in (10, 11))
    assert w.decode_attn_bound_s == pytest.approx(dec)
    assert w.window_attn_bound_s == pytest.approx(
        bound_s(attention_flops(SMOL, 4, 10), window_bytes(SMOL, 4, 10)))


def test_a_fully_held_prompt_still_computes_its_last_token():
    w = Work()
    w.add(SMOL, prompt_len=8, cached=8, n_out=1, block=32)
    assert w.prefill_tokens == 1 and w.decode_tokens == 0


#: (prompt, cached, served) triples and what `Work` gave for them, summed
#: in this order, before the count moved into `arch/llama.py` (block 32,
#: then 16).
TRIPLES = [(1, 0, 1), (10, 4, 3), (8, 8, 1), (300, 299, 0), (128, 0, 256), (1000, 0, 1024),
           (2048 + 150, 2048, 64), (3584, 0, 128), (4095, 1000, 33)]
TOKENS = {"prefill_tokens": 7966, "decode_tokens": 1502, "prompt_tokens": 11324,
          "cached_tokens": 3358}
BEFORE = {
    ("smollm2-1.7b", 32): {"model_flops": 34240344883200.0, "decode_attn_bound_s": 0.1392272748895533,
                           "window_attn_bound_s": 0.003134282229530205},
    ("smollm2-1.7b", 16): {"model_flops": 34240344883200.0, "decode_attn_bound_s": 0.13852229184000017,
                           "window_attn_bound_s": 0.003134282229530205},
    ("falcon3-1b", 32): {"model_flops": 24833311244288.0, "decode_attn_bound_s": 0.05224409692656721,
                         "window_attn_bound_s": 0.0022790887081888837},
    ("falcon3-1b", 16): {"model_flops": 24833311244288.0, "decode_attn_bound_s": 0.051980516339104596,
                         "window_attn_bound_s": 0.0022790887081888837},
}


@pytest.mark.parametrize("config,block", sorted(BEFORE), ids=[f"{c}-{b}" for c, b in sorted(BEFORE)])
def test_the_configurations_count_what_they_counted_before_the_move(config, block):
    body = harness.load_json("configs", config)
    shape = harness.load_module("arch", body["arch"]).shape(body)
    w = Work()
    for prompt, cached, served in TRIPLES:
        w.add(shape, prompt, cached, served, block)
    assert vars(w) == {**BEFORE[(config, block)], **TOKENS}


def test_trie_matches_whole_prefixes_only():
    t = PrefixTrie()
    t.insert([1, 2, 3, 4])
    assert t.match([1, 2, 3, 4, 5]) == 4
    assert t.match([1, 2, 9]) == 2
    assert t.match([2, 3]) == 0
    t.insert([1, 2, 9, 9])
    assert t.match([1, 2, 9, 9, 9]) == 4
    assert math.isclose(t.match([]), 0)
