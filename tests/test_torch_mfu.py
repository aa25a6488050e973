"""The port's measurement layer (`nos_tpu_torch/runtime/mfu.py`) against
the JAX package's `runtime/mfu.py`: the cases of tests/test_mfu.py on the
port (the peak table's longest match, the analytic FLOP counts, the flash
pair's floor, the publication gate, None where no peak is known), and the
FLOP counter the port uses where no analytic count is given, against the
matrix products of a tiny ViT and against XLA's `cost_analysis` of the
reference's `vit_detect` on the same config."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import pytest
import torch

from nos_tpu.models import vit as jvit
from nos_tpu.runtime import mfu as ref
from nos_tpu_torch.models import vit as tvit
from nos_tpu_torch.runtime import mfu

# The model shape of the reference test's analytic case, duck-typed: the
# port's GPTConfig is its own class.
GPT_SHAPE = types.SimpleNamespace(hidden=512, layers=4, heads=8, vocab=32000, mlp_ratio=4,
                                  n_kv=8, head_dim=64)
# The peak the reference test feeds flash_pair_floor_ms (an input here,
# not a figure of the port's card).
REF_TEST_PEAK = 197e12
BENCH_SHAPE = (8, 8, 2048, 64)


def test_device_peak_longest_match_wins():
    assert mfu.kind_peak_flops("NVIDIA H100 PCIe") == 756e12
    assert mfu.kind_peak_flops("NVIDIA H100 NVL") == 835e12
    assert mfu.kind_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert mfu.kind_peak_flops("NVIDIA H100 80GB HBM3") == mfu.H100_BF16_PEAK_FLOPS
    assert mfu.kind_peak_flops("cpu") is None
    assert mfu.kind_peak_flops("NVIDIA A100-SXM4-80GB") is None
    assert mfu.device_peak_flops("cpu") is None
    assert mfu.device_peak_flops(torch.device("cpu")) is None


def test_gpt_train_flops_analytic():
    batch, seq = 8, 2048
    flops = mfu.gpt_train_flops(GPT_SHAPE, batch, seq)
    assert flops == ref.gpt_train_flops(GPT_SHAPE, batch, seq)
    from nos_tpu.models.gpt import GPTConfig as JaxGPTConfig
    from nos_tpu_torch.models.gpt import GPTConfig

    jcfg = JaxGPTConfig(hidden=512, layers=4, heads=8, vocab=32000, max_seq=2048)
    tcfg = GPTConfig(hidden=512, layers=4, heads=8, vocab=32000, max_seq=2048)
    assert mfu.gpt_train_flops(tcfg, batch, seq) == ref.gpt_train_flops(jcfg, batch, seq)
    per_layer = 2 * 512 * 512 + 2 * 512 * 512 + 3 * 512 * 2048
    expected_dense = 6.0 * (4 * per_layer + 512 * 32000) * batch * seq
    expected_attn = 3.0 * 4 * (4.0 * batch * (seq * seq / 2.0) * 512)
    assert flops == expected_dense + expected_attn
    assert 3.0e12 < flops < 4.5e12


def test_flash_pair_floor_equal_and_rejects_degenerate_walls():
    """The reference test's r4 and r5 cases at its input peak: walls of
    0.000 and 0.001 ms, and the 0.6634 ms outlier, lie under the floor of
    the recompute-inclusive 8 * b * h * s^2 * d count."""
    for peak in (REF_TEST_PEAK, mfu.H100_BF16_PEAK_FLOPS):
        assert (mfu.flash_pair_floor_ms(*BENCH_SHAPE, peak)
                == ref.flash_pair_floor_ms(*BENCH_SHAPE, peak))
    floor = mfu.flash_pair_floor_ms(*BENCH_SHAPE, REF_TEST_PEAK)
    assert 0.4 < floor < 0.7
    assert 0.000 < floor and 0.001 < floor
    assert 3.0 > floor
    assert 0.69 < floor < 0.71
    assert 0.6634 < floor
    # On the port's card: 137.4 GFLOP at 989 TFLOP/s.
    assert 0.13 < mfu.flash_pair_floor_ms(*BENCH_SHAPE, mfu.H100_BF16_PEAK_FLOPS) < 0.14


def test_measure_mfu_none_without_known_peak(monkeypatch):
    assert mfu.measure_mfu(lambda x: x * 2.0, (torch.ones(4),), device="cpu") is None
    assert mfu.vit_batch_mfu(device="cpu") is None
    assert mfu.gpt_train_mfu(device="cpu") is None
    # No device means CUDA, and no CUDA raises: never a CPU timing.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="measure_mfu runs on CUDA"):
        mfu.measure_mfu(lambda x: x * 2.0, (torch.ones(4),))


def test_accept_flash_walls_equal_to_the_reference():
    """Min-of-attempts publication needs a second wall within 1.5x of the
    minimum on both sides; one lucky outlier emits the invalid marker. The
    reference test's two wall sets and its empty side, through both
    packages: identical dicts."""
    floor = 0.698
    cases = [
        ([0.6634, 3.5552], [6.3925, 6.3626, 7.9256]),
        ([2.039, 2.081, 2.455], [4.807, 5.120, 6.450]),
        ([], [4.8, 5.0]),
    ]
    outs = []
    for flash, plain in cases:
        rejected = {"flash": 3 if not flash else 0, "reference": 0}
        got = mfu.accept_flash_walls(list(flash), list(plain), floor, dict(rejected),
                                     list(BENCH_SHAPE))
        want = ref.accept_flash_walls(list(flash), list(plain), floor, dict(rejected),
                                      list(BENCH_SHAPE))
        assert got == want
        outs.append(got)
    r5_like, good, empty = outs
    assert "invalid" in r5_like and "speedup" not in r5_like
    assert "invalid" not in good
    assert good["flash_ms"] == 2.039
    assert abs(good["speedup"] - 4.807 / 2.039) < 1e-9
    assert "invalid" in empty


def test_flash_train_shape_speedup_none_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mfu.flash_train_shape_speedup() is None
    assert mfu.flash_train_shape_speedup(device="cpu") is None


# A tiny ViT, bf16 as the detector runs: attention stays plain matmuls.
VIT_SHAPE = dict(image_size=64, patch_size=16, hidden=128, layers=2, heads=2, det_tokens=10,
                 num_classes=92, dtype="bfloat16")
# FlopCounterMode counts matrix products only; XLA's cost_analysis adds the
# elementwise work (norms, softmax, GELU, casts). Measured on this config
# (jax 0.9.0, torch 2.13): 73,592,832 / 78,121,768 = 0.9420. Pinned: the
# counter's count within [0.90, 1.0] of XLA's.
VIT_COUNT_RATIO = (0.90, 1.0)


def vit_matmul_flops(c, batch):
    """2 * M * N * K over every product of vit_detect."""
    t, h = c.seq_len, c.hidden
    f = 2 * batch * c.n_patches * (c.patch_size ** 2 * 3) * h
    f += c.layers * (2 * batch * t * (4 * h * h + 2 * h * h * c.mlp_ratio) + 4 * batch * t * t * h)
    return f + 2 * batch * c.det_tokens * h * (c.num_classes + 4)


def test_flop_counter_against_xla_cost_analysis():
    jcfg = jvit.ViTConfig(**VIT_SHAPE)
    tcfg = tvit.ViTConfig(**dataclasses.asdict(jcfg))
    batch = 3
    assert tcfg.seq_len < tvit._FLASH_MIN_SEQ
    params = jvit.init_vit(jax.random.PRNGKey(0), jcfg)
    images = jnp.zeros((batch, jcfg.image_size, jcfg.image_size, 3), jnp.float32)
    cost = jax.jit(lambda p, x: jvit.vit_detect(p, x, jcfg)).lower(params, images).compile()
    cost = cost.cost_analysis()
    xla = (cost if isinstance(cost, dict) else cost[0])["flops"]
    tparams = tvit.init_vit(tcfg, torch.Generator().manual_seed(0), device="cpu")
    counted = mfu.count_flops(lambda x: tvit.vit_detect(tparams, x, tcfg),
                              (torch.zeros(batch, tcfg.image_size, tcfg.image_size, 3),))
    assert counted == vit_matmul_flops(tcfg, batch)
    lo, hi = VIT_COUNT_RATIO
    assert lo <= counted / xla <= hi, counted / xla
