"""Model FLOPs of a train step and the H100's peak, for MFU.

A subset of `nos_tpu/runtime/mfu.py`: `gpt_train_flops` (:438) and
`flash_pair_floor_ms` (:268), copied, plus the H100's dense bf16 peak. MFU
is `gpt_train_flops / (step seconds * H100_BF16_PEAK_FLOPS)`. The JAX
timer (`measure_mfu`, scan differencing) waits for the measurement layer
(ROADMAP A10); `chip_smoke.py` times the port's step with CUDA events.
"""

from __future__ import annotations

H100_BF16_PEAK_FLOPS = 989e12  # dense tensor-core bf16, H100 SXM data sheet


def gpt_train_flops(model, batch: int, seq: int) -> float:
    """Analytic model FLOPs of one train step (fwd + bwd): 6 x matmul
    params x tokens, plus the causal attention term counted at seq^2/2 (the
    useful work of a causal model). Recompute under remat is excluded, so
    remat shows up as lower MFU."""
    h = model.hidden
    kv_dim = model.n_kv * model.head_dim
    per_layer = 2 * h * h + 2 * h * kv_dim + 3 * h * (h * model.mlp_ratio)
    matmul_params = model.layers * per_layer + h * model.vocab  # + lm_head
    tokens = batch * seq
    dense = 6.0 * matmul_params * tokens
    attention = 3.0 * model.layers * (4.0 * batch * (seq * seq / 2.0) * h)
    return dense + attention


def flash_pair_floor_ms(
    batch: int, heads: int, seq: int, head_dim: int, peak_flops: float
) -> float:
    """Least time of a causal flash attention forward + backward pair, in
    ms: at least 8 * b * h * s^2 * d matmul FLOPs (QK^T and PV forward, the
    backward's dQ/dK/dV/dP products and its recompute of QK^T from the
    saved lse) at `peak_flops`."""
    return 8.0 * batch * heads * seq * seq * head_dim / peak_flops * 1e3
