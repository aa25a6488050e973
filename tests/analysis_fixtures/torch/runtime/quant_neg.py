"""NOS024 negatives for the PyTorch rules: reads of the scale state, the
pool built in one dict literal, in-place writes to other state, and
out-of-place methods on the scales."""

import torch


def build(total, shape):
    return {
        "k": torch.zeros(shape, dtype=torch.int8),
        "v": torch.zeros(shape, dtype=torch.int8),
        "k_scale": torch.zeros((total,)),
        "v_scale": torch.zeros((total,)),
    }


def read(lc, x):
    lc["k"].copy_(x)
    wide = lc["k_scale"].float() * 2
    kept = lc["v_scale"].clone()
    return "k_scale" in lc, wide, kept, {"k_scale": lc["k_scale"], "v_scale": kept}
