"""NOS009 negatives for the PyTorch rules: an explicit, seeded
torch.Generator handed to every draw, and seeded stdlib/numpy RNGs."""

import random

import numpy as np
import torch


def make_trace(seed, n, probs):
    gen = torch.Generator().manual_seed(seed)
    a = torch.rand(n, generator=gen)
    b = torch.randperm(n, generator=gen)
    c = torch.multinomial(probs, 1, generator=gen)
    rng = random.Random(seed)
    nprng = np.random.default_rng(seed)
    return a, b, c, rng.random(), nprng.uniform(), torch.zeros(n)
