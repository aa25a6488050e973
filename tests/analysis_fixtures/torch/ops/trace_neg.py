"""NOS007/NOS008 negatives for the PyTorch rules: pure captured and
compiled bodies; impure calls outside them (after a capture block, in an
eager helper); the builtin `compile` and `re.compile`, which replay
nothing; tolerance comparisons."""

import math
import re
import time

import torch
import triton
import triton.language as tl


@torch.compile
def compiled_pure(x):
    return torch.tanh(x) * 2.0


@triton.jit
def kernel(x_ptr, n):
    offs = tl.arange(0, 128)
    tl.store(x_ptr + offs, tl.load(x_ptr + offs), mask=offs < n)


def capture(g, body):
    with torch.cuda.graph(g):
        out = body()
    stamp = time.monotonic()  # after the block: runs every call
    return out, stamp


def eager_step(x):
    return x * time.time()


SOURCE = "1 + 1"
code = compile(SOURCE, "<expr>", "eval")
pattern = re.compile("a+")


def close_enough(x):
    return math.isclose(x, 0.1) and x != 3
