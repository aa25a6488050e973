"""NOS007/NOS008 positives for the PyTorch rules (under an `ops/` segment:
in scope): impure calls in functions whose Python body runs once and is
then replayed — `torch.compile` (decorated, through a partial, or called on
a function), `torch.cuda.make_graphed_callables`, `@triton.jit`, the
engine's capture wrapper, and the body of a `torch.cuda.graph` block."""

import random
import time
from functools import partial

import numpy as np
import torch
import triton

COUNTER = 0


class _WindowGraph:
    def __init__(self, body, device):
        self.body = body


@torch.compile
def compiled_impure(x):
    t = time.time()  # NOS007
    print("tracing", x.shape)  # NOS007
    return x * t


@partial(torch.compile, mode="reduce-overhead")
def partial_compiled(n, x):
    noise = np.random.uniform(size=n)  # NOS007
    return x + noise


def _compiled_later(x):
    return x + random.random()  # NOS007


step = torch.compile(_compiled_later)


def _graphed_later(x):
    global COUNTER  # NOS007
    COUNTER += 1
    return x


graphed = torch.cuda.make_graphed_callables(_graphed_later, (torch.zeros(1),))


@triton.jit
def kernel(x_ptr):
    print("launch")  # NOS007


class Engine:
    def __init__(self):
        self._graph = _WindowGraph(self._macro, "cuda")

    def _macro(self):
        return time.perf_counter()  # NOS007


def capture(g, body):
    with torch.cuda.graph(g):
        out = body()
        stamp = time.monotonic()  # NOS007
    return out, stamp


def threshold(x):
    return x == 0.1  # NOS008
