"""NOS010 positives for the PyTorch rules: blocking host reads on an engine
class's tick path — `.item()` in `_tick`; `.cpu()`, `.tolist()` and
`torch.cuda.synchronize()` in the reachable `_drain`; the helper class's
event wait, `.numpy()`, `np.asarray` and `np.array` (helpers in an engine
file are tick-path by construction). `submit` is client-side (unreachable
from `_tick`/`_run`) and stays legal."""

import numpy as np
import torch


class _Ref:
    def __init__(self, arr, event):
        self._arr = arr
        self._event = event

    def materialize(self):
        self._event.synchronize()  # NOS010
        host = self._arr.numpy()  # NOS010
        return host, np.asarray(self._arr)  # NOS010

    def copy(self):
        return np.array(self._arr)  # NOS010


class Engine:
    def __init__(self):
        self.queue = []

    def _tick(self):
        val = self.queue[0].item()  # NOS010
        self._drain()
        return val

    def _drain(self):
        host = self.toks.cpu()  # NOS010
        ids = self.lens.tolist()  # NOS010
        torch.cuda.synchronize()  # NOS010
        return host, ids

    def _run(self):
        while True:
            self._tick()

    def submit(self, x):
        return x.item()
