"""NOS016 positives for the PyTorch rules: explicit physical devices on an
engine class's tick path — a literal "cuda:N" in `_tick`; set_device,
`torch.device("cuda", N)`, iterating `range(torch.cuda.device_count())`
and an f-string "cuda:{i}" factory device in the reachable `_place`; the
helper class's `.cuda(1)` and `torch.cuda.device(1)`. `submit` is
client-side and stays legal."""

import torch


class _Helper:
    def pin(self, t):
        with torch.cuda.device(1):  # NOS016
            return t.cuda(1)  # NOS016


class Engine:
    def __init__(self, device):
        self.device = device

    def _tick(self):
        x = self.buf.to("cuda:1")  # NOS016
        self._place()
        return x

    def _place(self):
        torch.cuda.set_device(0)  # NOS016
        dev = torch.device("cuda", 1)  # NOS016
        for i in range(torch.cuda.device_count()):  # NOS016
            self.rank = i
        return dev, torch.zeros(4, device=f"cuda:{self.rank}")  # NOS016

    def _run(self):
        while True:
            self._tick()

    def submit(self):
        return torch.device("cuda", 0)
