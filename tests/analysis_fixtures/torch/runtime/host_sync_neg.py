"""NOS010 negatives for the PyTorch rules: the tick path stays on the
device (in-place updates, a non-blocking copy into pinned memory behind a
recorded event, `event.query()`); blocking reads live in client-side or
teardown methods the tick never reaches."""

import torch


class Engine:
    def __init__(self, device):
        self.device = device
        self.pos = torch.zeros(8, dtype=torch.int32, device=device)
        self.host = torch.empty(8, dtype=torch.int32, pin_memory=True)
        self.event = torch.cuda.Event()

    def _tick(self):
        self.pos.add_(1)
        self.host.copy_(self.pos, non_blocking=True)
        self.event.record()
        return self.event.query()

    def _run(self):
        while True:
            self._tick()

    def submit(self, x):
        return x.item()

    def result(self):
        self.event.synchronize()
        return self.host.tolist()

    def close(self):
        torch.cuda.synchronize()
