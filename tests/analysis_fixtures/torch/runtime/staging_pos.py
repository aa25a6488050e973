"""NOS015 positives for the PyTorch rules: uncounted host->device uploads
on an engine class's tick path — `torch.tensor(..., device=)` in `_tick`;
`torch.from_numpy(...).to(<device>)`, a `torch.as_tensor` host local moved
by `.cuda()` and a `.cpu()` copy moved back in the reachable `_upload`;
the helper class's `torch.as_tensor(..., device="cuda")`. `submit` is
client-side and stays legal."""

import torch


class _Helper:
    def stage(self, values):
        return torch.as_tensor(values, device="cuda")  # NOS015


class Engine:
    def __init__(self, device):
        self.device = device

    def _tick(self):
        ids = torch.tensor(self.queue, device=self.device)  # NOS015
        self._upload()
        return ids

    def _upload(self):
        a = torch.from_numpy(self.buf).to(self.device, non_blocking=True)  # NOS015
        lens = torch.as_tensor(self.lens)
        b = lens.cuda()  # NOS015
        back = self.dev.cpu()
        c = back.to(device=self.device)  # NOS015
        return a, b, c

    def _run(self):
        while True:
            self._tick()

    def submit(self, x):
        return torch.tensor(x, device=self.device)
