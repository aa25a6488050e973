"""NOS016 negatives for the PyTorch rules: the engine's own `self.device`,
a shard's device read off its tensors, `torch.cuda.device(device)` around
a capture, the current device ("cuda"), and `torch.cuda.device_count()` as
inspection."""

import torch


class Engine:
    def __init__(self, device, pools):
        self.device = device
        self.pools = pools

    def _tick(self):
        x = self.buf.to(self.device)
        for pool in self.pools:
            dev = pool["k"].device
            pool["k"].copy_(x.to(dev))
        with torch.cuda.device(self.device):
            y = torch.zeros(4, device=self.device)
        n = torch.cuda.device_count()
        return y, n, torch.device("cuda"), len(self.pools) < n

    def _run(self):
        while True:
            self._tick()
