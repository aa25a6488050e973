"""NOS015 negatives for the PyTorch rules: the tick path uploads only
through the counted `HostStage.to_device`; host tensors it builds stay on
the host; `.to()` casts a dtype, moves a device tensor, or reads back to
"cpu" (NOS010's direction)."""

import torch


class Engine:
    def __init__(self, device, stage):
        self.device = device
        self._stage = stage

    def _tick(self):
        host = torch.tensor(self.queue, dtype=torch.int32)
        on_cpu = torch.as_tensor(self.lens, device="cpu")
        ids = self._stage.to_device(host)
        wide = ids.to(torch.int64)
        cast = self.pos.to(dtype=torch.float32)
        moved = self.logits.to(self.device)
        back = self.logits.to("cpu")
        return on_cpu, wide, cast, moved, back, host.to(self.pos.dtype)

    def _run(self):
        while True:
            self._tick()
