"""NOS021 negatives for the PyTorch rules: the replay closure draws only
from an explicit torch.Generator seeded from the recorded reports."""

import torch


class Monitor:
    def __init__(self, probs):
        self.probs = probs

    def replay(self, reports):
        gen = torch.Generator().manual_seed(len(reports))
        noise = torch.randn(len(reports), generator=gen)
        return self.classify_window(reports, gen), noise

    def classify_window(self, reports, gen):
        return torch.multinomial(self.probs, 1, generator=gen)
