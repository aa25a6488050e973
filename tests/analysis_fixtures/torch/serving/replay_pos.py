"""NOS021 positives for the PyTorch rules (under a `serving/` segment):
draws on torch's global generator, and its reseed, in the closure of the
replay/classification roots. `sample_live` is outside the closure and
stays legal."""

import torch


class Monitor:
    def __init__(self, probs):
        self.probs = probs

    def replay(self, reports):
        noise = torch.randn(len(reports))  # NOS021
        torch.manual_seed(0)  # NOS021
        return self.classify_window(reports), noise

    def classify_window(self, reports):
        return torch.multinomial(self.probs, 1)  # NOS021

    def sample_live(self):
        return torch.rand(3)
