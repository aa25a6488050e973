"""Where the port's entry points run.

Every entry point (`init_gpt`, `from_numpy_params`, `init_paged_cache`,
`DecodeServer`) takes a `device`: None means CUDA, and raises when no CUDA
device exists, so the port never drifts to the CPU on its own. The CPU runs
only when a caller names it (`device="cpu"`), and there the kernels' plain
versions run.
"""

from __future__ import annotations

import torch


def resolve(device, what: str) -> torch.device:
    """`device` as a torch.device; None means CUDA. `what` names the entry
    point in the error raised when no CUDA device is available."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what} runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain versions"
            )
        return torch.device("cuda")
    return torch.device(device)
