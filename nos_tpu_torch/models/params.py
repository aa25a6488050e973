"""Carry a parameter tree across from numpy arrays into the port's tensors.

A JAX param tree (`nos_tpu.models.gpt.init_gpt`) converted leaf by leaf to
numpy arrays becomes the same nested dict of torch tensors, so the reference
and the port compute the same function on the same weights. No import of
JAX: bfloat16 leaves (numpy's `bfloat16` extension dtype) are read through
their raw 16-bit pattern.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from nos_tpu_torch.device import resolve
from nos_tpu_torch.models.gpt import GPTConfig


def _to_tensor(arr, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.array(arr, copy=True, order="C")  # writable, owned by the tensor
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype)


def from_numpy_params(tree: Dict, cfg: GPTConfig, device=None) -> Dict:
    """Nested dict of numpy arrays -> the same nested dict of tensors in
    `cfg.dtype` on `device` (None: CUDA)."""
    device = resolve(device, "from_numpy_params")
    dtype = cfg.torch_dtype

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return _to_tensor(node, dtype, device)

    return convert(tree)
