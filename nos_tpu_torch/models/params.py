"""Carry a parameter tree across from numpy arrays into the port's tensors.

A JAX param tree (`nos_tpu.models.gpt.init_gpt`, `nos_tpu.models.vit.
init_vit`) converted leaf by leaf to numpy arrays becomes the same nested
dict of torch tensors, so the reference and the port compute the same
function on the same weights. No import of JAX: bfloat16 leaves (numpy's
`bfloat16` extension dtype) are read through their raw 16-bit pattern.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from nos_tpu_torch.device import resolve
from nos_tpu_torch.models.gpt import GPTConfig
from nos_tpu_torch.models.vit import ViTConfig


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


def from_numpy_vit_params(tree: Dict, cfg: ViTConfig, device=None) -> Dict:
    """A ViT param tree of numpy arrays (`patch_emb`, `pos_emb`, `det_tok`,
    `layers/i/{ln1,wq,wk,wv,wo,ln2,fc1,fc2}`, `ln_f`, `class_head`,
    `box_head`) -> the same tree of tensors in `cfg.dtype` on `device`
    (None: CUDA). Raises when a key is missing or a shape is not `cfg`'s."""
    device = resolve(device, "from_numpy_vit_params")
    h, mlp = cfg.hidden, cfg.hidden * cfg.mlp_ratio
    norm = {"scale": (h,), "bias": (h,)}
    layer = {"ln1": norm, "wq": (h, h), "wk": (h, h), "wv": (h, h), "wo": (h, h),
             "ln2": norm, "fc1": (h, mlp), "fc2": (mlp, h)}
    want = {"patch_emb": (cfg.patch_size ** 2 * 3, h), "pos_emb": (cfg.seq_len, h),
            "det_tok": (cfg.det_tokens, h),
            "layers": {str(i): layer for i in range(cfg.layers)},
            "ln_f": norm, "class_head": (h, cfg.num_classes), "box_head": (h, 4)}

    def convert(node, shapes, path):
        if isinstance(shapes, dict):
            if not isinstance(node, dict) or set(node) != set(shapes):
                got = sorted(node) if isinstance(node, dict) else type(node).__name__
                raise ValueError(f"ViT params at '{path}': {got}, want keys {sorted(shapes)}")
            return {k: convert(node[k], shapes[k], f"{path}/{k}") for k in shapes}
        if tuple(np.shape(node)) != shapes:
            raise ValueError(f"ViT param '{path}' has shape {np.shape(node)}, want {shapes}")
        return _to_tensor(node, cfg.torch_dtype, device)

    return convert(tree, want, "")
