"""YOLOS-class ViT detector.

Port of `nos_tpu/models/vit.py`: `ViTConfig` (:25), `init_vit` (:58),
`_layernorm` (:86), `_attention` (:102), `_block` (:119), `patchify` (:126),
`vit_detect` (:136) and `vit_forward` (:151). The bench workload of the
reference's GPU-sharing comparison demo (YOLOS-small inference,
BASELINE.md): a plain ViT backbone (hidden 384, 12 layers, 6 heads, the
-small size) with detection tokens and class/box heads, bf16 by default.
Params are a plain nested dict with the reference's keys and shapes, so
`models/params.py::from_numpy_vit_params` carries a JAX tree across.

From `_FLASH_MIN_SEQ` tokens on (a 512-pixel image: 1024 patches + 100
detection tokens) attention runs through the flash kernel, non-causal, on
contiguous q/k/v (`ops/flash_attention.py`); below it, the reference's
plain attention. GELU is the tanh form (`jax.nn.gelu`'s default), the
layer norm's variance the population one, in f32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from nos_tpu_torch.device import resolve
from nos_tpu_torch.ops.flash_attention import flash_attention


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden: int = 384        # YOLOS-small
    layers: int = 12
    heads: int = 6
    mlp_ratio: int = 4
    det_tokens: int = 100
    num_classes: int = 92    # COCO + no-object
    dtype: str = "bfloat16"

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.n_patches + self.det_tokens

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def init_vit(cfg: ViTConfig, generator: Optional[torch.Generator] = None,
             device=None) -> Dict:
    """Random weights with the reference's shapes and init scales
    (vit.py:58-83), drawn on the CPU from `generator` (not JAX's RNG), then
    moved to `device` (None: CUDA) in `cfg.dtype`."""
    device = resolve(device, "init_vit")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    dt = cfg.torch_dtype
    h = cfg.hidden

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, dtype=torch.float32) * scale
        return w.to(device=device, dtype=dt)

    def dense(shape):
        return normal(shape, (1.0 / shape[0]) ** 0.5)

    def norm():
        return {"scale": torch.ones((h,), dtype=dt, device=device),
                "bias": torch.zeros((h,), dtype=dt, device=device)}

    params: Dict = {
        "patch_emb": dense((cfg.patch_size ** 2 * 3, h)),
        "pos_emb": normal((cfg.seq_len, h), 0.02),
        "det_tok": normal((cfg.det_tokens, h), 0.02),
        "layers": {},
        "ln_f": norm(),
        "class_head": dense((h, cfg.num_classes)),
        "box_head": dense((h, 4)),
    }
    for i in range(cfg.layers):
        params["layers"][str(i)] = {
            "ln1": norm(),
            "wq": dense((h, h)),
            "wk": dense((h, h)),
            "wv": dense((h, h)),
            "wo": dense((h, h)),
            "ln2": norm(),
            "fc1": dense((h, h * cfg.mlp_ratio)),
            "fc2": dense((h * cfg.mlp_ratio, h)),
        }
    return params


def _layernorm(x, p):
    """f32 layer norm, population variance, eps 1e-6, cast back."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    out = (x32 - mu) * torch.rsqrt(var + 1e-6)
    return (out * p["scale"].float() + p["bias"].float()).to(x.dtype)


# From this many tokens on, attention runs through the flash kernel; below,
# the [T, T] scores are small and the plain attention's products do.
_FLASH_MIN_SEQ = 1024


def _attention(x, p, cfg: ViTConfig):
    b, t, h = x.shape
    nh, hd = cfg.heads, cfg.head_dim
    # One [h, 3h] projection instead of three [h, h].
    w_qkv = torch.cat([p["wq"], p["wk"], p["wv"]], dim=1)
    qkv = (x @ w_qkv).reshape(b, t, 3, nh, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    if t >= _FLASH_MIN_SEQ:
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=False)
    else:
        scores = (q @ k.transpose(-1, -2)) * (hd ** -0.5)
        probs = torch.softmax(scores.float(), dim=-1)
        o = probs.to(v.dtype) @ v
    return o.transpose(1, 2).reshape(b, t, h) @ p["wo"]


def _block(x, p, cfg: ViTConfig):
    x = x + _attention(_layernorm(x, p["ln1"]), p, cfg)
    y = _layernorm(x, p["ln2"])
    y = F.gelu(y @ p["fc1"], approximate="tanh") @ p["fc2"]
    return x + y


def patchify(images, cfg: ViTConfig):
    """[B, H, W, 3] -> [B, n_patches, patch*patch*3]."""
    b = images.shape[0]
    ps = cfg.patch_size
    n = cfg.image_size // ps
    x = images.reshape(b, n, ps, n, ps, 3).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, n * n, ps * ps * 3)


def vit_forward(params, images, cfg: ViTConfig):
    """images [B, H, W, 3] -> (class logits [B, det, classes] f32, boxes
    [B, det, 4] f32)."""
    x = patchify(images.to(cfg.torch_dtype), cfg) @ params["patch_emb"]
    b = x.shape[0]
    det = params["det_tok"].expand((b,) + tuple(params["det_tok"].shape))
    x = torch.cat([x, det], dim=1) + params["pos_emb"]
    for i in range(cfg.layers):
        x = _block(x, params["layers"][str(i)], cfg)
    x = _layernorm(x, params["ln_f"])
    det_out = x[:, cfg.n_patches:, :]
    logits = det_out @ params["class_head"]
    boxes = torch.sigmoid((det_out @ params["box_head"]).float())
    return logits.float(), boxes


def vit_detect(params, images, cfg: ViTConfig):
    """The detector with its postprocessing on the device: softmax over
    the classes, then per detection token the top object class (the last
    class is no-object and is left out) and its probability. Returns
    (labels [B, det] int32, scores [B, det] f32, boxes [B, det, 4] f32).
    A tie goes to the lowest class index, as `jnp.argmax` breaks it."""
    logits, boxes = vit_forward(params, images, cfg)
    obj = torch.softmax(logits, dim=-1)[..., :-1]
    scores = obj.amax(dim=-1)
    index = torch.arange(obj.shape[-1], device=obj.device)
    labels = torch.where(obj == scores[..., None], index, obj.shape[-1]).amin(dim=-1)
    return labels.to(torch.int32), scores, boxes
