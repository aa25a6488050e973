"""nos_tpu_torch: the PyTorch/CUDA port of `nos_tpu`'s workload plane: the
serving path (the paged engine with greedy and temperature sampling, its
fleet plane, and the dense `prefill`/`decode_step`/`generate` programs),
the ViT detector behind `SliceServer`, and GPT training on one device or a
mesh (tensor, sequence, pipeline and expert parallelism, checkpoints).

A package of its own beside the JAX package, which stays the reference. It
imports `torch` and numpy, never `jax` and nothing of `nos_tpu`; each module
names its reference by file and line. Sampling keys are JAX's threefry keys
bit for bit (`prng`). Entry points run on CUDA unless the caller passes
`device="cpu"`, where the kernels' plain versions run.
"""

from nos_tpu_torch.models.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from nos_tpu_torch.models.data import (prefetch_to_device, prefetch_to_mesh,
                                       synthetic_token_stream)
from nos_tpu_torch.models.decode import decode_step, generate, init_cache, prefill
from nos_tpu_torch.models.gpt import GPTConfig, gpt_forward, gpt_loss, init_gpt
from nos_tpu_torch.models.params import from_numpy_params
from nos_tpu_torch.models.train import TrainConfig, init_train_state, make_train_step
from nos_tpu_torch.models.vit import ViTConfig, init_vit, vit_detect, vit_forward
from nos_tpu_torch.ops.flash_attention import flash_attention
from nos_tpu_torch.runtime.decode_server import DecodeServer
from nos_tpu_torch.runtime.slice_server import SliceServer

__all__ = [
    "DecodeServer", "GPTConfig", "init_gpt", "from_numpy_params",
    "init_cache", "prefill", "decode_step", "generate",
    "gpt_forward", "gpt_loss", "flash_attention",
    "TrainConfig", "init_train_state", "make_train_step",
    "synthetic_token_stream", "prefetch_to_device", "prefetch_to_mesh",
    "save_checkpoint", "latest_step", "restore_checkpoint",
    "ViTConfig", "init_vit", "vit_forward", "vit_detect", "SliceServer",
]
