"""nos_tpu_torch: the PyTorch/CUDA port of `nos_tpu`'s serving path (the
paged engine with greedy and temperature sampling, and the dense
`prefill`/`decode_step`/`generate` programs) and its single-device GPT
training step.

A package of its own beside the JAX package, which stays the reference. It
imports `torch` and numpy, never `jax` and nothing of `nos_tpu`; each module
names its reference by file and line. Sampling keys are JAX's threefry keys
bit for bit (`prng`). Entry points run on CUDA unless the caller passes
`device="cpu"`, where the kernels' plain versions run.
"""

from nos_tpu_torch.models.data import prefetch_to_device, synthetic_token_stream
from nos_tpu_torch.models.decode import decode_step, generate, init_cache, prefill
from nos_tpu_torch.models.gpt import GPTConfig, gpt_forward, gpt_loss, init_gpt
from nos_tpu_torch.models.params import from_numpy_params
from nos_tpu_torch.models.train import TrainConfig, init_train_state, make_train_step
from nos_tpu_torch.ops.flash_attention import flash_attention
from nos_tpu_torch.runtime.decode_server import DecodeServer

__all__ = [
    "DecodeServer", "GPTConfig", "init_gpt", "from_numpy_params",
    "init_cache", "prefill", "decode_step", "generate",
    "gpt_forward", "gpt_loss", "flash_attention",
    "TrainConfig", "init_train_state", "make_train_step",
    "synthetic_token_stream", "prefetch_to_device",
]
