"""nos_tpu_torch: the PyTorch/CUDA port of `nos_tpu`'s serving path.

A package of its own beside the JAX package, which stays the reference. It
imports `torch` and numpy, never `jax` and nothing of `nos_tpu`; each module
names its reference by file and line. Entry points run on CUDA unless the
caller passes `device="cpu"`, where the kernels' plain versions run.
"""

from nos_tpu_torch.models.gpt import GPTConfig, init_gpt
from nos_tpu_torch.models.params import from_numpy_params
from nos_tpu_torch.runtime.decode_server import DecodeServer

__all__ = ["DecodeServer", "GPTConfig", "init_gpt", "from_numpy_params"]
