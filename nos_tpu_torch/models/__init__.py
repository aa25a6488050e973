"""The port's model code: config, init and the training forward (`gpt`),
numpy param import (`params`), the dense and paged serving programs
(`decode`), the single-device train step (`train`) and the input pipeline
(`data`)."""

from nos_tpu_torch.models.decode import decode_step, generate, init_cache, prefill
from nos_tpu_torch.models.gpt import GPTConfig, gpt_forward, gpt_loss, init_gpt
from nos_tpu_torch.models.params import from_numpy_params
from nos_tpu_torch.models.train import TrainConfig, init_train_state, make_train_step

__all__ = ["GPTConfig", "init_gpt", "from_numpy_params", "gpt_forward", "gpt_loss",
           "init_cache", "prefill", "decode_step", "generate",
           "TrainConfig", "init_train_state", "make_train_step"]
