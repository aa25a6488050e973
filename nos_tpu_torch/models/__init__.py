"""The port's model code: config, init and the training forward (`gpt`),
the ViT detector (`vit`), numpy param import (`params`), the dense and
paged serving programs (`decode`), the train step on one device or a mesh
(`train`), checkpoints (`checkpoint`) and the input pipeline (`data`)."""

from nos_tpu_torch.models.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from nos_tpu_torch.models.decode import decode_step, generate, init_cache, prefill
from nos_tpu_torch.models.gpt import GPTConfig, gpt_forward, gpt_loss, init_gpt
from nos_tpu_torch.models.params import from_numpy_params, from_numpy_vit_params
from nos_tpu_torch.models.train import TrainConfig, init_train_state, make_train_step
from nos_tpu_torch.models.vit import ViTConfig, init_vit, vit_detect, vit_forward

__all__ = ["GPTConfig", "init_gpt", "from_numpy_params", "gpt_forward", "gpt_loss",
           "init_cache", "prefill", "decode_step", "generate",
           "TrainConfig", "init_train_state", "make_train_step",
           "save_checkpoint", "latest_step", "restore_checkpoint",
           "ViTConfig", "init_vit", "vit_forward", "vit_detect", "from_numpy_vit_params"]
