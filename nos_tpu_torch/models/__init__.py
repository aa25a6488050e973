"""The port's model code: config and init (`gpt`), numpy param import
(`params`), and the paged serving programs (`decode`)."""

from nos_tpu_torch.models.gpt import GPTConfig, init_gpt
from nos_tpu_torch.models.params import from_numpy_params

__all__ = ["GPTConfig", "init_gpt", "from_numpy_params"]
