"""nos_tpu_torch: the PyTorch/CUDA port of `nos_tpu`'s workload plane: the
serving path (the paged engine with greedy and temperature sampling, its
fleet plane, and the dense `prefill`/`decode_step`/`generate` programs),
the ViT detector behind `SliceServer`, GPT training on one device or a
mesh (tensor, sequence, pipeline and expert parallelism, checkpoints),
and the measurement layer (`runtime.mfu`); and of its control plane's
first layer: the object model and wire protocol (`api`, `constants`) and
the cluster bus (`cluster`: the in-memory API server, the k8s wire codec,
the HTTP API-server emulator, the real-Kubernetes backend, the admission
webhook server and the kubelet pod-resources client); and of its device
layer: the TPU domain model and canonical packer (`tpu`), the
control-plane utilities (`util`: batcher, churn ledger, predicates,
leader election) and the device-control seam (`tpulib`: the fake, native,
provisioning and local clients; the native tpuslice shim is the port's own
copy, built by g++ at first use, never on import, into
`tpulib/native/_build/`; the local client enumerates CUDA devices and, on
a GPU, refuses TPU discovery with `TpuLibError`), with
`parallel.mesh_from_assignment`, the mesh a node's sub-slice label
becomes; and of its partitioning plane: the NVIDIA modes' device models
(`gpu`: MIG with the reference's tables, MPS, the device-plugin restart),
the planner and its TPU and GPU modes (`partitioning`), the controllers
that drive them (`controllers`: the partitioner, the TPU, GPU and host
agents, the slice-group partitioner, quotas, device health) and the
scheduler's quota arithmetic (`scheduler.resource_calculator`,
`scheduler.quota_info`).

A package of its own beside the JAX package, which stays the reference. It
imports `torch` and numpy, never `jax` and nothing of `nos_tpu`; each module
names its reference by file and line. Sampling keys are JAX's threefry keys
bit for bit (`prng`). Entry points run on CUDA unless the caller passes
`device="cpu"`, where the kernels' plain versions run.
"""

# Before the imports: telemetry's ClusterReport reads it while this package
# is still initialising.
__version__ = "0.1.0"

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
