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
`scheduler.quota_info`); and of the part users drive: the scheduler
(`scheduler.scheduler.Scheduler` over `scheduler.framework` and the
capacity, node-resources and TPU-topology `scheduler.plugins`), the
component configs (`config`), the one-process `system.ControlPlane` and
its `build_*` functions (`system`), the north-star capacity simulator and its
fungible-chip floor (`sim`, `sim_oracle`) and the binaries' entry point
(`cli`, `python -m nos_tpu_torch.cli` or `nos-tpu-torch`); and the
static-analysis suite behind `cli lint` (`analysis`: the engine, the call
graph, the baseline and cache, and the checkers, six of them with rules
written for PyTorch).

A package of its own beside the JAX package, which stays the reference. It
imports `torch` and numpy, never `jax` and nothing of `nos_tpu`; each module
names its reference by file and line. Sampling keys are JAX's threefry keys
bit for bit (`prng`). Entry points run on CUDA unless the caller passes
`device="cpu"`, where the kernels' plain versions run.
"""

__version__ = "0.1.0"

import importlib

#: The entry points, by the module that defines each. They load on first use
#: (PEP 562 `__getattr__`): like the reference's package, which imports
#: nothing, importing this one (the CLI, the control plane, `cli lint`)
#: loads no torch until a model, kernel or engine is asked for.
_EXPORTS = {
    "DecodeServer": "runtime.decode_server",
    "GPTConfig": "models.gpt",
    "init_gpt": "models.gpt",
    "from_numpy_params": "models.params",
    "init_cache": "models.decode",
    "prefill": "models.decode",
    "decode_step": "models.decode",
    "generate": "models.decode",
    "gpt_forward": "models.gpt",
    "gpt_loss": "models.gpt",
    "flash_attention": "ops.flash_attention",
    "TrainConfig": "models.train",
    "init_train_state": "models.train",
    "make_train_step": "models.train",
    "synthetic_token_stream": "models.data",
    "prefetch_to_device": "models.data",
    "prefetch_to_mesh": "models.data",
    "save_checkpoint": "models.checkpoint",
    "latest_step": "models.checkpoint",
    "restore_checkpoint": "models.checkpoint",
    "ViTConfig": "models.vit",
    "init_vit": "models.vit",
    "vit_forward": "models.vit",
    "vit_detect": "models.vit",
    "SliceServer": "runtime.slice_server",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
