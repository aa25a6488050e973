"""The port's parallelism: device meshes (`mesh`), sharding rules and
placement (`sharding`), collectives over one mesh axis (`collectives`), ring
and Ulysses attention (`ring_attention`), the GPipe pipeline (`pipeline`)
and expert parallelism (`moe`)."""

from nos_tpu_torch.parallel.mesh import (Mesh, build_mesh, build_multislice_mesh,
                                         mesh_from_assignment, mesh_from_topology)
from nos_tpu_torch.parallel.ring_attention import ring_attention, ulysses_attention
from nos_tpu_torch.parallel.sharding import (
    MeshTree,
    batch_sharding,
    decode_param_rules,
    guarded_spec,
    param_partition_specs,
    param_shardings,
    replicated,
    shard_params,
    shard_tensor,
    spec_for_path,
    transformer_param_rules,
    unshard_tensor,
)

__all__ = ["Mesh", "build_mesh", "build_multislice_mesh", "mesh_from_topology",
           "mesh_from_assignment", "decode_param_rules",
           "transformer_param_rules", "spec_for_path", "guarded_spec", "shard_params",
           "param_partition_specs", "param_shardings", "batch_sharding", "replicated",
           "shard_tensor", "unshard_tensor", "MeshTree", "ring_attention", "ulysses_attention"]
