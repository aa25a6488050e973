"""The port's tensor parallelism: device meshes (`mesh`) and the parameter
sharding rules of the serving decode path (`sharding`)."""

from nos_tpu_torch.parallel.mesh import Mesh, build_mesh
from nos_tpu_torch.parallel.sharding import (
    decode_param_rules,
    guarded_spec,
    param_partition_specs,
    shard_params,
    spec_for_path,
)

__all__ = ["Mesh", "build_mesh", "decode_param_rules", "spec_for_path", "guarded_spec",
           "shard_params", "param_partition_specs"]
