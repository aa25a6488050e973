"""The case of tests/test_kube_full_loop.py on the port: the scheduler, the
partitioner and the tpu-agent, each on its own `KubeCluster`, talking only
through the port's `ClusterAPIServer` over HTTP (pending pod -> planner
spec annotations -> agent carve and status -> scheduler bind). The case is
the reference's own: `torch_mirror` reads that file and points its
`nos_tpu` names at the port, so body, fixture and assertions are the
reference's line for line; the reference file runs it on the JAX package
in the same run."""

import test_torch_fleet_parity as fp
import torch_mirror

_time_limit = fp.time_limit(60)
_reset_state = torch_mirror.reset_state()

torch_mirror.mirror(globals(), "test_kube_full_loop")
