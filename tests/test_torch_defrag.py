"""The cases of tests/test_defrag.py on the port: the defragmentation pass
(the planner's migrations, the move protocol, `GroupPartitioner`'s whole-
gang moves) under the port's scheduler and `ControlPlane`. Each case is the
reference's own: `torch_mirror` reads that file and points its `nos_tpu`
names at the port, so bodies, fixtures and assertions are the reference's
line for line; the reference file runs them on the JAX package in the same
run."""

import test_torch_fleet_parity as fp
import torch_mirror

_time_limit = fp.time_limit(60)
_reset_state = torch_mirror.reset_state()

torch_mirror.mirror(globals(), "test_defrag")
