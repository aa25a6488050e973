"""Port of `nos_tpu/tpu/__init__.py` (:1-16). Copied verbatim; only the imports
point at the port, which imports nothing of the JAX package.

TPU device domain model.

The analog of the reference's pkg/gpu + pkg/gpu/mig layer (Slice/Geometry
abstractions, known-geometry tables, greedy UpdateGeometryFor), rebuilt for TPU
ICI meshes: a *profile* is an ICI-contiguous sub-slice shape (``2x2``,
``2x2x4``, ...), a *geometry* is a multiset of profiles carved out of one
node's chip mesh, and *placement* is a canonical deterministic function of the
geometry (buddy allocation over the mesh) — so the central planner and the
node agent agree on chip assignment without ever transmitting coordinates.
"""

from nos_tpu_torch.tpu.shape import Shape  # noqa: F401
from nos_tpu_torch.tpu.profile import Profile, chips_of_resources  # noqa: F401
from nos_tpu_torch.tpu.topology import Topology, accelerator_generation  # noqa: F401
from nos_tpu_torch.tpu.packing import Placement, pack  # noqa: F401
from nos_tpu_torch.tpu.mesh import TpuMesh  # noqa: F401
