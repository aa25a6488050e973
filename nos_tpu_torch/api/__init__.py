"""Port of `nos_tpu/api/__init__.py` (:1-19). Copied verbatim; only the imports
point at the port, which imports nothing of the JAX package.

API layer: object model, CRDs, annotation protocol, resource arithmetic."""

from nos_tpu_torch.api.objects import (  # noqa: F401
    ConfigMap,
    Container,
    Node,
    ObjectMeta,
    Pod,
    PodDisruptionBudget,
    PodDisruptionBudgetSpec,
    PodPhase,
    PodSpec,
    PodStatus,
)
from nos_tpu_torch.api.resources import (  # noqa: F401
    ResourceList,
    compute_pod_request,
    parse_quantity,
)
