"""Port of `nos_tpu/util/pod.py` (:1-160): `is_pending` (:13),
`is_unschedulable` (:17), `is_preempting` (:26),
`is_owned_by_daemonset_or_node` (:30),
`extra_resources_could_help_scheduling` (:34), `is_over_quota` (:46),
`is_scheduled` (:51), `is_active` (:55), `expected_duration_s` (:64),
`bound_at_s` (:76), `expected_end_s` (:88), `latest_expected_end` (:97),
`is_checkpointable` (:114), `gang_of` (:124), `gang_size_of` (:132),
`multislice_count` (:139), `wanted_subslice_topology` (:147). Copied
verbatim; only the imports point at the port, which imports nothing of the
JAX package.

Pod predicates (reference pkg/util/pod/pod.go:31-48)."""

from __future__ import annotations

from nos_tpu_torch import constants
from nos_tpu_torch.api.objects import Pod, PodPhase

# k8s PodScheduled condition constants.
COND_POD_SCHEDULED = "PodScheduled"
REASON_UNSCHEDULABLE = "Unschedulable"


def is_pending(pod: Pod) -> bool:
    return pod.status.phase == PodPhase.PENDING


def is_unschedulable(pod: Pod) -> bool:
    cond = pod.condition(COND_POD_SCHEDULED)
    return (
        cond is not None
        and cond.status == "False"
        and cond.reason == REASON_UNSCHEDULABLE
    )


def is_preempting(pod: Pod) -> bool:
    return bool(pod.status.nominated_node_name)


def is_owned_by_daemonset_or_node(pod: Pod) -> bool:
    return any(o.kind in ("DaemonSet", "Node") for o in pod.owner_references)


def extra_resources_could_help_scheduling(pod: Pod) -> bool:
    """The gate for feeding a pod to the partitioner batch (pod.go:41-48):
    pending AND marked unschedulable AND not already preempting AND not owned by
    a DaemonSet/Node (those are pinned and new capacity can't help)."""
    return (
        is_pending(pod)
        and is_unschedulable(pod)
        and not is_preempting(pod)
        and not is_owned_by_daemonset_or_node(pod)
    )


def is_over_quota(pod: Pod) -> bool:
    """Over-quota pods are preemption victims first (pod.go:31-36)."""
    return pod.metadata.labels.get(constants.LABEL_CAPACITY) == constants.CAPACITY_OVER_QUOTA


def is_scheduled(pod: Pod) -> bool:
    return bool(pod.spec.node_name)


def is_active(pod: Pod) -> bool:
    """Consumes resources on its node: scheduled and not finished."""
    return is_scheduled(pod) and pod.status.phase not in (
        PodPhase.SUCCEEDED,
        PodPhase.FAILED,
    )


# -- temporal model (duration-aware backfill) --------------------------------
def expected_duration_s(pod: Pod):
    """User-declared expected runtime in seconds, or None (unknown)."""
    raw = pod.metadata.annotations.get(constants.ANNOTATION_EXPECTED_DURATION)
    if not raw:
        return None
    try:
        value = float(raw)
    except ValueError:
        return None
    return value if value > 0 else None


def bound_at_s(pod: Pod):
    """Scheduler-stamped bind time (seconds on the scheduler's clock), or
    None for pods bound by a scheduler that predates the stamp."""
    raw = pod.metadata.annotations.get(constants.ANNOTATION_BOUND_AT)
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        return None


def expected_end_s(pod: Pod):
    """bound-at + expected-duration, or None when either is unknown."""
    start = bound_at_s(pod)
    duration = expected_duration_s(pod)
    if start is None or duration is None:
        return None
    return start + duration


def latest_expected_end(pods, now: float, count_pod=None):
    """The latest stamped end among `pods` (>= now), or None when ANY
    counted occupant's end is unknown — the shared "when does this node
    drain" rule used by both the scheduler's drain-set reservations and the
    end-aligned score. `count_pod` optionally filters which pods matter
    (e.g. only TPU-consuming ones)."""
    latest = now
    for p in pods:
        if count_pod is not None and not count_pod(p):
            continue
        end = expected_end_s(p)
        if end is None:
            return None
        latest = max(latest, end)
    return latest


def is_checkpointable(pod: Pod) -> bool:
    """The workload declared it checkpoints and resumes after eviction."""
    return (
        pod.metadata.annotations.get(constants.ANNOTATION_CHECKPOINTABLE, "")
        .lower()
        == "true"
    )


# -- gang membership (multi-host workloads: one pod per host) ----------------
def gang_of(pod: Pod):
    """'<ns>/<gang-name>' or None."""
    name = pod.metadata.labels.get(constants.LABEL_GANG)
    if not name:
        return None
    return f"{pod.metadata.namespace}/{name}"


def gang_size_of(pod: Pod) -> int:
    try:
        return int(pod.metadata.labels.get(constants.LABEL_GANG_SIZE, "1"))
    except ValueError:
        return 1


def multislice_count(pod: Pod) -> int:
    """How many DCN-connected sub-slices the gang spans (default 1)."""
    try:
        return max(1, int(pod.metadata.labels.get(constants.LABEL_MULTISLICE_COUNT, "1")))
    except ValueError:
        return 1


def wanted_subslice_topology(pod: Pod):
    """The sub-slice shape a gang pod selects (its nodeSelector on the
    subslice-topology label), as a Profile; None for non-gang pods."""
    value = pod.spec.node_selector.get(constants.LABEL_TPU_SUBSLICE_TOPOLOGY)
    if not value:
        return None
    from nos_tpu_torch.tpu import Profile

    try:
        return Profile.parse(value)
    except ValueError:
        # Malformed selector value: the pod simply doesn't gang-select a
        # sub-slice shape.
        return None
