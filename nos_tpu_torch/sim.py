"""Port of `nos_tpu/sim.py:1` (:1-779): `VirtualClock` (:44), `SimJob` (:56),
`JobRecord` (:74), `SimReport` (:91), `WorkloadSim` (:314), `mixed_workload`
(:428), `GangJob` (:471), `MultiHostSim` (:488), `mixed_gang_workload`
(:637), `multihost_shape_ladder` (:678), `simulate_north_star_multihost`
(:705), `cli_single_host_trace` (:733), `simulate_north_star` (:766). Copied
verbatim; only the imports point at the port, which imports nothing of the
JAX package.

Capacity simulation harness — the north-star acceptance rig.

The reference validates its control plane on a kind cluster plus a manual AKS
benchmark (SURVEY.md §4 "Multi-node/e2e": hack/kind/cluster.yaml, the
demos/gpu-sharing-comparison harness). This module is the TPU-native
equivalent: it drives the FULL control plane (webhooks + quota reconciler +
scheduler + partitioner + node agents over fake tpulib backends) with a
time-stamped mixed JAX workload trace under a virtual clock, and reports the
two judged metrics from BASELINE.json:

  - cluster TPU-chip utilization % (chip-seconds delivered / chip-seconds
    available over the busy window), and
  - p50 Pod schedule-to-running latency.

Deterministic: seeded RNG, virtual clock, synchronous control rounds — the
same trace always yields the same report, so utilization targets are
assertable in CI (tests/test_simulation.py) with zero hardware.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from nos_tpu_torch import constants
from nos_tpu_torch.api.objects import (
    Container,
    Node,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodPhase,
    PodSpec,
)
from nos_tpu_torch.api.resources import ResourceList
from nos_tpu_torch.cluster.client import NotFoundError
from nos_tpu_torch.config import PartitionerConfig
from nos_tpu_torch.system import ControlPlane
from nos_tpu_torch.tpu import Profile, Topology
from nos_tpu_torch.tpulib import FakeTpuClient


class VirtualClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@dataclass
class SimJob:
    """One workload in the trace: arrives, requests a sub-slice (or whole
    chips), runs for ``duration_s`` once bound, then completes.
    `checkpointable` models a workload that checkpoints (orbax) and RESUMES
    after eviction — preemption costs a requeue, not the work done so far —
    and annotates the pod so checkpoint-aware consolidation may preempt it
    without a rebind proof."""

    name: str
    namespace: str
    request: Dict[str, float]
    arrival_s: float
    duration_s: float
    priority: int = 0
    checkpointable: bool = False


@dataclass
class JobRecord:
    job: SimJob
    submitted_s: Optional[float] = None
    bound_s: Optional[float] = None
    node: Optional[str] = None
    completed_s: Optional[float] = None
    preemptions: int = 0
    remaining_s: Optional[float] = None  # work left (resume semantics)

    @property
    def latency_s(self) -> Optional[float]:
        if self.bound_s is None or self.submitted_s is None:
            return None
        return self.bound_s - self.submitted_s


@dataclass
class SimReport:
    total_chips: int
    jobs: List[JobRecord]
    utilization: float          # over backlogged ("busy") ticks
    utilization_total: float    # full horizon incl. ramp + drain tail
    utilization_window: float   # over the configured measure window (steady state)
    p50_latency_s: float
    p95_latency_s: float
    makespan_s: float
    completed: int
    unfinished: int

    def to_dict(self) -> dict:
        return {
            "total_chips": self.total_chips,
            "jobs": len(self.jobs),
            "completed": self.completed,
            "unfinished": self.unfinished,
            "utilization": round(self.utilization, 4),
            "utilization_total": round(self.utilization_total, 4),
            "utilization_window": round(self.utilization_window, 4),
            "p50_schedule_latency_s": round(self.p50_latency_s, 3),
            "p95_schedule_latency_s": round(self.p95_latency_s, 3),
            "makespan_s": round(self.makespan_s, 3),
            "preemptions": sum(r.preemptions for r in self.jobs),
        }


def _chips_of(request: Dict[str, float]) -> int:
    from nos_tpu_torch.tpu.profile import chips_of_resources

    return int(chips_of_resources(request))


def _percentile(values: Sequence[float], q: float) -> float:
    if not values:
        return 0.0
    vs = sorted(values)
    idx = min(len(vs) - 1, int(round(q * (len(vs) - 1))))
    return vs[idx]


class _TraceRunner:
    """The shared trace engine: admits arrivals, restarts preempted jobs,
    completes finished ones, runs one control round per tick, integrates the
    utilization metrics, and assembles the report. Subclasses define the
    workload shape through five hooks: `_submit`, `_complete`, `_preempted`,
    `_evict_cleanup`, `_collect_bound`, and `_job_chips`."""

    clock: VirtualClock
    plane: "ControlPlane"
    total_chips: int

    def run(
        self,
        jobs: Sequence,
        tick_s: float = 1.0,
        max_s: float = 86_400.0,
        measure_window: Optional[Tuple[float, float]] = None,
        on_tick=None,
    ) -> SimReport:
        """Drive the trace to completion (or `max_s`). `measure_window`
        bounds the steady-state utilization metric: a finite trace always has
        a ramp (arrivals filling the mesh) and a drain tail (the last few
        stragglers) that say nothing about scheduler quality — the north-star
        target (>=85% on a *sustained* workload) is a steady-state property,
        so `utilization_window` integrates only over [t0, t1)."""
        records = {j.name: JobRecord(job=j) for j in jobs}
        pending_arrivals = sorted(jobs, key=lambda j: (j.arrival_s, j.name))
        running: Dict[str, JobRecord] = {}
        last_progress_s = 0.0
        used_chip_seconds = 0.0
        used_chip_seconds_busy = 0.0
        used_chip_seconds_window = 0.0
        backlog_seconds = 0.0
        # Incremental bookkeeping: chips per job (profile parsing is not
        # free at 10^5 ticks), the standing-backlog set, the completed count,
        # and the running chip total — all maintained at transition points so
        # a quiet tick costs O(running), not O(jobs).
        chips_of = {j.name: self._job_chips(j) for j in jobs}
        unbound: set = set()
        completed_count = 0
        tick_used = 0
        # Store-version gates: restarts and bind collection react to WRITES
        # (an eviction deletes pods, a bind patches them). While the store
        # version is unchanged since the last probe, both are no-ops — the
        # dominant case in a saturated backlog.
        preempt_seen = -1
        bound_seen = -1

        while self.clock.t < max_s:
            now = self.clock.t
            # 1. Admit arrivals.
            while pending_arrivals and pending_arrivals[0].arrival_s <= now:
                job = pending_arrivals.pop(0)
                self._submit(job)
                records[job.name].submitted_s = now
                unbound.add(job.name)
                last_progress_s = now
            # 2. Restart preempted jobs: an evicted workload's controller
            #    recreates it from scratch (scheduler._evict deletes pods;
            #    for a gang, losing any member kills the whole mesh).
            if (running or unbound) and self.plane.cluster.version != preempt_seen:
                for name, rec in list(running.items()):
                    if self._preempted(rec.job):
                        self._evict_cleanup(rec.job)
                        rec.preemptions += 1
                        if getattr(rec.job, "checkpointable", False):
                            # Resume semantics: progress up to the eviction
                            # survives in the checkpoint.
                            start = rec.bound_s if rec.bound_s is not None else now
                            elapsed = max(0.0, now - start)
                            left = (
                                rec.remaining_s
                                if rec.remaining_s is not None
                                else rec.job.duration_s
                            )
                            rec.remaining_s = max(0.0, left - elapsed)
                        else:
                            rec.remaining_s = rec.job.duration_s
                        rec.bound_s = None
                        rec.node = None
                        del running[name]
                        tick_used -= chips_of[name]
                        self._submit(rec.job)
                        rec.submitted_s = now
                        unbound.add(name)
                # Submitted-but-unbound jobs whose pods vanished: eviction can
                # race the bind window (the scheduler binds, consolidation
                # evicts in the same control round, the trace never observes
                # RUNNING). The workload controller resubmits those exactly
                # like running ones — without this, an evicted-while-pending
                # job is silently destroyed and the trace strands (the
                # round-3 live-lock: 11/200 jobs never finished).
                for name in list(unbound):
                    rec = records[name]
                    if rec.submitted_s is None or not self._preempted(rec.job):
                        continue
                    self._evict_cleanup(rec.job)
                    rec.preemptions += 1
                    self._submit(rec.job)
                    rec.submitted_s = now
            preempt_seen = self.plane.cluster.version
            # 3. Complete finished jobs.
            for name, rec in list(running.items()):
                due = rec.remaining_s if rec.remaining_s is not None else rec.job.duration_s
                if rec.bound_s is not None and now >= rec.bound_s + due:
                    self._complete(rec.job)
                    rec.completed_s = now
                    del running[name]
                    tick_used -= chips_of[name]
                    completed_count += 1
                    last_progress_s = now
            # 4. One control round (schedule -> partition -> schedule).
            self.plane.tick()
            # 5. Record new binds.
            if unbound and self.plane.cluster.version != bound_seen:
                waiting = {name: records[name] for name in unbound}
                for name, node in self._collect_bound(waiting).items():
                    rec = records[name]
                    rec.bound_s = now
                    rec.node = node
                    running[name] = rec
                    tick_used += chips_of[name]
                    unbound.discard(name)
                    last_progress_s = now
            bound_seen = self.plane.cluster.version
            # 6. Integrate utilization over this tick. "Busy" ticks are those
            #    with a standing backlog (some submitted job still unbound):
            #    while demand outstrips supply, delivered chip-seconds over
            #    available chip-seconds is the saturation utilization.
            used_chip_seconds += tick_used * tick_s
            if unbound:
                used_chip_seconds_busy += tick_used * tick_s
                backlog_seconds += tick_s
            if measure_window and measure_window[0] <= now < measure_window[1]:
                used_chip_seconds_window += tick_used * tick_s
            if on_tick is not None:
                # Diagnostic probe (per-tick utilization trajectory): now,
                # chips in use, the unbound job-name set, the running map.
                on_tick(now, tick_used, unbound, running)
            # Done once every job has completed.
            if not pending_arrivals and not running and completed_count == len(records):
                break
            # Stalled: the cluster is drained, no arrivals remain, and the
            # leftover pending jobs have not bound through several re-plan
            # windows — they can never fit (e.g. a sub-slice larger than any
            # node mesh). Report them as unfinished instead of spinning to
            # max_s.
            if (
                not pending_arrivals
                and not running
                and now - last_progress_s > 120.0
            ):
                break
            self.clock.advance(tick_s)

        horizon = max(self.clock.t, tick_s)
        latencies = [r.latency_s for r in records.values() if r.latency_s is not None]
        busy_window = max(backlog_seconds, tick_s)
        if measure_window:
            span = max(tick_s, min(measure_window[1], self.clock.t) - measure_window[0])
            # min() clamps a one-tick double-count when a preemptor binds in
            # the same tick its victim's record is still integrating.
            utilization_window = min(
                1.0, used_chip_seconds_window / (self.total_chips * span)
            )
        else:
            utilization_window = used_chip_seconds_busy / (self.total_chips * busy_window)
        return SimReport(
            total_chips=self.total_chips,
            jobs=list(records.values()),
            utilization=used_chip_seconds_busy / (self.total_chips * busy_window),
            utilization_total=used_chip_seconds / (self.total_chips * horizon),
            utilization_window=utilization_window,
            p50_latency_s=_percentile(latencies, 0.50),
            p95_latency_s=_percentile(latencies, 0.95),
            makespan_s=horizon,
            completed=sum(1 for r in records.values() if r.completed_s is not None),
            unfinished=sum(1 for r in records.values() if r.completed_s is None),
        )


class WorkloadSim(_TraceRunner):
    """Full control plane + node agents under a virtual clock."""

    def __init__(
        self,
        topos: Dict[str, str],
        generation_label: str = "tpu-v5-lite-podslice",
        batch_timeout_s: float = 10.0,
        batch_idle_s: float = 2.0,
        quotas: Sequence[object] = (),
        defrag_budget: int = 0,
    ):
        self.clock = VirtualClock()
        cfg = PartitionerConfig(
            modes=[constants.KIND_TPU],
            batch_window_timeout_s=batch_timeout_s,
            batch_window_idle_s=batch_idle_s,
            defrag_budget=defrag_budget,
        )
        self.plane = ControlPlane(partitioner_config=cfg, now=self.clock)
        self.total_chips = 0
        for node_name, topo in topos.items():
            topology = Topology.from_node_labels(
                {
                    constants.LABEL_TPU_ACCELERATOR: generation_label,
                    constants.LABEL_TPU_TOPOLOGY: topo,
                }
            )
            self.total_chips += topology.chips
            self.plane.cluster.create(
                Node(
                    metadata=ObjectMeta(
                        name=node_name,
                        labels={
                            constants.LABEL_PARTITIONING: constants.KIND_TPU,
                            constants.LABEL_TPU_ACCELERATOR: generation_label,
                            constants.LABEL_TPU_TOPOLOGY: topo,
                        },
                    ),
                    status=NodeStatus(
                        allocatable=ResourceList.of(
                            {"cpu": 64, "memory": "256Gi",
                             constants.RESOURCE_TPU: topology.chips}
                        )
                    ),
                )
            )
        for quota in quotas:
            self.plane.cluster.create(quota)
        self.plane.start()
        for node_name, topo in topos.items():
            gen = Topology.from_node_labels(
                {
                    constants.LABEL_TPU_ACCELERATOR: generation_label,
                    constants.LABEL_TPU_TOPOLOGY: topo,
                }
            )
            self.plane.add_tpu_agent(node_name, client=FakeTpuClient(gen))

    # -- trace hooks ---------------------------------------------------------
    def _job_chips(self, job: SimJob) -> int:
        return _chips_of(job.request)

    def _preempted(self, job: SimJob) -> bool:
        return (
            self.plane.cluster.peek("Pod", job.namespace, job.name, lambda p: True)
            is None
        )

    def _evict_cleanup(self, job: SimJob) -> None:
        pass  # the evicted pod is already gone

    def _collect_bound(self, waiting: Dict[str, JobRecord]) -> Dict[str, str]:
        """name -> node for jobs that are now fully bound (one cluster list,
        not a try_get per record)."""
        bound: Dict[str, str] = {}
        for pod in self.plane.cluster.list("Pod"):
            rec = waiting.get(pod.metadata.name)
            if (
                rec is not None
                and pod.spec.node_name
                and pod.status.phase == PodPhase.RUNNING
            ):
                bound[pod.metadata.name] = pod.spec.node_name
        return bound

    def _submit(self, job: SimJob) -> None:
        annotations = {
            constants.ANNOTATION_EXPECTED_DURATION: f"{job.duration_s:.0f}"
        }
        if job.checkpointable:
            annotations[constants.ANNOTATION_CHECKPOINTABLE] = "true"
        self.plane.cluster.create(
            Pod(
                metadata=ObjectMeta(
                    name=job.name,
                    namespace=job.namespace,
                    annotations=annotations,
                ),
                spec=PodSpec(
                    containers=[Container(resources=ResourceList.of(job.request))],
                    scheduler_name=constants.SCHEDULER_NAME,
                    priority=job.priority,
                ),
            )
        )

    def _complete(self, job: SimJob) -> None:
        def mutate(p: Pod) -> None:
            p.status.phase = PodPhase.SUCCEEDED

        self.plane.cluster.patch("Pod", job.namespace, job.name, mutate)


def mixed_workload(
    n_jobs: int,
    seed: int = 0,
    profiles: Sequence[Tuple[str, float]] = (
        ("1x1", 0.35), ("2x2", 0.30), ("2x4", 0.20), ("4x4", 0.10), ("4x8", 0.05),
    ),
    namespaces: Sequence[str] = ("team-a", "team-b", "team-c"),
    mean_interarrival_s: float = 2.0,
    duration_range_s: Tuple[float, float] = (60.0, 600.0),
    checkpointable_fraction: float = 0.0,
) -> List[SimJob]:
    """A deterministic mixed JAX workload trace: Poisson arrivals, weighted
    sub-slice sizes, uniform durations — the shape of the north-star scenario
    (BASELINE.json: 'mixed JAX workload onto a dynamically-partitioned
    v5e-256'). `checkpointable_fraction` marks that share of jobs as
    checkpoint-resumable (drawn from an INDEPENDENT RNG stream, so traces
    with different fractions share arrivals/shapes/durations exactly —
    including fraction 0, which must reproduce the judged trace
    bit-for-bit)."""
    rng = random.Random(seed)
    flag_rng = random.Random(f"{seed}-checkpointable")
    names = [p for p, _ in profiles]
    weights = [w for _, w in profiles]
    jobs: List[SimJob] = []
    t = 0.0
    for i in range(n_jobs):
        t += rng.expovariate(1.0 / mean_interarrival_s)
        shape = rng.choices(names, weights=weights)[0]
        jobs.append(
            SimJob(
                name=f"job-{i:04d}",
                namespace=rng.choice(list(namespaces)),
                request={f"{constants.RESOURCE_TPU}-{shape}": 1},
                arrival_s=t,
                duration_s=rng.uniform(*duration_range_s),
                priority=rng.choice([0, 0, 0, 10]),
                checkpointable=flag_rng.random() < checkpointable_fraction,
            )
        )
    return jobs


@dataclass
class GangJob:
    """A multi-host workload: `hosts` pods, one per host, gang-bound onto a
    sub-slice of `topology` chips. `checkpointable` marks a gang that
    checkpoints (orbax) and RESUMES after eviction — the common case for
    exactly the large long-running training jobs whose drains dominate the
    multihost tail."""

    name: str
    namespace: str
    topology: str  # chip shape, e.g. "4x8"
    hosts: int
    arrival_s: float
    duration_s: float
    priority: int = 0
    checkpointable: bool = False


class MultiHostSim(_TraceRunner):
    """North-star scenario at its true shape: slice groups of host nodes
    (one Node per VM, local chips only), carved by the GroupPartitioner and
    consumed by gang workloads. Chip accounting is per gang (hosts x chips
    per host)."""

    def __init__(
        self,
        groups: Dict[str, Tuple[str, str, Tuple[int, int]]],
        generation_label: str = "tpu-v5-lite-podslice",
        batch_timeout_s: float = 10.0,
        batch_idle_s: float = 2.0,
        defrag_budget: int = 0,
    ):
        from nos_tpu_torch.api.objects import Node, NodeStatus

        self.clock = VirtualClock()
        cfg = PartitionerConfig(
            batch_window_timeout_s=batch_timeout_s,
            batch_window_idle_s=batch_idle_s,
            defrag_budget=defrag_budget,
        )
        self.plane = ControlPlane(partitioner_config=cfg, now=self.clock)
        self.total_chips = 0
        self.chips_per_host: Dict[str, int] = {}
        for slice_id, (global_topo, host_topo, grid) in groups.items():
            host_chips = 1
            for d in host_topo.split("x"):
                host_chips *= int(d)
            self.chips_per_host[slice_id] = host_chips
            for r in range(grid[0]):
                for c in range(grid[1]):
                    name = f"{slice_id}-host-{r}-{c}"
                    self.plane.cluster.create(
                        Node(
                            metadata=ObjectMeta(
                                name=name,
                                labels={
                                    constants.LABEL_PARTITIONING: constants.KIND_TPU_MULTIHOST,
                                    constants.LABEL_TPU_SLICE: slice_id,
                                    constants.LABEL_TPU_ACCELERATOR: generation_label,
                                    constants.LABEL_TPU_TOPOLOGY: global_topo,
                                    constants.LABEL_TPU_HOST_TOPOLOGY: host_topo,
                                    constants.LABEL_TPU_HOST_COORD: f"{r},{c}",
                                },
                            ),
                            status=NodeStatus(
                                allocatable=ResourceList.of(
                                    {"cpu": 32, "memory": "64Gi",
                                     constants.RESOURCE_TPU: host_chips}
                                )
                            ),
                        )
                    )
                    self.plane.add_host_agent(name)
                    self.total_chips += host_chips
        self._host_chips = next(iter(self.chips_per_host.values()))
        self.plane.start()

    # -- trace hooks ---------------------------------------------------------
    def _job_chips(self, job: GangJob) -> int:
        return Profile.parse(job.topology).chips

    def _member_states(self, job: GangJob):
        """(phase, node_name) per member via copy-free peeks — the per-tick
        probe path must not deep-copy whole gangs."""
        return [
            self.plane.cluster.peek(
                "Pod",
                job.namespace,
                f"{job.name}-{i}",
                lambda p: (p.status.phase, p.spec.node_name),
            )
            for i in range(job.hosts)
        ]

    def _preempted(self, job: GangJob) -> bool:
        return any(m is None for m in self._member_states(job))

    def _evict_cleanup(self, job: GangJob) -> None:
        for i, m in enumerate(self._member_states(job)):
            if m is not None:
                try:
                    self.plane.cluster.delete("Pod", job.namespace, f"{job.name}-{i}")
                except NotFoundError:
                    pass  # member already gone: eviction raced completion

    def _collect_bound(self, waiting: Dict[str, JobRecord]) -> Dict[str, str]:
        bound: Dict[str, str] = {}
        for name, rec in waiting.items():
            members = self._member_states(rec.job)
            if all(
                m is not None and m[0] == PodPhase.RUNNING for m in members
            ):
                bound[name] = members[0][1]
        return bound

    def _submit(self, job: GangJob) -> None:
        for i in range(job.hosts):
            self.plane.cluster.create(
                Pod(
                    metadata=ObjectMeta(
                        name=f"{job.name}-{i}",
                        namespace=job.namespace,
                        labels={
                            constants.LABEL_GANG: job.name,
                            constants.LABEL_GANG_SIZE: str(job.hosts),
                        },
                        annotations={
                            constants.ANNOTATION_EXPECTED_DURATION: (
                                f"{job.duration_s:.0f}"
                            ),
                            **(
                                {constants.ANNOTATION_CHECKPOINTABLE: "true"}
                                if job.checkpointable
                                else {}
                            ),
                        },
                    ),
                    spec=PodSpec(
                        containers=[
                            Container(
                                resources=ResourceList.of(
                                    {constants.RESOURCE_TPU: self._host_chips, "cpu": 1}
                                )
                            )
                        ],
                        scheduler_name=constants.SCHEDULER_NAME,
                        priority=job.priority,
                        node_selector={
                            constants.LABEL_TPU_SUBSLICE_TOPOLOGY: job.topology
                        },
                    ),
                )
            )

    def _complete(self, job: GangJob) -> None:
        for i in range(job.hosts):
            def mutate(p: Pod) -> None:
                p.status.phase = PodPhase.SUCCEEDED

            try:
                self.plane.cluster.patch(
                    "Pod", job.namespace, f"{job.name}-{i}", mutate
                )
            except NotFoundError:
                pass  # member already deleted (eviction raced the finish)


def mixed_gang_workload(
    n_jobs: int,
    seed: int = 0,
    shapes: Sequence[Tuple[str, int, float]] = (
        ("2x2", 1, 0.30), ("2x4", 2, 0.30), ("4x4", 4, 0.20),
        ("4x8", 8, 0.15), ("8x8", 16, 0.05),
    ),
    namespaces: Sequence[str] = ("team-a", "team-b", "team-c"),
    mean_interarrival_s: float = 4.0,
    duration_range_s: Tuple[float, float] = (60.0, 600.0),
    checkpointable_fraction: float = 0.0,
) -> List[GangJob]:
    """Gang-shaped mixed trace: (chip topology, hosts) weighted toward the
    small end, Poisson arrivals, uniform durations. `checkpointable_fraction`
    draws from an INDEPENDENT RNG stream so traces with different fractions
    share arrivals/shapes/durations exactly (fraction 0 reproduces the
    judged trace bit-for-bit)."""
    rng = random.Random(seed)
    flag_rng = random.Random(f"{seed}-checkpointable")
    names = [(t, h) for t, h, _ in shapes]
    weights = [w for _, _, w in shapes]
    jobs: List[GangJob] = []
    t = 0.0
    for i in range(n_jobs):
        t += rng.expovariate(1.0 / mean_interarrival_s)
        topology, hosts = rng.choices(names, weights=weights)[0]
        jobs.append(
            GangJob(
                name=f"gang-{i:04d}",
                namespace=rng.choice(list(namespaces)),
                topology=topology,
                hosts=hosts,
                arrival_s=t,
                duration_s=rng.uniform(*duration_range_s),
                priority=rng.choice([0, 0, 0, 10]),
                checkpointable=flag_rng.random() < checkpointable_fraction,
            )
        )
    return jobs


def multihost_shape_ladder(
    global_topology: str, host_topology: str
) -> Tuple[Tuple[str, int, float], ...]:
    """The gang-shape mix for a slice group: every host-aligned sub-slice
    shape from one host up to the FULL global mesh, halving weights as
    shapes grow (the smaller axis doubles first: 2x2 -> 2x4 -> 4x4 ...).
    Shared by the `simulate --multihost` CLI and the north-star acceptance
    test so they always judge the same scenario — the full-mesh gang at the
    top of the ladder is what exercises drain scheduling."""
    import math

    from nos_tpu_torch.tpu.shape import Shape

    global_shape = Shape.parse(global_topology)
    host_shape = Shape.parse(host_topology)
    shapes: List[Tuple[str, int, float]] = []
    d = list(host_shape.dims)
    w = 1.0
    while all(x <= g for x, g in zip(d, global_shape.dims)):
        hosts = math.prod(x // h for x, h in zip(d, host_shape.dims))
        shapes.append(("x".join(map(str, d)), hosts, w))
        i = min(range(len(d)), key=lambda j: d[j])
        d = [x * 2 if j == i else x for j, x in enumerate(d)]
        w /= 2
    return tuple(shapes)


def simulate_north_star_multihost(
    n_jobs: int = 200,
    seed: int = 0,
    tick_s: float = 1.0,
    measure_window: Optional[Tuple[float, float]] = (180.0, 900.0),
    checkpointable_fraction: float = 0.0,
    defrag_budget: int = 0,
) -> SimReport:
    """The north star at its TRUE shape — identical to the judged
    `simulate --multihost --topology 16x16` defaults: ONE v5e-256 pod = 64
    host nodes of 2x2 chips (16x16 global mesh), dynamically carved into
    ICI-contiguous sub-slices consumed by 200 gang workloads whose shapes
    range up to the full mesh. `defrag_budget` arms the GroupPartitioner's
    slice-migration pass (the `--defrag` CLI lever)."""
    sim = MultiHostSim(
        groups={"v5e-256": ("16x16", "2x2", (8, 8))},
        defrag_budget=defrag_budget,
    )
    jobs = mixed_gang_workload(
        n_jobs,
        seed=seed,
        shapes=multihost_shape_ladder("16x16", "2x2"),
        mean_interarrival_s=2.0,
        checkpointable_fraction=checkpointable_fraction,
    )
    return sim.run(jobs, tick_s=tick_s, measure_window=measure_window)


def cli_single_host_trace(
    n_jobs: int = 200,
    seed: int = 0,
    topology: str = "8x8",
    generation_label: str = "tpu-v5-lite-podslice",
    mean_interarrival_s: float = 2.0,
    duration_range_s: Tuple[float, float] = (60.0, 600.0),
    checkpointable_fraction: float = 0.0,
) -> List[SimJob]:
    """THE trace behind `python -m nos_tpu_torch.cli simulate` (no flags): every
    sub-slice the node topology supports, weighted toward the small end.
    One definition shared by the CLI and the oracle/CI tests — a diverging
    re-construction is exactly how the r4 doc-table/CLI mismatch happened
    on the multihost side."""
    from nos_tpu_torch.tpu import Topology
    from nos_tpu_torch.tpu.topology import _ACCELERATOR_GENERATIONS

    generation = _ACCELERATOR_GENERATIONS[generation_label]
    allowed = Topology.parse(generation, topology).allowed_profiles
    weights = [2.0 ** -i for i in range(len(allowed))]
    profiles = tuple(
        (p.name, w / sum(weights)) for p, w in zip(allowed, weights)
    )
    return mixed_workload(
        n_jobs,
        seed=seed,
        profiles=profiles,
        mean_interarrival_s=mean_interarrival_s,
        duration_range_s=duration_range_s,
        checkpointable_fraction=checkpointable_fraction,
    )


def simulate_north_star(
    n_jobs: int = 200,
    seed: int = 0,
    tick_s: float = 1.0,
    measure_window: Optional[Tuple[float, float]] = (180.0, 900.0),
) -> SimReport:
    """The headline scenario: a v5e-256 pod (4 podslice nodes of 8x8 = 256
    chips) dynamically partitioned under a sustained mixed workload. The
    default measure window starts after the ~3-minute ramp and ends while the
    backlog is still deep, capturing the sustained-load steady state the
    north-star ≥85% utilization target refers to."""
    sim = WorkloadSim(topos={f"v5e-node-{i}": "8x8" for i in range(4)})
    jobs = mixed_workload(n_jobs, seed=seed)
    return sim.run(jobs, tick_s=tick_s, measure_window=measure_window)
