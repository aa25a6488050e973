"""Port of `nos_tpu/system.py:1` (:1-478): `SchedulerSim` (:51),
`build_scheduler` (:70), `build_partitioner_controllers` (:97),
`build_tpu_agent` (:155), `ControlPlane` (:242), `build_gpu_agent` (:414).
Copied verbatim; only the imports point at the port, which imports nothing
of the JAX package.

Full control-plane assembly.

Wires every component over one cluster bus, the way the reference's six
binaries + Helm chart assemble the running system (SURVEY.md §3.5): quota
webhooks + reconciler (operator), the quota/topology-aware scheduler, one
partitioner controller per enabled mode, and node agents with health
monitors. Components are individually constructible (each CLI binary runs
one); ControlPlane runs them all in-process — the single-binary dev/test
deployment.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional

from nos_tpu_torch import constants
from nos_tpu_torch.api.webhooks import install_quota_webhooks
from nos_tpu_torch.cluster.client import Cluster
from nos_tpu_torch.config import AgentConfig, OperatorConfig, PartitionerConfig, SchedulerConfig
from nos_tpu_torch.controllers.gpu_agent import (
    FakeGpuDeviceClient,
    GpuAgent,
    mig_validator,
    mps_validator,
)
from nos_tpu_torch.controllers.health import DeviceHealthMonitor
from nos_tpu_torch.controllers.partitioner import PartitionerController
from nos_tpu_torch.controllers.quota import QuotaReconciler
from nos_tpu_torch.controllers.tpu_agent import TpuAgent
from nos_tpu_torch.gpu.mig import MigProfile
from nos_tpu_torch.gpu.mps import MpsProfile
from nos_tpu_torch.observability import HealthManager, Metrics, metrics, setup_logging
from nos_tpu_torch.partitioning.gpu_modes import (
    MigPartitioner,
    MigSnapshotTaker,
    MpsPartitioner,
    MpsSnapshotTaker,
)
from nos_tpu_torch.partitioning.state import ClusterState
from nos_tpu_torch.partitioning.tpu_mode import TpuPartitioner, TpuSnapshotTaker
from nos_tpu_torch.scheduler.resource_calculator import ResourceCalculator
from nos_tpu_torch.scheduler.scheduler import Scheduler
from nos_tpu_torch.tpu import Topology
from nos_tpu_torch.tpulib import FakeTpuClient

logger = logging.getLogger(__name__)


class SchedulerSim:
    """The embedded-framework simulation seam for the planner
    (cmd/gpupartitioner/gpupartitioner.go:293-317 analog)."""

    def __init__(self, scheduler: Scheduler):
        self._scheduler = scheduler
        self._state = None

    def pre_filter(self, pod) -> bool:
        from nos_tpu_torch.scheduler.framework import CycleState

        self._state = CycleState()
        self._scheduler.refresh_capacity()
        return self._scheduler.framework.run_pre_filter(self._state, pod).is_success

    def filter(self, pod, node_info) -> bool:
        return self._scheduler.framework.run_filters(self._state, pod, node_info).is_success


def build_scheduler(
    cluster: Cluster, config: Optional[SchedulerConfig] = None, now=None
) -> Scheduler:
    config = config or SchedulerConfig()
    calculator = ResourceCalculator(
        tpu_chip_memory_gb=config.tpu_chip_memory_gb,
        nvidia_gpu_memory_gb=config.nvidia_gpu_memory_gb,
    )
    return Scheduler(
        cluster,
        calculator=calculator,
        scheduler_name=config.scheduler_name,
        now=now,
        backfill_min_fraction=config.backfill_min_fraction,
        backfill_after_s=config.backfill_after_s,
        backfill_bypass_factor=config.backfill_bypass_factor,
        queue_policy=config.queue_policy,
        swf_aging_chips=config.swf_aging_chips,
        swf_default_duration_s=config.swf_default_duration_s,
        checkpoint_preempt_after_s=config.checkpoint_preempt_after_s,
        checkpoint_min_gain_s=config.checkpoint_min_gain_s,
        checkpoint_victim_cooldown_s=config.checkpoint_victim_cooldown_s,
        checkpoint_victim_budget=config.checkpoint_victim_budget,
        checkpoint_victim_window_s=config.checkpoint_victim_window_s,
    )


def build_partitioner_controllers(
    cluster: Cluster,
    state: ClusterState,
    scheduler: Scheduler,
    config: Optional[PartitionerConfig] = None,
    now=None,
) -> Dict[str, PartitionerController]:
    config = config or PartitionerConfig()
    config.apply_mig_overrides()
    sim = SchedulerSim(scheduler)
    controllers: Dict[str, PartitionerController] = {}
    mode_wiring = {
        constants.KIND_TPU: (TpuSnapshotTaker(), TpuPartitioner(cluster)),
        constants.KIND_MIG: (MigSnapshotTaker(), MigPartitioner(cluster)),
        constants.KIND_MPS: (
            MpsSnapshotTaker(),
            MpsPartitioner(
                cluster,
                cm_name=config.device_plugin_cm_name,
                cm_namespace=config.device_plugin_cm_namespace,
            ),
        ),
    }
    modes = list(config.modes)
    if constants.KIND_HYBRID in modes:
        # Not a controller of its own: hybrid-labeled nodes are served by
        # BOTH the mig and mps controllers (constants.KIND_HYBRID), so
        # enabling hybrid pulls in whichever of the two is not already on.
        modes += [
            m
            for m in (constants.KIND_MIG, constants.KIND_MPS)
            if m not in modes
        ]
    for mode in modes:
        if mode in (constants.KIND_TPU_MULTIHOST, constants.KIND_HYBRID):
            continue  # multihost: dedicated GroupPartitioner; hybrid: see above
        taker, partitioner = mode_wiring[mode]
        controllers[mode] = PartitionerController(
            cluster=cluster,
            state=state,
            kind=mode,
            snapshot_taker=taker,
            partitioner=partitioner,
            sim_scheduler=sim,
            batch_timeout_s=config.batch_window_timeout_s,
            batch_idle_s=config.batch_window_idle_s,
            defrag_budget=config.defrag_budget,
            migration_hold_s=config.migration_hold_s,
            checkpoint_preempt_after_s=config.checkpoint_preempt_after_s,
            checkpoint_min_gain_s=config.checkpoint_min_gain_s,
            checkpoint_victim_cooldown_s=config.checkpoint_victim_cooldown_s,
            checkpoint_victim_budget=config.checkpoint_victim_budget,
            checkpoint_victim_window_s=config.checkpoint_victim_window_s,
            now=now,
        )
    return controllers


def build_tpu_agent(
    cluster: Cluster,
    node_name: str,
    config: Optional[AgentConfig] = None,
    client=None,
    pod_resources_socket: Optional[str] = None,
) -> TpuAgent:
    """Node agent with the best available device backend: the real local
    chips when the operator explicitly granted them to this process
    (NOS_TPU_LOCAL_CHIPS — discovery + health on silicon, tpulib/local.py),
    else native tpuslice if it builds, else the pure-Python fake (the
    build-tag seam). With `pod_resources_socket`, device accounting comes
    from the kubelet pod-resources gRPC socket instead of the in-process
    client."""
    config = config or AgentConfig()
    if client is None:
        node = cluster.get("Node", "", node_name)
        topology = Topology.from_node_labels(node.metadata.labels)
        if topology is None:
            raise ValueError(f"node {node_name} has no TPU topology labels")
        client = None
        import os

        grant = os.environ.get(constants.ENV_LOCAL_CHIPS, "").strip().lower()
        if config.use_local_tpulib and grant in ("1", "true", "yes", "on"):
            # Gated on the operator's EXPLICIT chip grant, not mere
            # visibility: probing initializes the single-process libtpu
            # runtime, which on a shared TPU VM would seize the chips out
            # from under colocated workloads. The chart sets the env var
            # together with the google.com/tpu resource request. ("0" /
            # "false" disable — a truthiness check would read '0' as a
            # grant.)
            from nos_tpu_torch.tpulib.interface import TpuLibError
            from nos_tpu_torch.tpulib.local import LocalChipClient

            try:
                candidate = LocalChipClient(expected=topology)
            except TpuLibError as e:
                # The explicit grant could not be honored (no runtime, no
                # chips, unmapped device kind, holey enumeration): say so
                # — the operator asked for silicon and is getting a model
                # — then fall through the ladder rather than crash.
                logger.warning(
                    "local-chip grant set but unusable (%s); falling back "
                    "to a modeled backend",
                    e,
                )
                candidate = None
            if candidate is not None and candidate.topology_mismatch is None:
                client = candidate
            elif candidate is not None:
                # Device truth contradicts the node labels. The whole
                # control plane (planner, annotations, scheduler) plans
                # against the LABEL geometry, so actuating on a
                # different one would diverge from every plan written
                # for this node — surface the conflict and keep the
                # label-shaped modeled backend instead (fail-safe).
                # NB the probe already initialized libtpu, and a live
                # process cannot release it — fix the labels or the
                # grant and restart the agent.
                logger.warning(
                    "%s; declining the local backend (note: this "
                    "process still holds the TPU runtime — restart "
                    "after fixing labels/grant)",
                    candidate.topology_mismatch,
                )
        if client is None and config.use_native_tpulib:
            try:
                from nos_tpu_torch.tpulib.native_client import NativeTpuClient

                client = NativeTpuClient(topology)
            except Exception:  # noqa: BLE001
                logger.warning("native tpuslice unavailable; using fake backend")
        if client is None:
            client = FakeTpuClient(topology)
    lister = _pod_resources_lister(pod_resources_socket)
    return TpuAgent(cluster, node_name, client, pod_resources_lister=lister)


def _pod_resources_lister(socket_path: Optional[str]):
    if not socket_path:
        return None
    from nos_tpu_torch.cluster.pod_resources_grpc import KubeletPodResourcesClient

    return KubeletPodResourcesClient(socket_path)


class ControlPlane:
    """Everything in one process over one cluster bus."""

    # Periodic agent resync bound: reports are re-driven at least every this
    # many ticks even with no store writes (device state is not store state).
    AGENT_RESYNC_TICKS = 10

    def __init__(
        self,
        cluster: Optional[Cluster] = None,
        operator_config: Optional[OperatorConfig] = None,
        partitioner_config: Optional[PartitionerConfig] = None,
        scheduler_config: Optional[SchedulerConfig] = None,
        now=None,
    ):
        # The bus shares the control plane's clock: creation timestamps feed
        # scheduling order AND pending-age math (backfill aging), which must
        # run on the same timeline as the virtual clock in simulations.
        if cluster is not None:
            self.cluster = cluster
        elif now is not None:
            self.cluster = Cluster(now=now)
        else:
            self.cluster = Cluster()
        self.health = HealthManager()
        install_quota_webhooks(self.cluster)
        op_cfg = operator_config or OperatorConfig()
        calculator = ResourceCalculator(
            tpu_chip_memory_gb=op_cfg.tpu_chip_memory_gb,
            nvidia_gpu_memory_gb=op_cfg.nvidia_gpu_memory_gb,
        )
        self.quota_reconciler = QuotaReconciler(self.cluster, calculator)
        self.state = ClusterState()
        self.scheduler = build_scheduler(self.cluster, scheduler_config, now=now)
        self.partitioners = build_partitioner_controllers(
            self.cluster, self.state, self.scheduler, partitioner_config, now=now
        )
        p_cfg = partitioner_config or PartitionerConfig()
        from nos_tpu_torch.controllers.slice_group import GroupPartitioner, HostAgent

        # Gated on config.modes like every other partitioning mode; it runs
        # as a dedicated controller only because carving host groups has a
        # different shape (gang demand, slice-level barrier) than the
        # per-node planner.
        self.group_partitioner: Optional[GroupPartitioner] = None
        if constants.KIND_TPU_MULTIHOST in p_cfg.modes:
            self.group_partitioner = GroupPartitioner(
                self.cluster,
                batch_timeout_s=p_cfg.batch_window_timeout_s,
                batch_idle_s=p_cfg.batch_window_idle_s,
                unit_key=self.scheduler._unit_key,
                defrag_budget=p_cfg.defrag_budget,
                defrag_after_s=p_cfg.defrag_after_s,
                migration_hold_s=p_cfg.migration_hold_s,
                # The move drain is a checkpoint eviction: it shares the
                # checkpoint family's gain/pacing knobs so one churn policy
                # governs every evict-and-resume path.
                defrag_min_gain_s=p_cfg.checkpoint_min_gain_s,
                defrag_victim_cooldown_s=p_cfg.checkpoint_victim_cooldown_s,
                defrag_victim_budget=p_cfg.checkpoint_victim_budget,
                defrag_victim_window_s=p_cfg.checkpoint_victim_window_s,
                now=now,
            )
        self.host_agents: Dict[str, HostAgent] = {}
        self.agents: Dict[str, TpuAgent] = {}
        self.monitors: List[DeviceHealthMonitor] = []
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._agents_reconciled_version: Optional[int] = None
        self._ticks_since_agent_pass = 0
        self.health.add_healthz("cluster", lambda: None)
        self.health.add_readyz("state", lambda: None)

    def add_host_agent(self, node_name: str):
        """Member-host agent for a multi-host slice group."""
        from nos_tpu_torch.controllers.slice_group import HostAgent

        agent = HostAgent(self.cluster, node_name)
        agent.startup()
        agent.start_watching()
        self.host_agents[node_name] = agent
        return agent

    def add_tpu_agent(self, node_name: str, client=None, config=None) -> TpuAgent:
        agent = build_tpu_agent(self.cluster, node_name, config, client)
        agent.startup()
        agent.start_watching()
        monitor = DeviceHealthMonitor(self.cluster, node_name, agent.client)
        self.monitors.append(monitor)
        self.agents[node_name] = agent
        return agent

    def start(self) -> "ControlPlane":
        self.state.start_watching(self.cluster)
        self.quota_reconciler.start_watching()
        for controller in self.partitioners.values():
            controller.start_watching()
        if self.group_partitioner is not None:
            self.group_partitioner.start_watching()
        return self

    def tick(self) -> dict:
        """One synchronous control round (deterministic driving for tests and
        the single-process dev runtime)."""
        result = self.scheduler.schedule_pending()
        # Periodic reporter pass (reportConfigIntervalSeconds analog): keeps
        # status annotations in step with pod completions so the planner can
        # reshape freed slices. Gated on store changes: a report/reconcile
        # retry only ever has new work after some write (a pod completing, a
        # spec annotation landing), so an unchanged store version means every
        # agent pass would be a no-op — skip the O(agents) walk.
        version = self.cluster.version
        # Device-layer state (agent.client) can change without a store write
        # — a real tpulib backend losing a slice, say — so the gate alone
        # would let annotations go stale forever. Force a full pass every
        # AGENT_RESYNC_TICKS rounds (the reportConfigIntervalSeconds analog),
        # bounding staleness while keeping quiet ticks cheap.
        self._ticks_since_agent_pass += 1
        if (
            version != self._agents_reconciled_version
            or self._ticks_since_agent_pass >= self.AGENT_RESYNC_TICKS
        ):
            self._ticks_since_agent_pass = 0
            for agent in self.agents.values():
                agent.report()
            # Host agents re-reconcile too: an ack refused while a workload
            # was still running must retry after it completes (patch-free
            # when nothing changed).
            for host_agent in self.host_agents.values():
                host_agent.reconcile()
            # Stamp the PRE-pass version: a concurrent write landing during
            # the walk (e.g. a health monitor thread) must not be absorbed
            # into the stamp, or the agents would never process it. The
            # agents' own writes cost exactly one extra (patch-free) pass.
            self._agents_reconciled_version = version
        for controller in self.partitioners.values():
            if controller.process_batch_if_ready():
                metrics.inc("nos_tpu_partitioning_cycles", kind=controller.kind)
        if self.group_partitioner is not None and (
            self.group_partitioner.process_batch_if_ready()
        ):
            metrics.inc(
                "nos_tpu_partitioning_cycles", kind=constants.KIND_TPU_MULTIHOST
            )
        result_after = self.scheduler.schedule_pending()
        return {"first_pass": result, "second_pass": result_after}

    def run(self, interval_s: float = 1.0) -> None:
        """Threaded runtime: periodic scheduling + partitioning + monitors."""
        for monitor in self.monitors:
            monitor.start()

        def loop():
            while not self._stop.is_set():
                try:
                    self.tick()
                except Exception:  # noqa: BLE001
                    logger.exception("control plane tick failed")
                self._stop.wait(interval_s)

        t = threading.Thread(target=loop, daemon=True)
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for monitor in self.monitors:
            monitor.stop()
        for t in self._threads:
            t.join(timeout=5)


def build_gpu_agent(
    cluster: Cluster,
    node_name: str,
    mode: str,
    gpu_count: int,
    model: str = "NVIDIA-A100-PCIE-40GB",
    memory_gb: int = constants.DEFAULT_GPU_MEMORY_GB,
    with_fake_device_plugin: bool = True,
    pod_resources_socket: Optional[str] = None,
) -> GpuAgent:
    """MIG/MPS/hybrid node agent over the fake device layer (real
    NVML/CUDA-MPS backends would slot in behind the same client interface).
    Device identity is per mode — mig validates against `model`'s geometry
    menus, mps against the `memory_gb` budget, hybrid against both — and
    the selection lives HERE, once, so callers never special-case modes.
    By default a fake device-plugin DaemonSet (one per cluster bus) backs
    the post-apply plugin restart; pass with_fake_device_plugin=False when
    a real DaemonSet manages the plugin pods."""
    from nos_tpu_torch.gpu.device_plugin import DevicePluginClient, ensure_fake_daemonset

    if with_fake_device_plugin:
        ensure_fake_daemonset(cluster).ensure_pod(node_name)
    plugin_client = DevicePluginClient(cluster)
    lister = _pod_resources_lister(pod_resources_socket)
    if mode == constants.KIND_MIG:
        client = FakeGpuDeviceClient(gpu_count, mig_validator(model))
        return GpuAgent(
            cluster,
            node_name,
            client,
            plugin_client=plugin_client,
            pod_resources_lister=lister,
        )
    if mode == constants.KIND_HYBRID:
        # The node serves MIG and MPS slices simultaneously
        # (constants.KIND_HYBRID), so the agent validates both modes'
        # rules and maps both resource namespaces.
        from nos_tpu_torch.controllers.gpu_agent import (
            hybrid_parse_profile,
            hybrid_resource_of,
            hybrid_validator,
        )

        client = FakeGpuDeviceClient(
            gpu_count, hybrid_validator(model, int(memory_gb))
        )
        return GpuAgent(
            cluster,
            node_name,
            client,
            parse_profile=hybrid_parse_profile,
            resource_of=hybrid_resource_of,
            plugin_client=plugin_client,
            pod_resources_lister=lister,
        )
    client = FakeGpuDeviceClient(gpu_count, mps_validator(int(memory_gb)))
    return GpuAgent(
        cluster,
        node_name,
        client,
        parse_profile=MpsProfile.from_resource,
        resource_of=lambda p: f"{constants.RESOURCE_MPS_PREFIX}{p}",
        plugin_client=plugin_client,
        pod_resources_lister=lister,
    )
