"""Port of `nos_tpu/config.py:1` (:1-285): `ConfigError` (:23), `ManagerConfig`
(:28), `OperatorConfig` (:38), `PartitionerConfig` (:51), `AgentConfig`
(:127), `SchedulerConfig` (:144), `load_config` (:263). Copied verbatim;
only the imports point at the port, which imports nothing of the JAX
package.

Component configuration (the pkg/api/nos.nebuly.com/config/v1alpha1 analog).

Each binary takes a config file (YAML or JSON) deserialized into a component
config dataclass with validation — mirroring GpuPartitionerConfig
(gpu_partitioner_config.go:28-55: batch windows, known geometries file,
device-plugin CM/delay), OperatorConfig (operator_config.go:26-30) and the
agent configs (report interval). A common block carries the manager-level
settings (ControllerManagerConfigurationSpec analog).
"""

from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from nos_tpu_torch import constants


class ConfigError(ValueError):
    pass


@dataclass
class ManagerConfig:
    """Common manager settings (health/metrics endpoints, leader election)."""

    health_probe_port: int = 8081
    metrics_port: int = 8080
    leader_election: bool = False
    log_level: str = "INFO"


@dataclass
class OperatorConfig:
    manager: ManagerConfig = field(default_factory=ManagerConfig)
    # GB assumed per whole device for quota metering
    # (operator_config.go NvidiaGpuResourceMemoryGB analog).
    tpu_chip_memory_gb: float = constants.DEFAULT_TPU_CHIP_MEMORY_GB
    nvidia_gpu_memory_gb: float = constants.DEFAULT_GPU_MEMORY_GB

    def validate(self) -> None:
        if self.tpu_chip_memory_gb <= 0 or self.nvidia_gpu_memory_gb <= 0:
            raise ConfigError("device memory GB values must be positive")


@dataclass
class PartitionerConfig:
    manager: ManagerConfig = field(default_factory=ManagerConfig)
    batch_window_timeout_s: float = constants.DEFAULT_BATCH_WINDOW_TIMEOUT_S
    batch_window_idle_s: float = constants.DEFAULT_BATCH_WINDOW_IDLE_S
    modes: List[str] = field(default_factory=lambda: list(constants.PARTITIONING_KINDS))
    device_plugin_cm_name: str = constants.DEFAULT_DEVICE_PLUGIN_CM_NAME
    device_plugin_cm_namespace: str = constants.DEFAULT_DEVICE_PLUGIN_CM_NAMESPACE
    device_plugin_delay_s: float = constants.DEFAULT_DEVICE_PLUGIN_DELAY_S
    # Per-model MIG geometry overrides (knownMigGeometries analog):
    # {"NVIDIA-A100-PCIE-40GB": [{"1g.5gb": 7}, ...]}
    known_mig_geometries: Dict[str, List[Dict[str, int]]] = field(default_factory=dict)
    # Defragmentation: slice migrations the planner may schedule per plan
    # window once the add-only search saturates (0 disables — the
    # reference's behavior). Each migration drains one small mover into a
    # pre-created destination slice so the freed fragments coalesce for a
    # stranded pod; `migration_hold_s` bounds how long the destination
    # reservation survives a mover that never rebinds.
    defrag_budget: int = 0
    migration_hold_s: float = 120.0
    # A gang must have been stranded this long before defrag may move a
    # running workload for it — transient backlogs resolve by natural drains.
    defrag_after_s: float = 120.0
    # After a stranded pod waits this long, consolidation may drain a node of
    # ALL-checkpointable victims without the provable-rebind guarantee (they
    # resume from checkpoint). None disables; only fires for pods annotated
    # tpu.nos/checkpointable.
    checkpoint_preempt_after_s: Optional[float] = 120.0
    # Churn discipline on the checkpoint fallback: the drain must shorten the
    # preemptor's stamped natural wait by more than `min_gain`; no workload is
    # fallback-evicted twice within `cooldown` or more than `budget` times per
    # sliding `window`.
    checkpoint_min_gain_s: float = 60.0
    checkpoint_victim_cooldown_s: float = 300.0
    checkpoint_victim_budget: int = 3
    checkpoint_victim_window_s: float = 3600.0

    def validate(self) -> None:
        if self.batch_window_timeout_s <= 0:
            raise ConfigError("batch_window_timeout_s must be positive")
        if (
            self.checkpoint_preempt_after_s is not None
            and self.checkpoint_preempt_after_s < 0
        ):
            # 0 means "immediately eligible"; negative is a typo that would
            # also pin the resync age gate permanently open.
            raise ConfigError("checkpoint_preempt_after_s must be >= 0 or null")
        if self.defrag_budget < 0:
            raise ConfigError("defrag_budget must be >= 0")
        if self.migration_hold_s <= 0:
            raise ConfigError("migration_hold_s must be positive")
        if self.defrag_after_s < 0:
            raise ConfigError("defrag_after_s must be >= 0")
        if self.checkpoint_min_gain_s < 0:
            raise ConfigError("checkpoint_min_gain_s must be >= 0")
        if self.checkpoint_victim_cooldown_s < 0:
            raise ConfigError("checkpoint_victim_cooldown_s must be >= 0")
        if self.checkpoint_victim_budget < 1:
            raise ConfigError("checkpoint_victim_budget must be >= 1")
        if self.checkpoint_victim_window_s <= 0:
            raise ConfigError("checkpoint_victim_window_s must be positive")
        if not 0 < self.batch_window_idle_s <= self.batch_window_timeout_s:
            raise ConfigError(
                "batch_window_idle_s must be in (0, batch_window_timeout_s]"
            )
        unknown = set(self.modes) - set(constants.PARTITIONING_KINDS)
        if unknown:
            raise ConfigError(f"unknown partitioning modes: {sorted(unknown)}")

    def apply_mig_overrides(self) -> None:
        from nos_tpu_torch.gpu import mig

        for model, geometries in self.known_mig_geometries.items():
            mig.set_known_geometries(model, geometries)


@dataclass
class AgentConfig:
    manager: ManagerConfig = field(default_factory=ManagerConfig)
    node_name: str = ""  # defaults to $NODE_NAME
    report_interval_s: float = 10.0
    use_native_tpulib: bool = True
    # Permit real-chip discovery/health (tpulib/local.py). Activation
    # additionally requires the operator's explicit NOS_TPU_LOCAL_CHIPS
    # grant — visibility alone never activates it (libtpu is
    # single-process; see the chip-ownership contract in docs/tpulib.md).
    use_local_tpulib: bool = True

    def validate(self) -> None:
        if self.report_interval_s <= 0:
            raise ConfigError("report_interval_s must be positive")


@dataclass
class SchedulerConfig:
    manager: ManagerConfig = field(default_factory=ManagerConfig)
    scheduler_name: str = constants.SCHEDULER_NAME
    tpu_chip_memory_gb: float = constants.DEFAULT_TPU_CHIP_MEMORY_GB
    nvidia_gpu_memory_gb: float = constants.DEFAULT_GPU_MEMORY_GB
    # Drain-set backfill reservations (see scheduler.Scheduler): arm only
    # for units at least this fraction of the cluster's chips; None disables
    # arming entirely.
    backfill_min_fraction: Optional[float] = 0.9
    backfill_after_s: float = 30.0
    backfill_bypass_factor: float = 2.0
    # Queue ordering within a priority band: "fifo" (arrival order) or
    # "aged-swf" (shortest-work-first with an aging credit of
    # `swf_aging_chips` chip-seconds per pending second; unstamped pods
    # assume `swf_default_duration_s`). See scheduler.Scheduler.
    queue_policy: str = "fifo"
    swf_aging_chips: float = 16.0
    swf_default_duration_s: float = 600.0
    # Checkpoint-aware reservation drain (scheduler-side sibling of the
    # partitioner's fallback; same gates, shared churn-ledger semantics).
    checkpoint_preempt_after_s: Optional[float] = 120.0
    checkpoint_min_gain_s: float = 60.0
    checkpoint_victim_cooldown_s: float = 300.0
    checkpoint_victim_budget: int = 3
    checkpoint_victim_window_s: float = 3600.0
    # Versioned plugin-args documents (KubeSchedulerConfiguration
    # pluginConfig analog): each entry carries apiVersion/kind and decodes
    # through api/scheduler_args.py's scheme (defaulting + conversion into
    # the internal args type) — the reference's v1beta3
    # CapacitySchedulingArgs wire contract. Fields a document EXPLICITLY
    # sets override the flat memory knobs above; omitted fields leave them
    # alone (the flat knobs are the baseline, so v1beta3 defaulting must
    # not clobber an operator's explicit tpu_chip_memory_gb just because
    # the doc only mentioned the GPU one). Applied in __post_init__ so
    # programmatic construction and load_config behave identically;
    # validate() stays pure (decode-and-check only).
    plugin_config: List[dict] = field(default_factory=list)

    def __post_init__(self) -> None:
        from nos_tpu_torch.api.scheduler_args import (
            CapacitySchedulingArgsV1Beta3,
            PluginArgsError,
            decode_plugin_args,
        )

        for doc in self.plugin_config:
            try:
                internal = decode_plugin_args(doc)  # validates fully
                explicit = CapacitySchedulingArgsV1Beta3.from_doc(doc)
            except PluginArgsError as e:
                raise ConfigError(f"plugin_config: {e}") from e
            if explicit.tpu_chip_memory_gb is not None:
                self.tpu_chip_memory_gb = internal.tpu_chip_memory_gb
            if explicit.nvidia_gpu_resource_memory_gb is not None:
                self.nvidia_gpu_memory_gb = internal.nvidia_gpu_resource_memory_gb

    def validate(self) -> None:
        if not self.scheduler_name:
            raise ConfigError("scheduler_name must be non-empty")
        from nos_tpu_torch.api.scheduler_args import PluginArgsError, decode_plugin_args

        for doc in self.plugin_config:
            try:
                decode_plugin_args(doc)
            except PluginArgsError as e:
                raise ConfigError(f"plugin_config: {e}") from e
        if self.queue_policy not in ("fifo", "aged-swf"):
            raise ConfigError("queue_policy must be 'fifo' or 'aged-swf'")
        if self.swf_aging_chips < 0:
            raise ConfigError("swf_aging_chips must be >= 0")
        if self.swf_default_duration_s <= 0:
            raise ConfigError("swf_default_duration_s must be positive")
        if (
            self.checkpoint_preempt_after_s is not None
            and self.checkpoint_preempt_after_s < 0
        ):
            raise ConfigError("checkpoint_preempt_after_s must be >= 0 or null")
        if self.checkpoint_min_gain_s < 0:
            raise ConfigError("checkpoint_min_gain_s must be >= 0")
        if self.checkpoint_victim_cooldown_s < 0:
            raise ConfigError("checkpoint_victim_cooldown_s must be >= 0")
        if self.checkpoint_victim_budget < 1:
            raise ConfigError("checkpoint_victim_budget must be >= 1")
        if self.checkpoint_victim_window_s <= 0:
            raise ConfigError("checkpoint_victim_window_s must be positive")
        if self.backfill_min_fraction is not None and not (
            0.0 < self.backfill_min_fraction
        ):
            raise ConfigError("backfill_min_fraction must be positive")
        if self.backfill_after_s < 0:
            raise ConfigError("backfill_after_s must be >= 0")
        if self.backfill_bypass_factor <= 0:
            # A non-positive factor would arm on age alone — the time-based
            # arming the bypass gate exists to prevent.
            raise ConfigError("backfill_bypass_factor must be positive")


def _from_dict(cls, data: dict):
    """Build a (possibly nested) dataclass from a plain dict, rejecting
    unknown keys (config typos fail fast)."""
    if not dataclasses.is_dataclass(cls):
        return data
    # PEP 563 (`from __future__ import annotations`) makes f.type a string;
    # resolve real types so nested dataclasses recurse with validation.
    hints = typing.get_type_hints(cls)
    names = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(names)
    if unknown:
        raise ConfigError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    kwargs = {}
    for key, value in data.items():
        ftype = hints.get(key)
        if dataclasses.is_dataclass(ftype) and isinstance(value, dict):
            kwargs[key] = _from_dict(ftype, value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


def load_config(cls, path: Optional[str] = None):
    """Load a component config from a YAML/JSON file (None -> defaults)."""
    if path is None:
        cfg = cls()
    else:
        text = Path(path).read_text()
        data = None
        try:
            data = json.loads(text)
        except json.JSONDecodeError:
            try:
                import yaml  # type: ignore

                data = yaml.safe_load(text)
            except ImportError as e:
                raise ConfigError(
                    f"{path} is not JSON and pyyaml is unavailable"
                ) from e
        if not isinstance(data, dict):
            raise ConfigError(f"config file {path} must contain a mapping")
        cfg = _from_dict(cls, data)
    cfg.validate()
    return cfg
