"""The port's own copies of the constants its modules name.

Copied from `nos_tpu/constants.py` (the port imports nothing of the JAX
package): the control plane's wire protocol (the domain, resource names,
labels, annotations and their regexes, defaults, :14-175; the scheduler
name, node-agent environment, partitioning kinds and
`partitioning_label_values`, :576-611), the serving plane's wire
constants (replica identity, states,
health, roles and snapshot keys, the engine probe keys, the router's
policies, phases and store weight, :184-267, and the fleet event names,
:304-336), the KV pool dtypes (:421-423), the cost ledger's charge fields
and receipt statuses (:390-427), the tenant probe keys (:431-437), the
trace and flight-recorder event names (:450-531), the tick-phase
names (:537-562), the fleet monitor's pressure verdicts (:270-303), the
utilization plane's keys and waste taxonomy (:336-386) and the debug HTTP
paths (:564-574). The wire strings are the reference's, equal value for
value: a replica id, state or probe key spelled differently in the port
would not be the same protocol.
"""

from __future__ import annotations

import re

# ---------------------------------------------------------------------------
# Domain prefix for all labels/annotations owned by this framework.
# ---------------------------------------------------------------------------
DOMAIN = "tpu.nos"

# ---------------------------------------------------------------------------
# Resource names.
# ---------------------------------------------------------------------------
# Whole-chip TPU resource exposed by the TPU device plugin.
RESOURCE_TPU = "google.com/tpu"
# Fractional TPU sub-slice resources carved by the tpuagent, e.g.
# "google.com/tpu-2x2" (a 4-chip ICI-contiguous sub-slice of a larger mesh).
RESOURCE_TPU_SLICE_PREFIX = "google.com/tpu-"
RESOURCE_TPU_SLICE_REGEX = re.compile(r"^google\.com/tpu-(\d+x\d+(?:x\d+)?)$")

# NVIDIA parity modes (reference pkg/constant/constants.go resource regexes).
RESOURCE_NVIDIA_GPU = "nvidia.com/gpu"
RESOURCE_MIG_PREFIX = "nvidia.com/mig-"
RESOURCE_MIG_REGEX = re.compile(r"^nvidia\.com/mig-(\d+)g\.(\d+)gb$")
RESOURCE_MPS_PREFIX = "nvidia.com/gpu-"
RESOURCE_MPS_REGEX = re.compile(r"^nvidia\.com/gpu-(\d+)gb$")

# Synthetic resource injected into pod requests so Elastic Quotas can meter
# heterogeneous accelerator requests in a single unit. The reference used
# "nos.nebuly.com/gpu-memory" (pkg/gpu/util/resource.go:28-86); here the common
# unit is accelerator *memory GB* as well, covering TPU slices (HBM GB) and GPUs.
RESOURCE_ACCELERATOR_MEMORY = f"{DOMAIN}/accelerator-memory"

# Non-accelerator resources.
RESOURCE_CPU = "cpu"
RESOURCE_MEMORY = "memory"
RESOURCE_PODS = "pods"

# ---------------------------------------------------------------------------
# Labels (reference labels.go:19-24).
# ---------------------------------------------------------------------------
# Which partitioning mode a node participates in: "tpu" | "mig" | "mps".
LABEL_PARTITIONING = f"{DOMAIN}/partitioning"
# Quota capacity status stamped on running pods by the quota reconciler.
LABEL_CAPACITY = f"{DOMAIN}/capacity"
CAPACITY_IN_QUOTA = "in-quota"
CAPACITY_OVER_QUOTA = "over-quota"

# TPU node discovery labels (the GKE TPU analog of NVIDIA GFD labels,
# reference pkg/gpu/util.go:30-73).
LABEL_TPU_ACCELERATOR = "cloud.google.com/gke-tpu-accelerator"  # e.g. "tpu-v5-lite-podslice"
LABEL_TPU_TOPOLOGY = "cloud.google.com/gke-tpu-topology"        # e.g. "4x4"

# Multi-host podslice discovery: a slice group is the set of host nodes of
# one TPU pod (GKE: one multi-host node pool). The global mesh comes from the
# GKE topology label (identical on every member); each host owns one
# host-topology block of it at host-coord (in host-block units).
LABEL_TPU_SLICE = f"{DOMAIN}/slice"                   # slice-group id
LABEL_TPU_HOST_TOPOLOGY = f"{DOMAIN}/host-topology"   # e.g. "2x2" (v5e host)
LABEL_TPU_HOST_COORD = f"{DOMAIN}/host-coord"         # e.g. "3,2" (host units)
# Scheduling surface written by host agents after a carve is acknowledged:
# gang pods select their sub-slice by topology, the binder keeps one gang on
# one sub-slice id.
LABEL_TPU_SUBSLICE_ID = f"{DOMAIN}/subslice-id"
LABEL_TPU_SUBSLICE_TOPOLOGY = f"{DOMAIN}/subslice-topology"

# Gang scheduling (multi-host workloads: one pod per host, all-or-nothing).
LABEL_GANG = f"{DOMAIN}/gang"            # gang name, unique per namespace
LABEL_GANG_SIZE = f"{DOMAIN}/gang-size"  # expected member count
# Multislice workloads: the gang spans N same-topology sub-slices carved in
# N DIFFERENT slice groups — ICI inside each sub-slice, DCN between them
# (jax multislice). gang-size must be divisible by the count.
LABEL_MULTISLICE_COUNT = f"{DOMAIN}/multislice-count"

# NVIDIA GFD labels (kept verbatim for MIG/MPS parity modes).
LABEL_GPU_PRODUCT = "nvidia.com/gpu.product"
LABEL_GPU_COUNT = "nvidia.com/gpu.count"
LABEL_GPU_MEMORY = "nvidia.com/gpu.memory"
# NVIDIA device-plugin config selector label (MPS actuation channel,
# reference mps/partitioner.go:104-113).
LABEL_DEVICE_PLUGIN_CONFIG = "nvidia.com/device-plugin.config"

# ---------------------------------------------------------------------------
# Annotations — the spec/status protocol between planner and node agents
# (reference annotations.go:21-58). `dev` stands for any partitionable device:
# a TPU board's chip group index, or a GPU index.
#
#   spec:    tpu.nos/spec-dev-<index>-<profile> = <quantity>
#   status:  tpu.nos/status-dev-<index>-<profile>-<free|used> = <quantity>
#   plan id: tpu.nos/spec-partitioning-plan / tpu.nos/status-partitioning-plan
# ---------------------------------------------------------------------------
ANNOTATION_SPEC_PREFIX = f"{DOMAIN}/spec-dev-"
ANNOTATION_STATUS_PREFIX = f"{DOMAIN}/status-dev-"
ANNOTATION_SPEC_PLAN = f"{DOMAIN}/spec-partitioning-plan"
ANNOTATION_STATUS_PLAN = f"{DOMAIN}/status-partitioning-plan"
# Multi-host sub-slice assignment protocol (per host node). The planner
# assigns each member host to at most one carved sub-slice; the host agent
# acknowledges by mirroring spec -> status and flipping the scheduling labels.
ANNOTATION_SPEC_SUBSLICE_ID = f"{DOMAIN}/spec-subslice-id"
ANNOTATION_SPEC_SUBSLICE_TOPOLOGY = f"{DOMAIN}/spec-subslice-topology"
ANNOTATION_SPEC_SUBSLICE_ORIGIN = f"{DOMAIN}/spec-subslice-origin"  # chip units
ANNOTATION_STATUS_SUBSLICE_ID = f"{DOMAIN}/status-subslice-id"
ANNOTATION_STATUS_SUBSLICE_TOPOLOGY = f"{DOMAIN}/status-subslice-topology"
# Physical slice layout reported by the TPU node agent. ICI contiguity makes
# placement a *graph* constraint the planner must respect (it cannot re-carve
# around in-use slices without knowing where they sit) — unlike the reference,
# where NVML owns MIG placement and counts suffice (SURVEY.md §7 hard parts).
ANNOTATION_STATUS_LAYOUT = f"{DOMAIN}/status-slice-layout"

# Duration-aware backfill protocol (no reference analog — the reference
# schedules opaque pods with no temporal model; on a TPU mesh the all-large
# drain tails it tolerates idle whole pods, see docs/dynamic-partitioning.md):
# workloads MAY declare an expected runtime (Slurm-timelimit style); the
# scheduler stamps bind time and uses both to reserve capacity for the head
# blocked workload while letting provably-harmless smaller work backfill.
ANNOTATION_EXPECTED_DURATION = f"{DOMAIN}/expected-duration-seconds"
ANNOTATION_BOUND_AT = f"{DOMAIN}/bound-at"
# Declares that the workload checkpoints (e.g. orbax) and resumes after
# eviction: consolidation may preempt it WITHOUT the provable-rebind
# guarantee when a stranded pod has aged past the configured threshold —
# eviction costs a requeue, not lost work.
ANNOTATION_CHECKPOINTABLE = f"{DOMAIN}/checkpointable"
# In-flight slice-migration hold (move protocol, written by the partitioner
# controller on a migration's DESTINATION node): "<profile>:<count>[,...]".
# The node agents' delete ladders treat up to <count> free slices of each
# held profile as undeletable — delete-free-first extended to moves, so a
# replan racing the mover's rebind can't tear down the destination slice the
# drain already depends on. Cleared when the mover rebinds or the
# reservation expires.
ANNOTATION_MIGRATION_HOLD = f"{DOMAIN}/spec-migration-hold"

ANNOTATION_SPEC_REGEX = re.compile(
    rf"^{re.escape(ANNOTATION_SPEC_PREFIX)}(\d+)-(.+)$"
)
ANNOTATION_STATUS_REGEX = re.compile(
    rf"^{re.escape(ANNOTATION_STATUS_PREFIX)}(\d+)-(.+)-(free|used)$"
)

# ---------------------------------------------------------------------------
# Defaults (reference constants.go + config/v1alpha1 defaults).
# ---------------------------------------------------------------------------
# Default GPU memory (GB) assumed for a whole GPU when GFD labels are missing.
DEFAULT_GPU_MEMORY_GB = 16
# Default HBM per TPU chip generation, GB (v5e = 16, v4 = 32, v5p = 95).
TPU_CHIP_MEMORY_GB = {"v4": 32, "v5e": 16, "v5p": 95, "v6e": 32}
DEFAULT_TPU_CHIP_MEMORY_GB = 16

# Pod batching windows for the partitioner controller
# (reference gpu_partitioner_config.go:33-34 defaults).
DEFAULT_BATCH_WINDOW_TIMEOUT_S = 60.0
DEFAULT_BATCH_WINDOW_IDLE_S = 10.0
# Periodic re-plan while pods stay pending (the reference's RequeueAfter=10s,
# partitioner_controller.go:118-122).
DEFAULT_PARTITIONER_RESYNC_S = 10.0
# Requeue delay while waiting for nodes to report the last plan
# (reference partitioner_controller.go:118-122).
PLAN_REPORT_REQUEUE_S = 10.0

# Device-plugin ConfigMap defaults (MPS mode; reference constants.go).
DEFAULT_DEVICE_PLUGIN_CM_NAME = "nvidia-device-plugin-configs"
DEFAULT_DEVICE_PLUGIN_CM_NAMESPACE = "kube-system"
DEFAULT_DEVICE_PLUGIN_DELAY_S = 5.0
# Device-plugin DaemonSet pod identification + restart poll bounds
# (reference gpu/client.go:37-132).
DEVICE_PLUGIN_POD_LABEL = "name"
DEVICE_PLUGIN_POD_LABEL_VALUE = "nvidia-device-plugin-ds"
DEFAULT_DEVICE_PLUGIN_RESTART_TIMEOUT_S = 60.0


# Cluster serving plane (serving/replica.py, router.py, drain.py,
# supervisor.py). Replica identity: "<prefix><ordinal>", assigned by the
# ReplicaSet.
REPLICA_ID_PREFIX = "replica-"
# Replica lifecycle (create -> drain -> delete): a DRAINING replica stops
# admitting, its in-flight work is re-homed, then it RETIRES.
REPLICA_STATE_ACTIVE = "active"
REPLICA_STATE_DRAINING = "draining"
REPLICA_STATE_RETIRED = "retired"
REPLICA_STATES = (
    REPLICA_STATE_ACTIVE,
    REPLICA_STATE_DRAINING,
    REPLICA_STATE_RETIRED,
)
# Replica health (the supervisor's axis beside the lifecycle): active ->
# suspect (consecutive probe failures) -> dead (failover fires); suspect
# -> active only after a full healthy window. Suspect and dead replicas
# are excluded from placement.
REPLICA_HEALTH_ACTIVE = "active"
REPLICA_HEALTH_SUSPECT = "suspect"
REPLICA_HEALTH_DEAD = "dead"
REPLICA_HEALTH_STATES = (
    REPLICA_HEALTH_ACTIVE,
    REPLICA_HEALTH_SUSPECT,
    REPLICA_HEALTH_DEAD,
)
# Replica roles: which phase of work placement sends a replica (a
# preference, not a capability limit: every engine runs both phases).
REPLICA_ROLE_PREFILL = "prefill"
REPLICA_ROLE_DECODE = "decode"
REPLICA_ROLE_UNIFIED = "unified"
REPLICA_ROLES = (
    REPLICA_ROLE_PREFILL,
    REPLICA_ROLE_DECODE,
    REPLICA_ROLE_UNIFIED,
)
# Router placement phases (PrefixRouter.select(phase=...); None = any).
ROUTER_PHASE_PREFILL = "prefill"
ROUTER_PHASE_DECODE = "decode"
ROUTER_PHASES = (ROUTER_PHASE_PREFILL, ROUTER_PHASE_DECODE)
# Replica snapshot keys (ReplicaHandle.snapshot() / fleet telemetry rows).
REPLICA_KEY_ID = "replica_id"
REPLICA_KEY_STATE = "state"
REPLICA_KEY_HEALTH = "health"
REPLICA_KEY_SHADOW_KEYS = "shadow_keys"
REPLICA_KEY_ROUTED_REQUESTS = "routed_requests"
REPLICA_KEY_ROLE = "role"
# Engine load-probe keys (DecodeServer.probe() -> router scoring): load,
# the tensor-parallel width, and slot and pool capacity.
PROBE_KEY_ACTIVE_SLOTS = "active_slots"
PROBE_KEY_QUEUED_REQUESTS = "queued_requests"
PROBE_KEY_PREFILL_BACKLOG = "prefill_backlog_tokens"
PROBE_KEY_DRAINING = "draining"
PROBE_KEY_TP_DEVICES = "tp_devices"
PROBE_KEY_SLOTS_TOTAL = "slots_total"
PROBE_KEY_KV_BLOCKS_TOTAL = "kv_blocks_total"
# Router placement policies (PrefixRouter).
ROUTER_POLICY_PREFIX = "prefix"
ROUTER_POLICY_ROUND_ROBIN = "round_robin"
ROUTER_POLICIES = (ROUTER_POLICY_PREFIX, ROUTER_POLICY_ROUND_ROBIN)
# The value of one fleet-store hit token relative to a device-resident hit
# token (1.0): strictly between 0 and 1, so a store hit beats recompute and
# a device hit beats a store hit, the engine's own cost order.
ROUTER_STORE_HIT_WEIGHT = 0.5

# Fleet event names: the fleet monitor's journal and SLO events, the
# supervisor's failure-domain events and the handoff events.
FLEET_EV_WINDOW = "fleet.window"
FLEET_EV_FREEZE = "fleet.freeze"
SLO_EV_BREACH = "slo.breach"
SLO_EV_RECOVER = "slo.recover"
FLEET_EV_UNREACHABLE = "fleet.unreachable"  # a probe raised/timed out
FLEET_EV_SUSPECT = "fleet.suspect"          # health active -> suspect
FLEET_EV_RECOVERED = "fleet.recovered"      # health suspect -> active
FLEET_EV_DEATH = "fleet.death"              # health -> dead, failover fires
FLEET_EV_FAILOVER = "fleet.failover"        # one stream re-homed/resolved
FLEET_EV_HANDOFF = "fleet.handoff"
FLEET_EV_HANDOFF_REROUTE = "fleet.handoff_reroute"
FLEET_EV_HANDOFF_FAILED = "fleet.handoff_failed"
FLEET_EVENTS = (
    FLEET_EV_WINDOW,
    FLEET_EV_FREEZE,
    SLO_EV_BREACH,
    SLO_EV_RECOVER,
    FLEET_EV_UNREACHABLE,
    FLEET_EV_SUSPECT,
    FLEET_EV_RECOVERED,
    FLEET_EV_DEATH,
    FLEET_EV_FAILOVER,
    FLEET_EV_HANDOFF,
    FLEET_EV_HANDOFF_REROUTE,
    FLEET_EV_HANDOFF_FAILED,
)

# Paged-KV pool storage dtypes. "fp16" names the NATIVE tier: the pool
# stores the config's dtype as it is (an f32 config stays f32). "int8"
# stores one signed byte per element plus one f32 scale per (block, layer,
# k|v).
KV_DTYPE_NATIVE = "fp16"
KV_DTYPE_INT8 = "int8"
KV_DTYPES = (KV_DTYPE_NATIVE, KV_DTYPE_INT8)

# CostLedger charge fields (serving/accounting.py): what a request and its
# tenant are billed, at the engine's bookkeeping sites.
COST_SLOT_SECONDS = "slot_seconds"              # decode-slot hold time
COST_CHIP_MS = "chip_ms"                        # slot_seconds x tp/n_slots
COST_DECODE_TOKENS = "decode_tokens"            # generated tokens
COST_PREFILL_CHARGED = "prefill_tokens_charged"  # prompt tokens computed
COST_PREFILL_CACHED = "prefill_tokens_cached"    # prompt tokens served from cache
COST_KV_BLOCK_TICKS = "kv_block_ticks"          # pool-block x tick products
# An int8 pool's residency bills under its own field: an int8 block-tick
# holds about half the device bytes of a native one.
COST_KV_BLOCK_TICKS_INT8 = "kv_block_ticks_int8"
COST_SPILL_BYTES = "spill_bytes"                # spill/revive bytes moved
COST_REPLAY_TOKENS = "replay_tokens"            # recovery replay
COST_FIELDS = (
    COST_SLOT_SECONDS,
    COST_CHIP_MS,
    COST_DECODE_TOKENS,
    COST_PREFILL_CHARGED,
    COST_PREFILL_CACHED,
    COST_KV_BLOCK_TICKS,
    COST_KV_BLOCK_TICKS_INT8,
    COST_SPILL_BYTES,
    COST_REPLAY_TOKENS,
)
# Receipt status vocabulary (the req.finish/failure terminus).
RECEIPT_STATUS_OK = "ok"
RECEIPT_STATUS_FAILED = "failed"
RECEIPT_STATUSES = (RECEIPT_STATUS_OK, RECEIPT_STATUS_FAILED)

# Per-tenant probe keys (DecodeServer.tenant_probe()).
TENANT_KEY_TOKENS = "tokens"            # cumulative decode tokens produced
TENANT_KEY_ADMISSIONS = "admissions"    # cumulative slot reservations
TENANT_KEY_WAITING = "waiting"          # requests queued/waiting right now
TENANT_KEY_USAGE = "usage"              # QuotaPolicy windowed share (0.0-1.0)
TENANT_KEY_MIN_SHARE = "min_share"      # guaranteed share (0.0 = best effort)
TENANT_KEY_QUOTA_STARVED = "quota_starved"      # QuotaPolicy.is_starved
TENANT_KEY_QUOTA_BORROWER = "quota_borrower"    # QuotaPolicy.is_borrower

# Trace identity: "<prefix><counter>", assigned by tracing.Tracer.
TRACE_ID_PREFIX = "tr-"

# Request-lifecycle event names (one trace per request; the id rides the
# request, the slot and SlotCheckpoint, so a restored or preempted stream
# keeps one trace).
TRACE_EV_ROUTER_SELECT = "router.select"
TRACE_EV_SUBMIT = "req.submit"
TRACE_EV_RESERVED = "req.reserved"
TRACE_EV_PREFILL_CHUNK = "req.prefill_chunk"
TRACE_EV_FIRST_TOKEN = "req.first_token"
TRACE_EV_DECODE = "req.decode"
TRACE_EV_FINISH = "req.finish"
# Exceptional edges.
TRACE_EV_PREEMPT = "req.preempt"
TRACE_EV_SPILL = "req.spill"
TRACE_EV_REVIVE = "req.revive"
TRACE_EV_RESTORE = "req.restore"
TRACE_EV_DRAIN_MIGRATE = "req.drain_migrate"
TRACE_EV_FAILOVER = "req.failover"
TRACE_EV_HANDOFF = "req.handoff"
TRACE_EV_COW = "req.cow"
TRACE_EVENTS = (
    TRACE_EV_ROUTER_SELECT,
    TRACE_EV_SUBMIT,
    TRACE_EV_RESERVED,
    TRACE_EV_PREFILL_CHUNK,
    TRACE_EV_FIRST_TOKEN,
    TRACE_EV_DECODE,
    TRACE_EV_FINISH,
    TRACE_EV_PREEMPT,
    TRACE_EV_SPILL,
    TRACE_EV_REVIVE,
    TRACE_EV_RESTORE,
    TRACE_EV_DRAIN_MIGRATE,
    TRACE_EV_FAILOVER,
    TRACE_EV_HANDOFF,
    TRACE_EV_COW,
)

# Engine flight-recorder event names (bounded per-engine ring; payloads
# are counts and ids only). The BlockManager records spill and evict.
FLIGHT_EV_ADMIT = "engine.admit"
FLIGHT_EV_BURST = "engine.dispatch_burst"
FLIGHT_EV_PREFILL_WAVE = "engine.prefill_wave"
FLIGHT_EV_MACRO = "engine.dispatch_macro"
FLIGHT_EV_VERIFY = "engine.dispatch_verify"
FLIGHT_EV_RESOLVE = "engine.resolve"
FLIGHT_EV_FINISH = "engine.finish"
FLIGHT_EV_RECOVERY = "engine.recovery"
FLIGHT_EV_TRANSIENT_RETRY = "engine.transient_retry"
FLIGHT_EV_FAIL_ALL = "engine.fail_all"
FLIGHT_EV_PREEMPT = "engine.preempt"
FLIGHT_EV_SPILL = "engine.spill"
FLIGHT_EV_EVICT = "engine.evict"
FLIGHT_EV_REVIVE = "engine.revive"
FLIGHT_EV_COW = "engine.cow"
FLIGHT_EVENTS = (
    FLIGHT_EV_ADMIT,
    FLIGHT_EV_BURST,
    FLIGHT_EV_PREFILL_WAVE,
    FLIGHT_EV_MACRO,
    FLIGHT_EV_VERIFY,
    FLIGHT_EV_RESOLVE,
    FLIGHT_EV_FINISH,
    FLIGHT_EV_RECOVERY,
    FLIGHT_EV_TRANSIENT_RETRY,
    FLIGHT_EV_FAIL_ALL,
    FLIGHT_EV_PREEMPT,
    FLIGHT_EV_SPILL,
    FLIGHT_EV_EVICT,
    FLIGHT_EV_REVIVE,
    FLIGHT_EV_COW,
)

# Tick phases of the engine (tracing.TickProfiler): the keys of
# DecodeServer.tick_phase_s and labels of the tick-phase histogram
# (exclusive times, a nested phase's time counts only under its own name).
TICK_PHASE_QUOTA_ENFORCE = "quota_enforce"
TICK_PHASE_ADMIT = "admit"
TICK_PHASE_RESOLVE = "resolve"
TICK_PHASE_EOS_SCAN = "eos_scan"
TICK_PHASE_PUMP_REVIVES = "pump_revives"
TICK_PHASE_PUMP_PREFILL = "pump_prefill"
TICK_PHASE_DISPATCH_VERIFY = "dispatch_verify"
TICK_PHASE_DISPATCH_MACRO = "dispatch_macro"
TICK_PHASE_DISPATCH_BURST = "dispatch_burst"
TICK_PHASE_SAMPLE_SCATTER = "sample_scatter"
TICK_PHASE_PUBLISH = "publish"
TICK_PHASE_IDLE = "idle"
TICK_PHASES = (
    TICK_PHASE_QUOTA_ENFORCE,
    TICK_PHASE_ADMIT,
    TICK_PHASE_RESOLVE,
    TICK_PHASE_EOS_SCAN,
    TICK_PHASE_PUMP_REVIVES,
    TICK_PHASE_PUMP_PREFILL,
    TICK_PHASE_DISPATCH_VERIFY,
    TICK_PHASE_DISPATCH_MACRO,
    TICK_PHASE_DISPATCH_BURST,
    TICK_PHASE_SAMPLE_SCATTER,
    TICK_PHASE_PUBLISH,
    TICK_PHASE_IDLE,
)

# The fleet pressure plane (serving/monitor.py): the verdict strings of
# PressureReport, the /debug/pressure payload and the metrics journal.
# Per-replica verdicts; UNREACHABLE: a probe raised or timed out this
# window, so the replica's capacity is unknown (never counted as headroom).
PRESSURE_REPLICA_HOT = "hot"          # saturated AND work is waiting
PRESSURE_REPLICA_OK = "ok"            # serving within capacity
PRESSURE_REPLICA_IDLE = "idle"        # no slots, no queue, no tokens
PRESSURE_REPLICA_DRAINING = "draining"  # lifecycle: not admitting
PRESSURE_REPLICA_UNREACHABLE = "unreachable"
PRESSURE_REPLICA_STATES = (
    PRESSURE_REPLICA_HOT,
    PRESSURE_REPLICA_OK,
    PRESSURE_REPLICA_IDLE,
    PRESSURE_REPLICA_DRAINING,
    PRESSURE_REPLICA_UNREACHABLE,
)
# Per-tenant verdicts.
PRESSURE_TENANT_STARVED = "starved"      # under its guarantee with work waiting
PRESSURE_TENANT_BORROWING = "borrowing"  # running above its guarantee
PRESSURE_TENANT_WITHIN = "within"        # inside its share (or no quota)
PRESSURE_TENANT_STATES = (
    PRESSURE_TENANT_STARVED,
    PRESSURE_TENANT_BORROWING,
    PRESSURE_TENANT_WITHIN,
)

# The utilization plane (serving/accounting.py's fleet half). Duty-cycle
# inputs journaled on each replica window row: deltas of the engine's
# profiler and recovery counters over the window, seconds per engine (the
# decomposition scales them by tp_devices).
ACCT_KEY_DISPATCH_S = "dispatch_s"          # wall inside device calls
ACCT_KEY_HOST_S = "host_overhead_s"         # tick wall minus dispatch
ACCT_KEY_TICK_WALL_S = "tick_wall_s"        # profiled tick wall
ACCT_KEY_IDLE_S = "idle_s"                  # idle tick-phase wall
ACCT_KEY_REVIVE_S = "revive_pump_s"         # spill-revive pump phase wall
ACCT_KEY_RESTORE_S = "restore_s"            # restore-latency sample sum
ACCT_KEY_KV_BLOCK_TICKS = "kv_block_ticks"  # sum over ticks of blocks held
# The decomposition attached to the row (`accounting.duty_cycle`, pure
# over the inputs above).
ACCT_KEY_DUTY = "duty"
ACCT_KEY_WALL_CHIP_S = "wall_chip_s"
ACCT_KEY_BUSY_CHIP_S = "busy_chip_s"
ACCT_KEY_OVERHEAD_CHIP_S = "overhead_chip_s"
ACCT_KEY_WASTE_CHIP_S = "waste_chip_s"
ACCT_KEY_WASTE = "waste"
# Fleet roll-up fields (PressureReport, `utilization_block`).
ACCT_KEY_CHIP_SECONDS = "chip_seconds"
ACCT_KEY_CHIP_HOURS = "chip_hours"
ACCT_KEY_TOK_S_PER_CHIP_HOUR = "tok_s_per_chip_hour"
ACCT_KEY_WASTE_FRACTION = "waste_fraction"
# The named waste taxonomy: where the rest of the chip-seconds went.
WASTE_IDLE = "waste.idle"                  # nothing to do (incl. unmeasured slack)
WASTE_DRAINING = "waste.draining"          # capacity leaving the fleet
WASTE_UNREACHABLE = "waste.unreachable"    # suspect/unreachable window
WASTE_RECOVERY = "waste.recovery"          # restore/replay host time
WASTE_SPILL_REVIVE = "waste.spill_revive"  # spill/revive copy traffic
WASTE_CAUSES = (
    WASTE_IDLE,
    WASTE_DRAINING,
    WASTE_UNREACHABLE,
    WASTE_RECOVERY,
    WASTE_SPILL_REVIVE,
)

# The debug HTTP surface (observability.ObservabilityServer).
DEBUG_PATH_EVENTS = "/debug/events"
DEBUG_PATH_TRACE_PREFIX = "/debug/trace/"
DEBUG_PATH_PRESSURE = "/debug/pressure"
# Per-tenant cost roll-up and receipts (serving/accounting.py CostLedger).
DEBUG_PATH_ACCOUNTING = "/debug/accounting"
# The index: a JSON list of the armed debug surfaces above (404 when none
# is armed, bearer-guarded like each of them).
DEBUG_PATH_INDEX = "/debug"
# The Prometheus text exposition format version scrapers negotiate on.
METRICS_CONTENT_TYPE = "text/plain; version=0.0.4"

# Scheduler name used by pods that want quota-aware scheduling.
SCHEDULER_NAME = "nos-tpu-scheduler"

# Env var node agents use to learn their node (reference constant.EnvVarNodeName).
ENV_NODE_NAME = "NODE_NAME"

# Explicit operator grant of the host's chips to the agent process
# (tpulib/local.py chip-ownership contract): libtpu is single-process, so
# the agent must never seize the chips merely because they are visible —
# the chart sets this alongside the google.com/tpu resource request.
ENV_LOCAL_CHIPS = "NOS_TPU_LOCAL_CHIPS"

# Partitioning kinds.
KIND_TPU = "tpu"
# Multi-host podslice mode: nodes are member hosts of a slice group; carving
# assigns host blocks, not local chips.
KIND_TPU_MULTIHOST = "tpu-multihost"
KIND_MIG = "mig"
KIND_MPS = "mps"
# A hybrid node is eligible for BOTH GPU modes at once (reference
# pkg/gpu/partitioning.go:75 declares the kind; its IsMig/IsMps helpers
# :79-95 never match it, leaving it inert upstream — here the name's
# promised semantics are completed: both snapshot takers see hybrid nodes,
# and each mode's partitioner rewrites only its own profiles' spec
# annotations so the two plans coexist on one node).
KIND_HYBRID = "hybrid"
PARTITIONING_KINDS = (KIND_TPU, KIND_TPU_MULTIHOST, KIND_MIG, KIND_MPS, KIND_HYBRID)


def partitioning_label_values(kind: str) -> tuple:
    """Label values that enable a node for `kind`: the kind itself, plus
    `hybrid` for the GPU modes (partitioning.go:66-120 GetPartitioningKind
    validates hybrid as a kind; mig/mps are the modes it composes)."""
    if kind in (KIND_MIG, KIND_MPS):
        return (kind, KIND_HYBRID)
    return (kind,)
