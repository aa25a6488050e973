"""The port's own copies of the constants its modules name.

Copied from `nos_tpu/constants.py` (the port imports nothing of the JAX
package): the serving plane's wire constants (replica identity, states,
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
