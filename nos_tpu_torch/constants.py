"""The port's own copies of the constants its modules name.

Copied from `nos_tpu/constants.py` (the port imports nothing of the JAX
package): the KV pool dtypes (:421-423), the cost ledger's charge fields
and receipt statuses (:390-427), the tenant probe keys (:431-437), the
trace and flight-recorder event names (:450-531) and the tick-phase
names (:537-562).
"""

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
