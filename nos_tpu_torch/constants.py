"""The port's own copies of the constants its modules name.

Copied from `nos_tpu/constants.py` (the port imports nothing of the JAX
package): the KV pool dtypes (:421-423), the tick-phase names the engine
times its phases under (:537-548), and the flight-recorder event
names `runtime/block_manager.py` records (:512-513).
"""

# Paged-KV pool storage dtypes. "fp16" names the NATIVE tier: the pool
# stores the config's dtype as it is (an f32 config stays f32). "int8"
# stores one signed byte per element plus one f32 scale per (block, layer,
# k|v).
KV_DTYPE_NATIVE = "fp16"
KV_DTYPE_INT8 = "int8"
KV_DTYPES = (KV_DTYPE_NATIVE, KV_DTYPE_INT8)

# Flight-recorder events the BlockManager emits when a recorder is attached.
FLIGHT_EV_SPILL = "engine.spill"
FLIGHT_EV_EVICT = "engine.evict"

# Tick phases of the engine (DecodeServer.tick_phase_s keys; exclusive
# times, a nested phase's time counts only under its own name).
TICK_PHASE_ADMIT = "admit"
TICK_PHASE_RESOLVE = "resolve"
TICK_PHASE_EOS_SCAN = "eos_scan"
TICK_PHASE_PUMP_REVIVES = "pump_revives"
TICK_PHASE_PUMP_PREFILL = "pump_prefill"
TICK_PHASE_DISPATCH_VERIFY = "dispatch_verify"
TICK_PHASE_DISPATCH_MACRO = "dispatch_macro"
TICK_PHASE_DISPATCH_BURST = "dispatch_burst"
TICK_PHASE_SAMPLE_SCATTER = "sample_scatter"
TICK_PHASE_IDLE = "idle"
TICK_PHASES = (
    TICK_PHASE_ADMIT,
    TICK_PHASE_RESOLVE,
    TICK_PHASE_EOS_SCAN,
    TICK_PHASE_PUMP_REVIVES,
    TICK_PHASE_PUMP_PREFILL,
    TICK_PHASE_DISPATCH_VERIFY,
    TICK_PHASE_DISPATCH_MACRO,
    TICK_PHASE_DISPATCH_BURST,
    TICK_PHASE_SAMPLE_SCATTER,
    TICK_PHASE_IDLE,
)
