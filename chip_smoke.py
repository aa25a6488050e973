#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path (the paged engine and the
dense decode programs), its training step, the ViT detector behind
SliceServer, the mesh trainers, the measurement layer (runtime/mfu.py),
the control plane's first layer (api/, cluster/), its device layer
(tpu/, util/, tpulib/ with the native tpuslice shim, and the mesh a node's
sub-slice label becomes), its partitioning plane (partitioning/,
controllers/, gpu/), its scheduler, wiring, simulator and CLI
(scheduler/, config.py, system.py, sim.py, sim_oracle.py, cli.py) and its
static-analysis suite (analysis/, `cli lint`), and the repository's entry
points outside the package (examples/end_to_end_torch.py,
examples/sharing-comparison/run_local_torch.py) on one NVIDIA GPU's
machine and check them.

    python3 chip_smoke.py                 # every phase; needs one CUDA device
    python3 chip_smoke.py --phases build,card,kernels,dense
    python3 chip_smoke.py --phases build,card,experts
    python3 chip_smoke.py --phases build,card,graph
    python3 chip_smoke.py --phases build,card,radix,spec
    python3 chip_smoke.py --phases build,card,quant
    python3 chip_smoke.py --phases build,card,faults
    python3 chip_smoke.py --phases build,card,quota,trace
    python3 chip_smoke.py --phases build,card,fleet
    python3 chip_smoke.py --phases build,card,disagg
    python3 chip_smoke.py --phases build,card,vit,mesh
    python3 chip_smoke.py --phases build,card,train,vit,control
    python3 chip_smoke.py --phases build,card,topology
    python3 chip_smoke.py --phases build,card,topology,partition
    python3 chip_smoke.py --phases build,card,topology,partition,schedule
    python3 chip_smoke.py --phases build,card,lint
    python3 chip_smoke.py --phases build,card,examples
    python3 chip_smoke.py --rehearse      # tiny models on the CPU, plain versions

Phases, in order (any failure exits non-zero; nothing is caught and passed over):

  build    builds every kernel of `nos_tpu_torch/ops/csrc/` with nvcc (one
           process per source, started together) and prints ptxas' report,
           one line per entry function (registers, stack frame, spills);
  card     prints `nvidia-smi --query-gpu=name,power.limit`;
  kernels  holds each kernel against its plain PyTorch version on the card.
           Paged kernels at the serving shapes (B=8, nh=8, nkv=2, hd=64,
           bs=32): contexts 1, 31, 32, 33, 2048 and 8192, the split decode
           kernel's boundaries (kSplitKeys - 1, kSplitKeys, + 1, twice and
           three times it; `split_limits`), windows of 16 and
           256 with ragged lengths, masked lanes and shared pages, pools in
           f32, bf16 and int8 with scales (max|err| <= 1e-4 for f32, 5e-3 for
           bf16 and 2e-2 for int8, and <= 2e-2 of max|want| for bf16 and
           int8). Flash kernels (forward o and lse, dq, dk/dv) at the training
           shape [8, 8, 2048, 256] bf16 causal, at head_dim 64 and 128, T
           177 and 1000, non-causal and f32, and at head_dim 16, 32 and 96
           (zero-padded to 64 or 128 by the entry points) in both dtypes,
           causal and not, T 177, 1000 and 300 (each entry's error against its
           own size and its row's, flash_err <= FLASH_TOL, a bound for each
           output; planted faults at the training shape must fail those
           bounds). The dense decode kernel at the bench GPT's heads over a
           cache of 8192 with limits 0, 1, 31-33, 1000, 2048, 8191, 8192,
           9000 and the split boundaries, MHA at head_dim 128 and 256, and
           rep 2 over three KV heads,
           f32 and bf16 (flash_err <= DECODE_TOL; planted faults must fail
           it). Times each kernel, its plain version and the library call
           (scaled_dot_product_attention: on the pre-gathered cache for the
           paged kernels; causal forward, backward and the pair for the
           flash kernels; with enable_gqa and a mask on the dense cache for
           the dense kernel) at the main path's shapes, and for the decode
           kernels and their SDPA calls also the device time alone
           (`device_ms`, torch.profiler);
  experts  the Mellum2-12B-A2.5B cell's kernels at its shapes: the expert
           chain (ops/moe.py) at 48 and 2048 rows of hidden 2304, 64
           experts of 896, top 8, with masked rows, against its plain
           version (max|err| <= EXPERT_RTOL x max|want|, tallies equal, two
           calls equal bit for bit; a dropped and a skipped expert planted
           must fail the bound); the split decode and window kernels with a
           1024-key window at 32 query heads over 4 KV heads of 128, 48
           lanes up to 13312 keys with bounds on, just off and below a page
           boundary and a wave of 2048-row chunks, against their plain
           versions within `held`'s bf16 bounds (the unbounded read must fail
           them; window 0 is the unbounded kernel bit for bit). Then a small
           Mellum layout served by DecodeServer with its graphs, bursts and
           multi-slot waves, its launch counts zeroed just before the
           traffic: every kernel's launches equal the host's count of
           programs (K steps a window replay, one per chunk and wave) times
           the layers, the expert tallies the exact rows, and every served
           token within 0.3 of the reference's best logit;
  engine   serves the bench GPT (vocab 32000, hidden 512, 8 layers, 8 heads, 2
           KV heads) with random weights from init_gpt(seed 0) in bf16, 8 slots,
           max_len 8192, a prefill budget of two 256-token chunks per tick: six
           streams (prompts of 64-256 tokens, 128 new) and two 4096-token
           prompts arriving together while they decode, whose chunks batch
           through the multi-slot prefill window. The engine runs its
           defaults: fused bursts of up to 4 windows, every 16-step
           window a replay of the CUDA graph the constructor captured
           (check_replays: graph_replays equals the windows run, some of
           them in bursts), and every batch-1 prompt chunk a replay of its
           bucket's graph (no eager chunk). The launch counts (replays included) are zeroed
           just before that run and read just after; then every output is
           checked against a teacher-forced greedy pass of the plain programs
           on the card (see check_logits for the bounds), and the run repeats
           in float32, where the strict agreement must be 1.0. A profiler
           window over 16 eager decode steps reports host and device time
           per step;
  graph    the engine's captured window. From one engine state at the serving
           shape (8 lanes at MAIN_DECODE_LIMITS, K 16), bf16 and f32: the
           replay against the eager `_macro`, equal tokens, state and pool
           pages byte for byte, equal launches. In bf16, one replayed and one
           eager window under torch.profiler and by CUDA events. Then the
           engine phase's traffic with burst_windows 1, 4, 4, 1: tok/s,
           long-prompt TTFT and the dispatch and replay counters;
  tp       tensor-parallel serving. The sharded paged kernels over two shards
           (4 query heads and 1 KV head each) at the serving shapes, f32 and
           bf16: each shard's output equals the unsharded kernel's on its
           heads bit for bit, and the gathered output is held against the
           plain version; their times against the plain version per shard and
           SDPA per shard. Then the engine phase's model, settings and traffic
           at tp=2 over build_mesh({"tp": 2}, devices=[cuda:0, cuda:0]) and at
           tp=1, both driven tick by tick on this thread so that they run one
           schedule, in bf16 (the main path) and f32: f32 tokens of tp=2 equal
           tp=1's; bf16 teacher-forced logits of the tp=2 programs against
           tp=1's within check_logits' bounds; every dispatch, upload, sync,
           burst and replay counter equal (both widths capture their whole
           window, both shards in one graph); each paged kernel launched
           exactly twice its tp=1 count through the sharded entry points.
           Prints tok/s, long-prompt TTFT, peak memory and a profiled decode
           window at both widths, and the bf16 traffic again at both widths
           with burst_windows=1;
  radix    the radix cache and the spill tier: the bench GPT (bf16, then f32)
           serves a multi-turn chat (8 conversations over two 2048-token
           system prompts, greetings diverging mid-block, 3 turns of
           200-token messages and 128 new tokens) in four arms: the radix
           tree, the flat chain, cold, and the tree over a pool that spills
           to the host tier. Each arm against a teacher-forced plain pass;
           COW hits, registered outputs, spills and revives engaged; prefill
           tokens tree < chain < cold; the first copy-ins and COW copies
           read back byte for byte; a tp=2 payload equal to tp=1's; the ms
           of one copy-out and one copy-in;
  spec     speculative decoding (spec_k 8, W 9): the window kernel at the
           verify width against its plain version and beside SDPA, then
           bench.py's decode:1k_repetitive and decode:8stream_mixed cells
           and a templated regeneration, spec on against off (bf16 and
           f32), spec-on at tp=2 in bf16: agreement, rounds and tree drafts
           engaged, every verify round's window launches by route;
  quant    the int8 engine (`kv_dtype="int8"`) on the engine phase's model and
           settings, bf16 (the main path) then f32: the int8 routes of the
           four paged kernels held against their plain versions (the
           sharded ones also bit for bit against the unsharded kernel) and
           timed at the serving shapes (decode, the W 256 wave, the W 9
           verify window) beside SDPA on the dequantized gather; the engine
           phase's traffic on a native and an int8 engine (blocks per pool
           byte >= 1.9x native; tokens against a teacher-forced pass of the
           plain int8 programs, f32 exact and bf16 within one step; every
           window a replay; decode on "split", windows with a bf16 q on
           "mma" and with an f32 q on "simt", QUANT_ROUTES); replay
           against eager on one int8 state, codes and scales byte for byte;
           the radix phase's chat over an undersized int8 pool (spills and
           revives, the first copies byte for byte, host bytes per block
           <= 0.55x native); the bounded-divergence oracle over two serving
           prompts and 12 steps (max|dlogit| <= 0.5; top-1 agreement and
           the native arm's near-ties reported); in f32, tp=2 against tp=1
           tick by tick (equal tokens and counters, the shards' scale copies
           equal); the decode step and a prefill chunk profiled over an int8
           and a native pool;
  faults   surgical recovery on the engine phase's model, settings and
           traffic (queued at once, so that `_run` runs one schedule), the
           engine at its defaults: bf16 native under the seeded schedule
           (FAULT_SEED: a transient, a device-lost at admission, a poison in
           a prefill wave), a device-lost at the third macro window and a
           poison at the fourth prefill wave; bf16 int8 under the seeded
           schedule; f32 under the device-lost; each beside its fault-free
           run. Gates (check_fault_run, fault_tokens): every non-poisoned
           future resolves with its max_new tokens, every failed one with a
           PoisonRequestError; every scheduled fault fired; the pool drains
           to the fault-free run's free and cached count; one capture and
           every window a replay of it; the resolved tokens against a
           teacher-forced pass of the plain programs (check_logits, f32
           within F32_CROSS_SHAPE_STEPS). Then, from one engine state after
           a forced device-lost, the replayed window against the eager
           `_macro` byte for byte. Prints recoveries by kind, slots
           restored, replay tokens and restore latency (p50, max);
  quota    elastic quotas with preemption: bench.py's overload_quota cell
           on the bench GPT (8 slots, max_len 1024, K 16, a pool of 64
           blocks that holds four borrowers; shares g 0.5/1.0 and b
           0.0/1.0 over a 128-tick window; six borrower requests of 256
           tokens x 256 new from default_rng([2026, 7, 64]), then a closed
           loop of four g requests of 64 x 32), driven tick by tick. Arms:
           g solo, quota off, quota on with a CostLedger, Metrics and
           EngineTracing armed and the same arm untraced, quota on over an
           int8 pool, quota on in f32. Gates: every future resolves,
           preemptions and borrowed ticks in the on arms, every
           quota-armed burst's per-window fold (the counts the captured
           window wrote, read once a burst) equal to the host's
           bookkeeping, the pool conserved, one capture and every window a
           replay, the traced arm's tokens, counters and blocking reads
           equal to its twin's, the ledger billing every decode token
           served and conserving slot-seconds, the on arms' streams
           against the plain programs' oracle (check_logits, f32 within
           F32_CROSS_SHAPE_STEPS), the traced arm's decode launches on
           "split" and its bf16 window launches on "mma". Prints g tok/s,
           g TTFT and latency p95 (solo, off, on), b tok/s, preemptions,
           spills, revives, the preemptions' spill bytes, restore latency
           (p50, max) and the cost fields by tenant;
  trace    the tracing cell (bench.py::_trace_timeline): 8 streams of 128
           tokens x 64 new, max_len 512, K 16, bf16, tracing off and on in
           turns (off, on, on, off, off, on), each a warm-up pass and a timed pass
           ticked on this thread. Gates: tokens and every collect_serving
           counter equal between the arms, blocking reads included, and
           the phases attributing >= 0.95 of the profiled tick wall.
           Prints tok/s of each arm, the overhead, the off arm's own wall
           noise, per-phase ms and host-overhead ms per engine dispatch.
           The engine, graph, tp, radix and quant phases arm the tick
           profiler alone (`profiled`), so their `tick_phase_s` is
           measured: without a profiler it reads empty, as in the
           reference;
  fleet    the serving plane (nos_tpu_torch/serving/): bench.py's three fleet
           cells on the bench GPT, each at its own engine settings, seeds
           and traffic, bf16 (the main path) then f32. multi_replica
           (:125): 3 replicas x 4 slots, max_len 1024, K 16, block 32, one
           engine thread each (ReplicaSet(start=True)), 6 tenants' 256-token
           system prompts, 18 requests of 32 new, round_robin against
           prefix; then, in bf16 only, on each fleet 20 requests of 64
           tokens x 384 new submitted to the replicas directly (12 on
           replica-0), and on the prefix fleet, once replica-0 decodes, a
           new replica is built (its window captured while the other
           engines serve) and migrate_replica moves replica-0's streams
           onto the fleet.
           fleet_failover (:1488): 3 replicas of the cell's tiny engine,
           replica-0's host killed at wave 5 once its streams hold
           checkpoints, the supervisor against a fault-free reference.
           shared_kv_fleet (:1701): dedup over 3 replicas, a store each
           against one shared store; turn 2 on a fresh replica, cold
           against prewarmed; failover with the store against without. In
           f32 also a cross-width drain, tp=2 on [cuda:0, cuda:0] -> tp=1 ->
           tp=2. Gates: every future resolves (ReplicaLostErrors
           classified), every pool and store conserved with no pin left,
           shared entries <= 1/2 of the summed private ones, prewarmed turn
           2 charged less prefill than cold, the store failover reviving
           tokens and replaying fewer than without, one capture per engine
           and every window a replay, every stream against the plain
           programs' teacher-forced oracle (check_logits, f32 within
           F32_CROSS_SHAPE_STEPS), decode launches on "split" and bf16
           window launches on "mma"; streams equal across placements
           reported, and gated in f32 (a divergence must be a near-tie
           within F32_CROSS_SHAPE_STEPS). Prints, with the card's name and
           power limit, tok/s and pooled TTFT p50/p95 per policy, the
           prefix hit rate, store entries and bytes private against shared,
           turn-2 prefill tokens and TTFT cold against prewarmed, failover
           latency p50/p95 with replay and revive tokens, the drain's wall
           time and slots migrated, the build time of a replica added under
           load against idle ones, and the phase's seconds;
  disagg   phase-disaggregated serving, the fleet monitor and the debug plane
           (nos_tpu_torch/serving/disagg.py, monitor.py, observability.py):
           bench.py's interference_4k_disagg (:2480; bf16 then f32, greedy:
           7 streams of 128 tokens x 512 new, then one 4096-token prompt x
           16 new once they decode; budget 1024, block 32, K 4, 8 slots)
           and disagg_long_context (:2498; bf16, temperature 0 and 0.8,
           max_seq 32896: 4 streams of 24 x 512, a 32768-token prompt x 32
           and a distinct warm one) on the bench GPT, each colocated (one
           engine) against disaggregated (a prefill and a decode replica on
           their threads over one FleetKVStore, a PrefixRouter and a
           HandoffCoordinator); and fleet_pressure (:1154; bf16: 3 quota-
           armed replicas x 2 slots, max_len 64, K 4, one CostLedger and one
           Tracer, a FleetMonitor sampling every 2 manual ticks, the hot
           burst and the gold arrivals from default_rng([2026, 12, 3])),
           monitor off against on in turns, and beside the on arm an
           ObservabilityServer on 127.0.0.1 with a bearer token. Then the two
           paged kernels held and timed at the cells' shapes (the long
           prompts' single chunks, W 32768 and W 4096 from key 0, the plain
           version in row slices; a W 1024 chunk whose keys end at 32768;
           five decode lanes, one at 32784 keys). Gates: every future
           resolves; pools and store conserved,
           no pin; one capture per engine, every window a replay; decode on
           "split", bf16 windows on "mma"; every handoff made and every
           revivable prompt block of a handed-off request not already on
           the decode engine revived from the store (> 0 each disaggregated
           arm); the short streams and the long stream each against the
           plain programs' oracle at the engine's own buckets, gated apart
           (shorts: check_logits, f32 within F32_CROSS_SHAPE_STEPS, the
           sampled arm against the threefry draw over plain logits; the
           long stream: check_long, at most LONG_MISSES positions beyond a
           step, each within LONG_STEPS, forced in a disaggregated arm as
           its destination replays it); streams equal across the arms
           gated in f32 (same_streams); monitor on/off outputs and counters
           equal, HOT and STARVED each within one window of its injection
           (STARVED agreeing with the QuotaPolicy), the journal bounded,
           parsed and replayed equal to the live verdicts; /metrics,
           /healthz, /readyz, /debug, /debug/pressure, /debug/accounting,
           /debug/events and a /debug/trace/<id> answer 200 with the token,
           /metrics and /debug/pressure 401 without. Prints per arm the
           decode tok/s during the prefill window, the window, the long
           TTFT, peak memory and utilization_block, the interference ratio,
           handoff latency p50/p95 and the export's share, the handoff
           counters, store entries and bytes, launches by route, the
           monitor's cost against the off arm's spread, the transitions'
           windows and the journal's lines;
  dense    the dense programs on the same bench GPT. Greedy generate in bf16
           (the main path) and f32: batch 8, prompts of 1024 tokens, 256
           steps, the cache at max_len 8192; the decode_attention count is
           zeroed just before the call and read just after (8 layers x 255
           steps = 2040), and a teacher-forced pass of the same programs with
           the kernel and with its plain version over the generated tokens
           must agree (f32: every greedy pick; bf16: within one step and the
           pinned logit deltas). decode_step_ragged over a seeded cache at
           per-row positions 127-4159, kernel against plain. Sampled
           generate (temperature 0.8, PRNGKey(0), 64 steps, f32) and a
           sampled DecodeServer (seed 7, four streams, its windows graph
           replays with the sampler inside): every token equals
           the threefry draw over the plain logits, and the PRNG's keys,
           bits and uniforms on the card equal the CPU's. Prints prefill ms,
           the decode loop's wall and tok/s, a profiled window of 16
           decode_step calls, the sampler's ms per step and peak memory;
  train    the single-device GPT train step in three arms. Timed: the
           training model of runtime/mfu.py::gpt_train_mfu (hidden 2048, 8
           layers, 8 heads of 256, vocab 32000, bf16), init_train_state(seed
           0), batch 8 x 2048 from synthetic_token_stream(seed 0) through
           prefetch_to_device; 2 warm-up and 6 timed steps (the flash launch
           counts are zeroed just before them and read just after: 8 of each
           kernel per step), ms per step, tokens/s, MFU, peak memory, and the
           device-busy share over one profiled step. Plain: the same width
           at 2 layers, 3 steps through the kernels and 3 through
           _reference_attention from the same params and batches, in bf16
           and f32: per-step loss, every gradient leaf of the first batch and
           the params after step 3 within TRAIN_TOL. Learning: the 2-layer
           bf16 model, 20 steps on one batch, the loss finite throughout and
           lower at step 20 than at step 1. After the timed steps,
           runtime/mfu.py::gpt_train_mfu over the same model and state
           (measure_mfu's loop differencing, TRAIN_MFU_LOOP, counted by
           gpt_train_flops): its dict, its mfu inside its mfu_range and
           within TRAIN_MFU_AGREE of the events' MFU; then
           flash_train_shape_speedup once (the flash pair against the plain
           materializing attention at [8, 8, 2048, 64] bf16 causal): an
           `invalid` marker reported as such, a published flash_ms at or
           above its floor_ms;
  vit      bench.py's headline cell (:66-122) on the port: YOLOS-small
           (ViTConfig(): 224 px, patch 16, hidden 384, 12 layers, 6 heads,
           100 detection tokens, 92 classes, bf16, init_vit(seed 0)) behind
           SliceServer as bench.py::_build_server builds it (max_batch 7,
           max_wait_s 0.003, buckets 1/2/4/7; warmup, then start); seven
           closed-loop client threads, each with its own image, 3 warm-up
           and 30 measured requests each, 3 trials. Prints the median
           trial's mean per-request latency with p50 and p95, batches_run,
           requests per batch, retries, and one batch-7 vit_detect (CUDA
           events and device time). Every served result is held against its
           image run alone (bucket 1) on the card (vit_agreement: labels
           equal wherever the top-2 class gap exceeds one step of the dtype,
           scores and boxes within VIT_TOL). An f32 arm (one trial of 10
           requests) the same. The flash arm: ViTConfig(image_size=512),
           1124 tokens, so attention takes the flash forward, served the
           same way (2 requests a client) with the flash launch counts zeroed
           just before and read just after (every launch "mma", no backward
           launch); its results against their images alone; vit_forward of
           the seven through the kernel against the same through the
           kernel's plain version (VIT_FLASH_TOL); the kernel at [7, 6, 1124,
           64] bf16 non-causal against its plain version (FLASH_TOL) and
           timed beside the plain version and scaled_dot_product_attention,
           with its bound. runtime/mfu.py::vit_batch_mfu(batch=7), the bf16
           cell's model (FlopCounterMode's count, every product a matmul at
           224 px): not None, its mfu inside its mfu_range;
  mesh     the mesh trainers, every shard on cuda:0 (a mesh may repeat a
           device). The sharded train step, dp 2 x tp 2, on the train
           phase's 2048-wide GPT cut to 2 layers, batch 8 x 2048: three
           steps against the single-device step from the same params
           (init_train_state seed 0) and batches, the flash launch counts
           zeroed just before the sharded steps and read just after (one of
           each kernel a layer and a shard, all "mma"); the per-step loss,
           the summed gradient leaves of the first batch, the params after
           step 3 and the update within MESH_TOL. attention="ring" and
           "ulysses" at sp 4 (seq 2048), one step each, the same way.
           pipeline_apply at pp 2 (f32 tanh stages, 4 microbatches) against
           the stages in turn, output and gradients, and moe_apply at ep 4,
           top-2, ample capacity, f32, against the dense gate-weighted sum
           (MESH_F32_TOL). Prints ms per step, sharded against single-device
           (shards on one card run one after another: recorded, not gated);
  control  the control plane's first layer (nos_tpu_torch/api/, cluster/),
           no kernel: the port's ClusterAPIServer on 127.0.0.1 (an ephemeral
           port, the quota webhooks installed) and its KubeCluster against
           it: Nodes with google.com/tpu allocatable and one labelled with
           this card's name, Pods, ElasticQuotas (min > max refused by the
           webhook), a watch (every ADDED and MODIFIED event within
           CONTROL["wait_s"]), a merge-patch whose null deletes an
           annotation, a status patch, a stale update refused with a
           ConflictError; telemetry.collect over the client equal to the
           counts written; nos_tpu_torch.cluster.pod_resources_grpc imported
           without loading grpc. Prints the report and the phase's seconds;
  topology the control plane's device layer (nos_tpu_torch/tpu/, util/,
           tpulib/), no kernel of its own. The CUDA runtime's enumeration
           (tpulib/local.py::_local_devices) lists the card under
           torch.cuda.get_device_name; discover_local_topology() raises
           TpuLibError naming that kind (no GPU generation is in the TPU
           table) and local_chips_visible() is False; _probe_chip on the
           card returns (None, False) within TOPOLOGY["probe_timeout_s"],
           timed. A LocalChipClient over the card's record relabelled as a
           one-chip "TPU v5 lite" at (0, 0, 0): health() None, device_stats'
           hbm_bytes_limit the card's total memory and hbm_bytes_in_use up
           by at least 1 GiB while a 1 GiB tensor is held. The native shim
           built by g++ from nos_tpu_torch/tpulib/native/tpuslice.cpp into
           its _build/ directory and loaded; NativeTpuClient carving,
           listing and deleting TOPOLOGY["carve"] on a v5e 16x16 pod (256
           chips); native_pack against the Python packer (uncached) on 40
           seeded geometries at v5e 16x16 and v5p 8x8x8 (512 chips), both
           timed. TpuMesh.update_geometry_for on both pods for one of every
           allowed profile but the whole pod: every profile provided, the
           placements disjoint and inside the mesh, timed cold.
           CloudTpuClient against FakeCloudTpuServer on 127.0.0.1 (a queued
           resource created, polled to ACTIVE, listed, deleted); two
           LeaderElectors over the port's ClusterAPIServer (one leads, the
           other takes over after a release). A Node labelled
           tpu-v5-lite-podslice with sub-slice topology 2x2, read back from
           the API server: mesh_from_assignment(labels, devices=[cuda:0] *
           4) is a ("dp", "tp") 2 x 2 mesh equal to build_mesh({"dp": 2,
           "tp": 2}) (the mesh phase's), and one sharded train step on it
           (the train phase's 2048-wide GPT cut to 2 layers, batch 8 x
           2048, init_train_state seed 0) gives the loss and params of the
           same step on the build_mesh mesh bit for bit, with layers * 4
           launches of each flash kernel, all "mma". Prints one JSON line
           with the times, the card line and the phase's seconds;
  partition the partitioning plane (nos_tpu_torch/partitioning/,
           controllers/, gpu/), no kernel; builds the native shim itself
           when it runs without the topology phase. Four TPU-mode nodes,
           each a v5e 8x8 (256 chips), each with a TpuAgent over the
           shim's NativeTpuClient, and a PartitionerController with
           FitSimScheduler over test_perf_planner.py's backlog (100 pods,
           profiles 1x1-8x8 weighted 2^-i, seed 0). As that test and
           docs/benchmark.md do, one control round is timed (snapshot,
           plan, actuate, the agents' applies included), here on six
           fresh builds of the same backlog: the first with the pack
           cache empty (cold), the other five with what earlier builds
           left in it (warm), reported apart. Each agent's apply from spec
           to status is timed per node and build. Gates: every node's
           status equal to its spec and its plan reported, the carved
           slices disjoint and inside each 8x8 mesh, some pods made
           schedulable, and every build's pods that fit, annotations and
           slices equal to each other's and to a build over FakeTpuClient
           agents. Then one MPS-mode node labelled from the card itself, as
           GPU feature discovery labels it (torch.cuda.get_device_name with
           spaces made "-", device_count, total memory in MiB), with a
           GpuAgent over FakeGpuDeviceClient(count, mps_validator(the
           card's GB)) and a seeded backlog of 10/20/40 GB pods asking for
           more than the card holds: the carve within the card's memory,
           every pod made schedulable fitting the allocatable, some pods
           left pending; and the same product in MIG mode left without a
           MIG spec (the port keeps the reference's MIG tables, A30 and
           A100). Prints one JSON line with the round and apply times, the
           counts, the card line and the phase's seconds;
  schedule the scheduler and the control plane's wiring, simulator and CLI
           (nos_tpu_torch/scheduler/, config.py, system.py, sim.py,
           sim_oracle.py, cli.py), no kernel. test_perf_planner.py:135's
           group-mode round on five fresh ControlPlanes (virtual clock):
           one v5e 16x16 slice group of 64 hosts of 2x2 with their
           HostAgents, 100 gangs of 2x2-8x8 weighted 2^-i from seed 0
           (copies of test_multihost.py's make_group and submit_gang), both
           scheduler passes around one GroupPartitioner batch, timed as the
           test times it, the first build with the pack cache empty (cold),
           the others warm; gates: every round under the test's 3.0 s
           ceiling, gangs bound (never in part), the same bindings on every
           build. `python -m nos_tpu_torch.cli simulate` with its defaults
           in a subprocess (4 x v5e 8x8, 256 chips, cli_single_host_trace(
           200), seed 0, window 180-900 s): its report must equal
           NORTH_STAR_REPORT, which `python -m nos_tpu.cli simulate` (the
           JAX package's CLI) prints on the CPU, with every job completed
           and utilization >= 0.85; its wall seconds. build_tpu_agent with
           NOS_TPU_LOCAL_CHIPS=1 on a node labelled a one-chip v5e: the
           warning of the refused grant names the card and the agent's
           client is the native shim's NativeTpuClient, never the fake.
           build_gpu_agent in MPS mode with the card's own memory inside a
           ControlPlane: the devices carved and the pods bound by one tick
           for a seeded backlog of 10/20/40 GB pods. `python -m
           nos_tpu_torch.cli demo` exits 0. Prints one JSON line with the
           round times, the report, the agents, the card line and the
           phase's seconds;
  lint     the port's static-analysis suite (nos_tpu_torch/analysis/), no
           kernel. `python -m nos_tpu_torch.cli lint nos_tpu_torch --format
           json` in a subprocess from the repository root: cold
           (`--no-cache`), then with its cache under the gitignored
           `.nos-lint-cache-torch.json` (removed first: a cold run that
           fills it), then warm. Gates: exit 0, zero findings, the
           suppressed findings as many as the port's baseline
           (lint-baseline-torch.txt) has entries, zero stale entries; the
           filled and the warm runs' findings byte-identical to the cold
           run's; the warm run parsed no file and reused the cross-file
           findings. Then an engine file planted under a temporary
           `runtime/` directory, whose `_tick` calls `.item()` and
           `torch.tensor(..., device=...)`: the lint must exit 1 with
           exactly NOS010 and NOS015 at those lines. Prints one `lint:`
           JSON line with the cold and warm seconds, the files, findings
           and suppressed, the planted findings, the card line and the
           phase's seconds;
  examples the repository's entry points outside the package, through
           their own functions. examples/end_to_end_torch.py: the control
           plane carves `tpu-node-0` (v5e 4x4) and binds a pod asking for
           `google.com/tpu-2x4`; the 2x4 becomes a dp 2 x tp 4 mesh over
           `["cuda:0"] * 8`; five bf16 train steps of the example's GPT
           (head_dim 16: the flash kernels at the padded width 64), the
           flash launch counts zeroed just before and read just after (one
           launch of each kernel a layer, a position and a step, all
           "mma"), the losses finite and within EXAMPLES_LOSS_RTOL of the
           same steps through the plain formula; the gathered params served
           through DecodeServer (the paged counts zeroed just before and
           read just after: decode launches all "split", window launches
           above zero), 8 tokens held by the teacher-forced oracle
           (check_logits). examples/sharing-comparison/run_local_torch.py:
           `run_point` at 1/3/5/7 clients, shared and sequential, on
           YOLOS-small at its defaults (224 px, bf16; no kernel, as in the
           reference); every served result against its image alone
           within VIT_TOL, the shared mode batching (requests per batch
           above 1 from 3 clients on); the per-request means printed
           beside upstream nos's A100 table, recorded, not gated. Then the
           three flash kernels timed at head_dim 16 (FLASH_D16). Prints one
           `examples:` JSON line with the card line and the phase's
           seconds.

The line before the last is the `kernels` JSON object (the two paged, the
three flash, the dense decode and the two sharded paged entry points,
which run the paged kernel once per shard, then the four paged entry
points again over an int8 pool, marked `"pool": "int8"`, with the
launches of the int8 engine's runs and `timed_route`, the route of the
timed launches), each entry with the route its main-path launches took
(`kernel_route`: "split", the split-KV decode kernels, paged and dense;
"mma", the tensor-core kernels of the bf16-q window over either pool and
the three bf16 flash kernels; or "simt"; the engine, tp, quant, dense and
train phases check that every decode launch took "split" and every bf16
window and flash launch "mma"; the two paged entries also carry
`quota_launches`, `fleet_launches` and `disagg_launches`, the quota,
fleet and disagg phases' bf16 serving launches by route, and `disagg_32k`,
the kernel checked and timed at the 32k cell's shape; the three flash
entries carry `vit_launches` and `mesh_launches`, the vit phase's flash arm
and the mesh phase's sharded step by route, flash_fwd `vit_1124`, the
kernel checked and timed at the ViT flash arm's shape, and `d16`, each
flash kernel timed at head_dim 16; the paged and flash entries carry
`examples_launches`, the examples phase's end-to-end launches by route);
the last line is {"ok": true, "device": {...}}, printed only when every
phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time
import types

import numpy as np

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
# Kernel against plain version: max|err|, and max|err| / max|want|. The
# bf16 bound is pinned at 2.5x the worst error measured on these inputs
# (2.0e-3, window kernel); int8 and f32 keep the bounds first set for them.
TOL = {"float32": 1e-4, "bfloat16": 5e-3, "int8": 2e-2}
RTOL = {"float32": 1e-4, "bfloat16": 2e-2, "int8": 2e-2}
# The bf16 teacher-forced oracle of the engine and the dense programs: the
# kernel arm's logits against the plain arm's (see check_logits), pinned at
# about 2.3x what the engine's traffic measured on an NVIDIA H100 80GB HBM3
# at 700 W (max 0.064, mean 0.0085); the dense phase measured max 0.078 /
# 0.082 and mean 0.0081 / 0.0076 (greedy / ragged), within them. Re-pin
# only with a new measurement recorded in PERF.md.
MAX_DLOGIT_BF16 = 0.15
MEAN_DLOGIT_BF16 = 0.02
# Decode lanes mid-run: six streams, then the two long prompts.
MAIN_DECODE_LIMITS = [128, 160, 192, 224, 288, 320, 4160, 4160]
# Flash kernel against plain version, entry by entry (flash_err in
# ops/flash_attention.py) within FLASH_TOL[input dtype][output], a bound
# for each output of each kernel. First set at 1e-4 (f32) and 2e-2 (bf16),
# then pinned at about 2.5x the worst over FLASH_CHECKS on an NVIDIA H100
# 80GB HBM3 at 700 W: f32 o 5.3e-6, lse 6.9e-8, dq 1.3e-6, dk 1.1e-6, dv
# 1.0e-6; bf16 lse 7.2e-8, dq 5.4e-3, dk 4.9e-3, dv 3.3e-3. bf16 o
# measured 9.3e-3 and keeps its first bound. Planted 5% faults measured
# 0.044, above every bound. The bf16 forward's tensor-core route sums q k^T
# in another order: this check measured its lse at 1.26e-7 (worst over the
# bf16 FLASH_CHECKS, NVIDIA H100 80GB HBM3 at 700 W), and the bf16 lse bound
# is pinned at about 3x that, 4.0e-7; a planted 0.001% fault in lse (5.4e-6)
# must fail it.
FLASH_TOL = {
    "float32": {"o": 1.3e-5, "lse": 1.7e-7, "dq": 3.3e-6, "dk": 2.7e-6, "dv": 2.6e-6},
    "bfloat16": {"o": 2e-2, "lse": 4.0e-7, "dq": 1.4e-2, "dk": 1.2e-2, "dv": 8.3e-3},
}
# (b, h, t, d, dtype, causal): the training shape first.
FLASH_CHECKS = [
    (8, 8, 2048, 256, "bfloat16", True),
    (2, 8, 2048, 256, "float32", True),
    (2, 4, 177, 64, "float32", True),
    (2, 4, 177, 64, "bfloat16", False),
    (1, 4, 1000, 128, "float32", False),
    (1, 4, 1000, 128, "bfloat16", True),
    (1, 8, 2048, 64, "bfloat16", True),
    # head_dim 16, 32 and 96, zero-padded to 64 or 128 by the entry points
    # (ops/flash_attention.py `_widen`): both dtypes, causal and not, a
    # ragged T.
    *[(2, 4, t, d, dtype, causal) for d, t in ((16, 177), (32, 1000), (96, 300))
      for dtype in ("float32", "bfloat16") for causal in (True, False)],
]
FLASH_MAIN = FLASH_CHECKS[0]
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# The dense decode kernel against its plain version, entry by entry
# (flash_err) within DECODE_TOL[dtype]. First set at 1e-4 (f32) and 2e-2
# (bf16). f32 is pinned at about 2.5x the worst over DECODE_CHECKS on an
# NVIDIA H100 80GB HBM3 at 700 W (4.07e-6). In bf16 both versions round an
# f32 result that agrees to ~1e-6, so an entry is either equal or one bf16
# step off, and one step is at most 2^-7 of the entry: the bound is 2^-7
# (measured 7.2e-4 here and 2.4e-3 in a card test; 2.5x those would fail a
# single step on a larger entry). Planted faults at the first case (half
# the rows off by 5%, one row zeroed) measured 0.039 and 0.74-0.77, and
# must fail it.
DECODE_TOL = {"float32": 1.0e-5, "bfloat16": 2.0 ** -7}
DECODE_LIMITS = [0, 1, 31, 32, 33, 1000, 2048, 8191, 8192, 9000]
# (nh, nkv, hd, max_len, one limit per row): the bench GPT's heads at the
# dense phase's cache with every edge limit, MHA at head_dim 128 and 256,
# and the reference test's uneven rep 2.
DECODE_CHECKS = [
    (8, 2, 64, 8192, DECODE_LIMITS[:8]),
    (8, 2, 64, 8192, DECODE_LIMITS[2:]),
    (4, 4, 128, 2048, [0, 63, 2047, 3000]),
    (4, 4, 256, 2048, [1, 64, 65, 2048]),
    (6, 3, 64, 512, [0, 300, 512]),
]
# The dense phase: batch 8, prompts of 1024 tokens, 256 steps, the cache
# sized at the model's context. The decode loop's limits run 1025..1279;
# the kernel is timed at the middle of that range.
DENSE = {"batch": 8, "prompt": 1024, "steps": 256, "max_len": 8192, "sampled_steps": 64}
DENSE_SMALL = {"batch": 2, "prompt": 24, "steps": 12, "max_len": 64, "sampled_steps": 8}
DENSE_MAIN_LIMITS = [1152] * 8
TEMPERATURE = 0.8
# The train phase's kernel arm against its plain arm (2 layers, 3 steps):
# max relative difference of the per-step loss, max|err| / max|want| of
# each gradient leaf of the first batch, max|err| of the params after step
# 3, and the relative difference of the two arms' updates (see
# train_vs_plain). f32 loss and grads keep the bounds first set (1e-5 and
# 1e-3; measured 0 and 5.1e-6). Everything else is pinned at about 2.5x
# what was measured on an NVIDIA H100 80GB HBM3 at 700 W: f32 params 1.3e-4
# (first bound a third of one lr-3e-4 update, 1e-4) and updates 1.35e-4;
# bf16 loss 4.7e-6, grads 1.8e-2, params 2.4e-3 and updates 7.6e-2.
TRAIN_TOL = {
    "float32": {"loss": 1e-5, "grad": 1e-3, "param": 3.2e-4, "update": 3.4e-4},
    "bfloat16": {"loss": 1.2e-5, "grad": 4.5e-2, "param": 6.1e-3, "update": 0.19},
}


def log(*args):
    print(*args, flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


# -- timing ------------------------------------------------------------------
def time_cuda(torch, fn, iters=20, warmup=3):
    """Mean milliseconds of `fn` per call, each call timed with CUDA events
    after a 128 MiB write that evicts the 50 MB L2 (the engine reaches the
    pool with a cold cache: eight layers of weights pass between reads)."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.mean(times))


def device_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of `fn`'s kernels per call (ms), from torch.profiler,
    with time_cuda's L2 flush before each call: the kernels' time without
    the host work that time_cuda's events hold. The profiler can miss the
    first device events of a profile, so the flush's kernel is named by a
    profile of flushes alone, and the timed profile's kernels are cut into
    calls at each flush: the last `iters` calls count (`warmup` calls run
    before them in the same profile), and each must hold a kernel; a
    profile that misses that is logged and gives None (not measured). An
    auxiliary figure: PERF.md compares kernels by time_cuda's ms."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def kernels(run):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        return sorted((e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      key=lambda e: e.time_range.start)

    flush_names = {e.name for e in kernels(lambda: [flush.zero_() for _ in range(32)])}
    fn()

    def run():
        for _ in range(warmup + iters):
            flush.zero_()
            fn()

    calls = []
    for e in kernels(run):
        if e.name in flush_names:
            calls.append([])
        elif calls:
            calls[-1].append(e.time_range.elapsed_us())
    calls = calls[-iters:]
    if not flush_names or len(calls) < iters or not all(calls):
        log(f"device_ms: not measured ({len(flush_names)} flush kernel names, {len(calls)} "
            f"calls, kernels per call {[len(c) for c in calls]})")
        return None
    return sum(map(sum, calls)) / 1e3 / iters


# -- phase: build ------------------------------------------------------------
def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from nos_tpu_torch.ops import _build

    names = _build.sources()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source, together
        logs = dict(zip(names, pool.map(_build.build, names)))
    log(f"build: {names} wall_s={time.perf_counter() - t0:.2f}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "error" in line.lower():
                log(f"ptxas[{name}]: {line.strip()}")
        for entry in ptxas_entries(text):
            log(f"ptxas[{name}]: {json.dumps(entry)}")


def ptxas_entries(text):
    """ptxas' report (`-Xptxas=-v`) as one dict per entry function: its
    mangled name, registers, stack frame and spill bytes."""
    import re

    entries, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"function": m.group(1)}
            entries.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
    return entries


# -- phase: card ---------------------------------------------------------------
def phase_card(torch):
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    log(out[0] if out else "nvidia-smi: no output")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")


# -- phase: kernels --------------------------------------------------------------
def _pools(torch, gen, dtype, total, nkv, bs, hd):
    dev = "cuda"
    if dtype == "int8":
        k = torch.randint(-127, 128, (total, nkv, bs, hd), generator=gen, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, (total, nkv, bs, hd), generator=gen, device=dev,
                          dtype=torch.int8)
        ks = torch.rand((total,), generator=gen, device=dev) * 0.02 + 0.001
        vs = torch.rand((total,), generator=gen, device=dev) * 0.02 + 0.001
        return k, v, ks, vs, torch.bfloat16
    dt = getattr(torch, dtype)
    k = torch.randn((total, nkv, bs, hd), generator=gen, device=dev).to(dt)
    v = torch.randn((total, nkv, bs, hd), generator=gen, device=dev).to(dt)
    return k, v, None, None, dt


def _table(torch, gen, b, n_pages, total):
    """Each row owns n_pages distinct pages; rows 0 and 1 share their first
    eight pages (a shared prefix)."""
    perm = torch.randperm(total - 1, generator=gen, device="cuda")[: b * n_pages] + 1
    table = perm.reshape(b, n_pages).to(torch.int32)
    table[1, :8] = table[0, :8]
    return table.contiguous()


def decode_bytes(limits, nh, nkv, hd, bs, kv_itemsize, q_itemsize):
    """Bytes the decode kernel must move: the K and V pages under each
    limit, q and out once, the table entries it reads and the limits."""
    pages = sum(-(-int(x) // bs) for x in limits)
    pool = pages * nkv * bs * hd * 2 * kv_itemsize
    qo = 2 * len(limits) * nh * hd * q_itemsize
    return pool + qo + 4 * (pages + len(limits))


def held(torch, got, want, dtype, what, worst):
    """Hold a kernel's output against its plain version's; record the
    worst max|err| and relative error (over max|want|) per kernel."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    rel = err / max(want.float().abs().max().item(), 1e-30)
    check(np.isfinite(err) and err <= TOL[dtype] and rel <= RTOL[dtype],
          f"{what} {dtype}: max|err| {err} (bound {TOL[dtype]}), "
          f"relative {rel} (bound {RTOL[dtype]})")
    name = what.split(" ")[0]
    worst[name] = max(worst[name], err)
    worst[name + "_rel"] = max(worst[name + "_rel"], rel)


def phase_kernels(torch):
    from nos_tpu_torch.ops import paged_attention as pa

    B, NH, NKV, HD, BS = 8, 8, 2, 64, 32
    P = 8192 // BS
    T = 1 + B * P
    k_split = split_keys()
    gen = torch.Generator(device="cuda").manual_seed(0)
    names = ("paged_decode_attention", "paged_window_attention")
    worst = {n + sfx: 0.0 for n in names for sfx in ("", "_rel")}
    for dtype in ("float32", "bfloat16", "int8"):
        k, v, ks, vs, qdt = _pools(torch, gen, dtype, T, NKV, BS, HD)
        table = _table(torch, gen, B, P, T)
        q = torch.randn((B, NH, HD), generator=gen, device="cuda").to(qdt)
        # Decode: every row at one context (pages past it -> scratch 0), then
        # a ragged mix of all of them, then the split kernel's boundaries.
        cases = [[c] * B for c in (1, 31, 32, 33, 2048, 8192, k_split)]
        cases.append([1, 31, 32, 33, 2048, 8192, 100, 4160])
        cases.append(split_limits(k_split))
        for limits in cases:
            tab = table.clone()
            tab[:, -(-max(limits) // BS):] = 0
            lim = torch.tensor(limits, dtype=torch.int32, device="cuda")
            got = pa.paged_decode_attention(q, k, v, tab, lim, ks, vs)
            want = pa._reference(q, k, v, tab, lim, ks, vs)
            held(torch, got, want, dtype, f"paged_decode_attention limits={limits}", worst)
        # Windows: ragged lengths, two masked lanes, shared pages.
        for w in (16, 256):
            qw = torch.randn((B, NH, w, HD), generator=gen, device="cuda").to(qdt)
            pos = torch.tensor([0, 31, 33, 1000, 2047, 4096, 7000, 8192 - w],
                               dtype=torch.int32, device="cuda")
            lengths = torch.tensor([w, 1, w - 3, w, 5, w, w // 2, w],
                                   dtype=torch.int32, device="cuda")
            mask = torch.tensor([True, True, True, False, True, True, False, True],
                                device="cuda")
            got = pa.paged_window_attention(qw, k, v, table, pos, lengths, mask, ks, vs)
            want = pa._window_reference(qw, k, v, table, pos, lengths, mask, ks, vs)
            held(torch, got, want, dtype, f"paged_window_attention W={w}", worst)
        log(f"kernels {dtype}: decode and window within {TOL[dtype]} "
            f"(relative {RTOL[dtype]}; worst so far {json.dumps(worst)})")
        del k, v, ks, vs
    timings = time_kernels(torch, pa)
    worst.update(check_flash(torch))
    timings.update(time_flash(torch))
    worst.update(check_decode(torch))
    timings.update(time_decode(torch))
    return worst, timings


def split_keys():
    """kSplitKeys of the decode kernels (csrc/split_decode.cuh)."""
    from nos_tpu_torch.ops import _build

    return _build.split_keys()


def split_limits(k):
    """Eight limits at the decode kernels' split boundaries: one key short
    of, at and one past the first and second split, three splits, and the
    serving cache's 8192 (64 splits at k = 128)."""
    return [k - 1, k, k + 1, 2 * k - 1, 2 * k, 2 * k + 1, 3 * k, 8192]


def _sdpa_decode(torch, q, k_dense, v_dense, mask):
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k_dense, v_dense, attn_mask=mask)


def time_kernels(torch, pa, decode_only=False):
    """Kernel, plain version and SDPA (on a pre-gathered dense cache) at the
    main path's shapes, bf16 pool: the decode step's B=8 lanes at the mixed
    contexts of the served traffic, and 256-token prefill chunks at
    position 2048, alone and as a two-lane wave among eight (not with
    `decode_only`). Also a context sweep for the decode kernel."""
    from nos_tpu_torch.runtime.mfu import H100_BF16_PEAK_FLOPS

    B, NH, NKV, HD, BS = 8, 8, 2, 64, 32
    P = 8192 // BS
    T = 1 + B * P
    gen = torch.Generator(device="cuda").manual_seed(1)
    k, v, _, _, dt = _pools(torch, gen, "bfloat16", T, NKV, BS, HD)
    table = _table(torch, gen, B, P, T)
    table[1, :8] = torch.arange(9, 17, device="cuda", dtype=torch.int32)  # no sharing
    out = {}

    def decode_case(limits):
        lim = torch.tensor(limits, dtype=torch.int32, device="cuda")
        q = torch.randn((B, NH, HD), generator=gen, device="cuda").to(dt)
        n_pages = -(-max(limits) // BS)
        tab = table[:, :n_pages].contiguous()
        kd = pa._gather_pool(k, tab, None, dt).repeat_interleave(NH // NKV, dim=1)
        vd = pa._gather_pool(v, tab, None, dt).repeat_interleave(NH // NKV, dim=1)
        idx = torch.arange(kd.shape[2], device="cuda")
        mask = (idx[None, :] < lim[:, None])[:, None, None, :]
        kernel = lambda: pa.paged_decode_attention(q, k, v, tab, lim)  # noqa: E731
        sdpa = lambda: _sdpa_decode(torch, q[:, :, None, :], kd, vd, mask)  # noqa: E731
        ms = time_cuda(torch, kernel)
        plain = time_cuda(torch, lambda: pa._reference(q, k, v, tab, lim))
        lib = time_cuda(torch, sdpa)
        nbytes = decode_bytes(limits, NH, NKV, HD, BS, 2, 2)
        flops = 4.0 * NH * HD * sum(limits)
        bound = 1e3 * max(nbytes / H100_BYTES_PER_S, flops / H100_BF16_PEAK_FLOPS)
        return {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                "device_ms": device_ms(torch, kernel),
                "library_device_ms": device_ms(torch, sdpa),
                "bound_by": "bytes" if nbytes / H100_BYTES_PER_S >= flops / H100_BF16_PEAK_FLOPS
                else "operations", "bytes": nbytes}

    out["decode_main"] = decode_case(MAIN_DECODE_LIMITS)
    for ctx in (512, 2048, 8192):
        out[f"decode_ctx{ctx}"] = decode_case([ctx] * B)

    def window_case(pos0, active):
        """One window launch over table rows 0..B-1: lanes in `active` hold
        a 256-token chunk at position pos0, the rest are masked (they read
        one position). B=1 is a prefill chunk, B=8 a multi-slot wave."""
        b = len(active)
        W = 256
        qw = torch.randn((b, NH, W, HD), generator=gen, device="cuda").to(dt)
        n_pages = -(-(pos0 + W) // BS)
        tab = table[:b, :n_pages].contiguous()
        pos = torch.full((b,), pos0, dtype=torch.int32, device="cuda")
        lengths = torch.full((b,), W, dtype=torch.int32, device="cuda")
        mask = torch.tensor(active, device="cuda")
        kd = pa._gather_pool(k, tab, None, dt).repeat_interleave(NH // NKV, dim=1)
        vd = pa._gather_pool(v, tab, None, dt).repeat_interleave(NH // NKV, dim=1)
        offs = torch.arange(W, device="cuda")
        lim = torch.where(mask[:, None], pos0 + offs[None, :] + 1, 1)  # [b, W]
        idx = torch.arange(kd.shape[2], device="cuda")
        causal = (idx[None, None, :] < lim[:, :, None])[:, None]  # [b, 1, W, S]
        ms = time_cuda(torch, lambda: pa.paged_window_attention(qw, k, v, tab, pos,
                                                                lengths, mask))
        plain = time_cuda(torch, lambda: pa._window_reference(qw, k, v, tab, pos,
                                                              lengths, mask))
        lib = time_cuda(torch, lambda: _sdpa_decode(torch, qw, kd, vd, causal))
        pages = sum(-(-int(x) // BS) for x in lim.max(dim=1).values.tolist())
        nbytes = (pages * NKV * BS * HD * 2 * 2 + 2 * b * NH * W * HD * 2
                  + 4 * pages + 9 * b)
        flops = 4.0 * NH * HD * float(lim.sum().item())
        return {"ms": ms, "plain_ms": plain, "library_ms": lib,
                "bound_ms": 1e3 * max(nbytes / H100_BYTES_PER_S, flops / H100_BF16_PEAK_FLOPS),
                "bound_by": "bytes" if nbytes / H100_BYTES_PER_S >= flops / H100_BF16_PEAK_FLOPS
                else "operations", "bytes": nbytes, "flops": flops,
                "tflops": flops / ms / 1e9, "route": pa._window_route(qw, k, None)}

    if decode_only:
        log("kernel_times " + json.dumps(out))
        return out
    # The long prompts' 9th chunk (position 2048): alone (B=1), and as the
    # main path's wave, the two long prompts' lanes active among eight.
    out["window_chunk"] = window_case(2048, [True])
    out["window_main"] = window_case(2048, [False] * 6 + [True, True])
    log("kernel_times " + json.dumps(out))
    return out


def _planted(t):
    """Faults a kernel could make, planted in a plain output [B,H,T,D] (lse
    [B,H,T]): the half of the rows (or keys) from T/2 on off by 5% (lse by
    0.001%), or zeroed from a row on. Each must fail its bound
    (check_flash)."""
    def scaled_by(f):
        def fault(x):
            y = x.clone()
            y[:, :, t // 2:] *= f
            return y
        return fault

    scaled = scaled_by(0.95)

    def zeroed(row):
        def fault(x):
            y = x.clone()
            y[:, :, row:] = 0
            return y
        return fault

    return [("o", "rows >= T/2 off by 5%", scaled), ("o", "rows >= T/2 zeroed", zeroed(t // 2)),
            ("dq", "rows >= T/2 off by 5%", scaled), ("dk", "keys >= T/2 off by 5%", scaled),
            ("dv", "keys >= T/2 off by 5%", scaled), ("dv", "keys >= 512 zeroed", zeroed(512)),
            ("lse", "rows >= T/2 off by 0.001%", scaled_by(1 + 1e-5))]


def check_flash(torch):
    """Each flash kernel against its plain version at FLASH_CHECKS: the
    forward's o and lse, then dq and dk/dv from the plain forward's o and
    lse (so each kernel is held alone), by flash_err within FLASH_TOL. At
    the training shape, planted faults in the plain outputs must fail the
    same bounds. Returns the worst max|err| per kernel and the worst
    flash_err per output and dtype."""
    from nos_tpu_torch.ops import flash_attention as fa

    worst = {n: 0.0 for n in FLASH_KERNELS}
    worst.update({f"{x}_{dtype}": 0.0 for dtype in FLASH_TOL for x in FLASH_TOL[dtype]})

    def hold(name, x, got, want, dtype, case):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ratio = fa.flash_err(got, want)
        check(np.isfinite(err) and np.isfinite(ratio) and ratio <= FLASH_TOL[dtype][x],
              f"{name} {case} {x}: flash_err {ratio} (bound {FLASH_TOL[dtype][x]}), "
              f"max|err| {err}")
        worst[name] = max(worst[name], err)
        worst[f"{x}_{dtype}"] = max(worst[f"{x}_{dtype}"], ratio)

    gen = torch.Generator(device="cuda").manual_seed(2)
    planted = {}
    for b, h, t, d, dtype, causal in FLASH_CHECKS:
        dt = getattr(torch, dtype)
        q, k, v, do = (torch.randn((b, h, t, d), generator=gen, device="cuda").to(dt)
                       for _ in range(4))
        scale = d ** -0.5
        case = f"[{b},{h},{t},{d}] {dtype} causal={causal}"
        o, lse = fa.flash_fwd(q, k, v, causal, scale)
        want = dict(zip(("o", "lse"), fa._flash_fwd_reference(q, k, v, causal, scale)))
        hold("flash_fwd", "o", o, want["o"], dtype, case)
        hold("flash_fwd", "lse", lse, want["lse"], dtype, case)
        dvec = fa._dvec(want["o"], do)
        dq = fa.flash_bwd_dq(q, k, v, do, want["lse"], dvec, causal, scale)
        want["dq"] = fa._dq_reference(q, k, v, do, want["lse"], dvec, causal, scale)
        hold("flash_bwd_dq", "dq", dq, want["dq"], dtype, case)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, want["lse"], dvec, causal, scale)
        want["dk"], want["dv"] = fa._dkv_reference(q, k, v, do, want["lse"], dvec, causal,
                                                   scale)
        hold("flash_bwd_dkv", "dk", dk, want["dk"], dtype, case)
        hold("flash_bwd_dkv", "dv", dv, want["dv"], dtype, case)
        if (b, h, t, d, dtype, causal) == FLASH_MAIN:
            for x, what, fault in _planted(t):
                ratio = fa.flash_err(fault(want[x]), want[x])
                check(ratio > FLASH_TOL[dtype][x],
                      f"planted fault in {x} ({what}) passes: flash_err {ratio} "
                      f"<= {FLASH_TOL[dtype][x]}")
                planted[f"{x}: {what}"] = ratio
        del q, k, v, do, o, lse, dq, dk, dv, want, dvec
    log(f"kernels flash: every case within {json.dumps(FLASH_TOL)} "
        f"(worst {json.dumps(worst)}); planted faults at {FLASH_MAIN} fail: "
        f"{json.dumps(planted)}")
    return worst


def flash_work(b, h, t, d, causal, itemsize):
    """FLOPs and bytes per flash kernel for this input: each product counts
    2 * d per (q, k) pair the mask keeps (t (t + 1) / 2 pairs per head when
    causal); bytes read each input once and write each output once."""
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    tensor = b * h * t * d * itemsize
    rows = b * h * t * 4
    return {
        "flash_fwd": (2 * 2.0 * d * pairs, 4 * tensor + rows),           # QK^T, PV
        "flash_bwd_dq": (3 * 2.0 * d * pairs, 5 * tensor + 2 * rows),    # S, dP, dQ
        "flash_bwd_dkv": (4 * 2.0 * d * pairs, 6 * tensor + 2 * rows),   # S, dP, dV, dK
    }


def time_flash(torch, shape=FLASH_MAIN):
    """Each flash kernel, its plain version and the library call at `shape`
    (b, h, t, d, dtype, causal; the training shape by default), with its
    bound. The library is scaled_dot_product_attention: its forward for
    flash_fwd, and for both backward kernels one autograd call of its
    backward, which computes dq, dk and dv together. At the training shape
    also SDPA's forward + backward pair and the pair's floor
    (runtime/mfu.py)."""
    import torch.nn.functional as F

    from nos_tpu_torch.ops import flash_attention as fa
    from nos_tpu_torch.runtime.mfu import H100_BF16_PEAK_FLOPS, flash_pair_floor_ms

    b, h, t, d, dtype, causal = shape
    gen = torch.Generator(device="cuda").manual_seed(3)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn((b, h, t, d), generator=gen, device="cuda").to(dt)
                   for _ in range(4))
    scale = d ** -0.5
    o, lse = fa.flash_fwd(q, k, v, causal, scale)
    dvec = fa._dvec(o, do)
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)

    def sdpa_bwd():
        torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True)

    def sdpa_pair():
        o2 = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        torch.autograd.grad(o2, (qg, kg, vg), do)

    lib_bwd = time_cuda(torch, sdpa_bwd, iters=10)
    runs = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, causal, scale),
                      lambda: fa._flash_fwd_reference(q, k, v, causal, scale),
                      time_cuda(torch, lambda: F.scaled_dot_product_attention(
                          q, k, v, is_causal=causal), iters=10)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, do, lse, dvec, causal, scale),
                         lambda: fa._dq_reference(q, k, v, do, lse, dvec, causal, scale),
                         lib_bwd),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, do, lse, dvec, causal, scale),
                          lambda: fa._dkv_reference(q, k, v, do, lse, dvec, causal, scale),
                          lib_bwd),
    }
    work = flash_work(b, h, t, d, causal, q.element_size())
    out_t = {}
    for name, (kern, plain, lib) in runs.items():
        flops, nbytes = work[name]
        by_ops = flops / H100_BF16_PEAK_FLOPS >= nbytes / H100_BYTES_PER_S
        out_t[name] = {
            "ms": time_cuda(torch, kern, iters=10),
            "plain_ms": time_cuda(torch, plain, iters=5, warmup=1),
            "library_ms": lib,
            "bound_ms": 1e3 * max(flops / H100_BF16_PEAK_FLOPS, nbytes / H100_BYTES_PER_S),
            "bound_by": "operations" if by_ops else "bytes",
            "flops": flops, "bytes": nbytes,
        }
        out_t[name]["tflops"] = flops / out_t[name]["ms"] / 1e9
    if shape == FLASH_MAIN:
        out_t["sdpa_pair_ms"] = time_cuda(torch, sdpa_pair, iters=10)
        out_t["pair_floor_ms"] = flash_pair_floor_ms(b, h, t, d, H100_BF16_PEAK_FLOPS)
    log(f"flash_times {list(shape)} " + json.dumps(out_t))
    return out_t


def check_decode(torch):
    """The dense decode kernel against its plain version at DECODE_CHECKS in
    f32 and bf16, by flash_err within DECODE_TOL; planted faults at the
    first case must fail the same bound. Returns the worst max|err| and the
    worst flash_err per dtype."""
    from nos_tpu_torch.ops import decode_attention as da
    from nos_tpu_torch.ops.flash_attention import flash_err

    worst = {"decode_attention": 0.0, "decode_float32": 0.0, "decode_bfloat16": 0.0}
    planted = {}
    gen = torch.Generator(device="cuda").manual_seed(4)
    # The bench GPT's heads at the split kernel's boundaries.
    checks = DECODE_CHECKS + [(8, 2, 64, 8192, split_limits(split_keys()))]
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for i, (nh, nkv, hd, max_len, limits) in enumerate(checks):
            b = len(limits)
            q = torch.randn((b, nh, hd), generator=gen, device="cuda").to(dt)
            k, v = (torch.randn((b, nkv, max_len, hd), generator=gen, device="cuda").to(dt)
                    for _ in range(2))
            lim = torch.tensor(limits, dtype=torch.int32, device="cuda")
            got = da.decode_attention(q, k, v, lim)
            want = da._reference(q, k, v, lim)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ratio = flash_err(got, want)
            check(got.dtype == dt and np.isfinite(err) and ratio <= DECODE_TOL[dtype],
                  f"decode_attention {dtype} nh={nh} nkv={nkv} hd={hd} max={max_len} "
                  f"limits={limits}: flash_err {ratio} (bound {DECODE_TOL[dtype]}), "
                  f"max|err| {err}")
            worst["decode_attention"] = max(worst["decode_attention"], err)
            worst[f"decode_{dtype}"] = max(worst[f"decode_{dtype}"], ratio)
            if i == 0:
                scaled = want.clone()
                scaled[b // 2:] *= 0.95
                zeroed = want.clone()
                zeroed[3] = 0
                for what, bad in (("rows >= B/2 off by 5%", scaled), ("row 3 zeroed", zeroed)):
                    r = flash_err(bad, want)
                    check(r > DECODE_TOL[dtype], f"planted fault ({what}, {dtype}) passes: "
                          f"flash_err {r} <= {DECODE_TOL[dtype]}")
                    planted[f"{dtype}: {what}"] = r
            del q, k, v, got, want
    log(f"kernels decode: every case within {json.dumps(DECODE_TOL)} "
        f"(worst {json.dumps(worst)}); planted faults fail: {json.dumps(planted)}")
    return worst


def time_decode(torch):
    """The dense decode kernel, its plain version and SDPA on the same dense
    bf16 cache (enable_gqa, a boolean mask over all `max` positions) at the
    dense phase's shape: B 8, nh 8, nkv 2, hd 64, max 8192, every row at the
    middle of the decode loop's limits, and a sweep of limits. SDPA is a
    yardstick only; the port never calls it."""
    import torch.nn.functional as F

    from nos_tpu_torch.ops import decode_attention as da
    from nos_tpu_torch.runtime.mfu import H100_BF16_PEAK_FLOPS

    B, NH, NKV, HD, MAX = 8, 8, 2, 64, DENSE["max_len"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn((B, NH, HD), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((B, NKV, MAX, HD), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    idx = torch.arange(MAX, device="cuda")

    def case(limits):
        lim = torch.tensor(limits, dtype=torch.int32, device="cuda")
        mask = (idx[None, :] < lim[:, None])[:, None, None, :]  # [B, 1, 1, max]
        q4 = q[:, :, None, :]
        read = sum(min(x, MAX) for x in limits)  # positions the function needs
        nbytes = read * NKV * HD * 2 * 2 + 2 * B * NH * HD * 2 + 4 * B
        flops = 4.0 * NH * HD * read
        by_bytes = nbytes / H100_BYTES_PER_S >= flops / H100_BF16_PEAK_FLOPS
        kernel = lambda: da.decode_attention(q, k, v, lim)  # noqa: E731
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q4, k, v, attn_mask=mask, enable_gqa=True)
        return {
            "ms": time_cuda(torch, kernel),
            "plain_ms": time_cuda(torch, lambda: da._reference(q, k, v, lim)),
            "library_ms": time_cuda(torch, sdpa),
            "device_ms": device_ms(torch, kernel),
            "library_device_ms": device_ms(torch, sdpa),
            "bound_ms": 1e3 * max(nbytes / H100_BYTES_PER_S, flops / H100_BF16_PEAK_FLOPS),
            "bound_by": "bytes" if by_bytes else "operations",
            "bytes": nbytes, "flops": flops,
        }

    out = {"dense_main": case(DENSE_MAIN_LIMITS)}
    for ctx in (1025, 1279, 8192):
        out[f"dense_ctx{ctx}"] = case([ctx] * B)
    log("dense_kernel_times " + json.dumps(out))
    return out


# -- phase: experts ------------------------------------------------------------------
# The Mellum2-12B-A2.5B cell's shapes (portbench/configs/mellum2-12b-a2.5b.json):
# the expert layer at a decode window's 48 rows and a prefill chunk's 2048,
# the paged kernels at 32 query heads over 4 KV heads of 128, block 32,
# window 1024, 48 lanes of up to 13312 keys. Small: the CPU rehearsal's.
EXPERTS = {"hidden": 2304, "ffn": 896, "experts": 64, "top_k": 8, "tokens": (48, 2048),
           "heads": 32, "kv_heads": 4, "head_dim": 128, "block": 32, "window": 1024,
           "lanes": 48, "max_len": 13312, "chunk": 2048}
EXPERTS_SMALL = {"hidden": 256, "ffn": 128, "experts": 8, "top_k": 4, "tokens": (8, 40),
                 "heads": 4, "kv_heads": 2, "head_dim": 32, "block": 8, "window": 24,
                 "lanes": 8, "max_len": 96, "chunk": 16}
# The expert chain against its plain version: max|err| <= EXPERT_RTOL x
# max|want| (tests/test_torch_moe_kernels.py's bound: the plain version
# rounds the gate and up products to bf16 before silu, the chain keeps them
# in f32). Planted faults (one token's last expert dropped, one expert's
# rows zeroed) must fail it.
EXPERT_RTOL = 2e-2


def _expert_inputs(torch, gen, t, e, dev):
    h, f = e["hidden"], e["ffn"]
    n = e["experts"]

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    return (normal((t, h), 1.0), normal((h, n), h ** -0.5), normal((n, h, f), h ** -0.5),
            normal((n, h, f), h ** -0.5), normal((n, f, h), f ** -0.5))


def check_expert_chain(torch, dev, e):
    """The chain (`moe_experts`) against `_plain` at each of e["tokens"]
    rows, with masked rows (a decode window's idle lanes, a chunk's
    padding): the error within EXPERT_RTOL, the tallies equal, two calls
    equal bit for bit, and the planted faults outside the bound."""
    from nos_tpu_torch.ops import moe

    gen = torch.Generator(device=dev).manual_seed(27)
    k = e["top_k"]
    out = {}
    for t in e["tokens"]:
        x, router, wg, wu, wd = _expert_inputs(torch, gen, t, e, dev)
        valid = torch.ones(t, dtype=torch.bool, device=dev)
        valid[-max(1, t // 6):] = False
        tally = torch.zeros(2, dtype=torch.int64, device=dev)
        want_tally = torch.zeros(2, dtype=torch.int64, device=dev)
        got = moe.moe_experts(x, router, wg, wu, wd, k, True, valid=valid, tally=tally)
        again = moe.moe_experts(x, router, wg, wu, wd, k, True, valid=valid)
        want = moe._plain(x, router, wg, wu, wd, k, True, valid, want_tally)
        top = want.float().abs().max().item()

        def rel(a):
            return (a.float() - want.float()).abs().max().item() / max(top, 1e-30)

        err = rel(got)
        check(np.isfinite(err) and err <= EXPERT_RTOL,
              f"moe_experts T={t}: max|err| / max|want| {err} (bound {EXPERT_RTOL})")
        check(torch.equal(got, again), f"moe_experts T={t}: two calls differ")
        check(tally.tolist() == want_tally.tolist(),
              f"moe_experts T={t}: tally {tally.tolist()}, plain {want_tally.tolist()}")
        check(bool((got[~valid] == 0).all()), f"moe_experts T={t}: a masked row has output")
        dropped = want.clone()
        dropped[0] = moe._plain(x[:1], router, wg, wu, wd, k - 1, True, None, None)[0]
        ids, _ = moe.route(x, router, k, True)
        busiest = int(torch.bincount(ids[valid].flatten(), minlength=e["experts"]).argmax())
        wd0 = wd.clone()
        wd0[busiest] = 0
        skipped = moe._plain(x, router, wg, wu, wd0, k, True, valid, None)
        planted = {"dropped_expert": rel(dropped), "skipped_expert": rel(skipped)}
        for name, v in planted.items():
            check(v > EXPERT_RTOL, f"moe_experts T={t}: planted {name} reads {v}, within "
                                   f"the bound {EXPERT_RTOL}")
        out[f"T{t}"] = {"rel_err": err, "rows": tally.tolist()[0], "hit": tally.tolist()[1],
                        "planted": planted}
        log(f"experts: chain T={t} {json.dumps(out[f'T{t}'])}")
    return out


def _windowed_held(got, want, dtype, name, worst):
    """`held`'s bounds (TOL, RTOL), on either device."""
    err = (got.float() - want.float()).abs().max().item()
    rel = err / max(want.float().abs().max().item(), 1e-30)
    check(np.isfinite(err) and err <= TOL[dtype] and rel <= RTOL[dtype],
          f"{name} with a window, {dtype}: max|err| {err} (bound {TOL[dtype]}), relative "
          f"{rel} (bound {RTOL[dtype]})")
    worst[name], worst[name + "_rel"] = err, rel


def check_windowed_paged(torch, dev, e, dtype="bfloat16"):
    """The split decode kernel and the window kernel with the window on,
    against `_reference` / `_window_reference` with it, at the cell's
    heads: decode lanes whose bound limit - window lies on a page boundary,
    one past it, one short, at 0 and below it, and the rest ragged up to
    max_len; a wave of chunk-row lanes whose first rows' bounds lie on and
    off a page, one at position 0 and one masked. The unbounded result
    must fail the windowed bound (the window is read), and window 0 is
    the unbounded kernel bit for bit."""
    from nos_tpu_torch.ops import paged_attention as pa

    nh, nkv, hd, bs, w = e["heads"], e["kv_heads"], e["head_dim"], e["block"], e["window"]
    gen = torch.Generator(device=dev).manual_seed(28)
    rng = np.random.default_rng(28)
    pages = e["max_len"] // bs
    b = e["lanes"]
    total = 1 + b * pages
    qdt = getattr(torch, dtype)
    k_pool = torch.randn((total, nkv, bs, hd), generator=gen, device=dev).to(qdt)
    v_pool = torch.randn((total, nkv, bs, hd), generator=gen, device=dev).to(qdt)
    table = (torch.randperm(total - 1, generator=gen, device=dev)[: b * pages] + 1).reshape(
        b, pages).to(torch.int32)
    edges = [w + 4 * bs, w + 4 * bs + 1, w + 4 * bs - 1, w, w - 3, e["max_len"]]
    ragged = np.exp(rng.uniform(np.log(w), np.log(e["max_len"]), b - len(edges))).astype(int)
    limits = torch.tensor(edges + ragged.tolist(), dtype=torch.int32, device=dev)
    q = torch.randn((b, nh, hd), generator=gen, device=dev).to(qdt)
    before = {n: dict(r) for n, r in pa.ROUTE_LAUNCHES.items()}
    got = pa.paged_decode_attention(q, k_pool, v_pool, table, limits, window=w)
    off = pa.paged_decode_attention(q, k_pool, v_pool, table, limits, window=0)
    unbounded = pa.paged_decode_attention(q, k_pool, v_pool, table, limits)
    want = pa._reference(q, k_pool, v_pool, table, limits, window=w)
    worst = {}
    _windowed_held(got, want, dtype, "paged_decode_attention", worst)
    check(torch.equal(off, unbounded), "paged_decode_attention: window 0 is not the "
                                       "unbounded kernel bit for bit")
    fault = (unbounded.float() - want.float()).abs().max().item()
    check(fault > TOL[dtype], f"paged_decode_attention: the unbounded read ({fault}) "
                              f"passes the windowed bound {TOL[dtype]}")
    # The window kernel over a wave of chunk rows.
    c = e["chunk"]
    pos_list = [2 * w + 2 * c, (w - 1) + 2 * bs, 0, w + c]  # off page, on page, 0, masked
    lanes = len(pos_list)
    need = -(-(max(pos_list) + c) // bs)
    wt = table[:lanes, :need].contiguous()
    qw = torch.randn((lanes, nh, c, hd), generator=gen, device=dev).to(qdt)
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    lengths = torch.tensor([c, c, c - c // 4, c], dtype=torch.int32, device=dev)
    mask = torch.tensor([True, True, True, False], device=dev)
    got_w = pa.paged_window_attention(qw, k_pool, v_pool, wt, pos, lengths, mask, window=w)
    off_w = pa.paged_window_attention(qw, k_pool, v_pool, wt, pos, lengths, mask, window=0)
    unb_w = pa.paged_window_attention(qw, k_pool, v_pool, wt, pos, lengths, mask)
    want_w = pa._window_reference(qw, k_pool, v_pool, wt, pos, lengths, mask, window=w)
    valid = (torch.arange(c, device=dev)[None, :] < lengths[:, None]) & mask[:, None]
    sel = valid[:, None, :, None]
    _windowed_held(got_w * sel, want_w * sel, dtype, "paged_window_attention", worst)
    check(torch.equal(off_w, unb_w), "paged_window_attention: window 0 is not the "
                                     "unbounded kernel bit for bit")
    fault_w = ((unb_w.float() - want_w.float()) * sel).abs().max().item()
    check(fault_w > TOL[dtype], f"paged_window_attention: the unbounded read ({fault_w}) "
                                f"passes the windowed bound {TOL[dtype]}")
    if dev.type == "cuda":
        routes = {n: {r: k - before[n][r] for r, k in rs.items()}
                  for n, rs in pa.ROUTE_LAUNCHES.items()}
        check_routes(routes, "paged_decode_attention", "split", "experts")
        check_routes(routes, "paged_window_attention",
                     "mma" if dtype == "bfloat16" else "simt", "experts")
    out = dict(worst, unbounded_decode=fault, unbounded_window=fault_w)
    log(f"experts: windowed paged kernels {json.dumps(out)}")
    return out


def mellum_small():
    """The Mellum layout at a size the card serves in seconds (4 layers,
    3 sliding and 1 full, window 48, q width 512 over hidden 256, 8 experts
    top 4, YaRN at original 64), its weights and its reference, from the
    benchmark's configuration (portbench/)."""
    from pathlib import Path

    from portbench import harness

    path = Path(__file__).resolve().parent / "portbench/configs/mellum2-12b-a2.5b.json"
    cfg = json.loads(path.read_text())
    ropes = cfg["rope_parameters"]
    cfg.update(vocab_size=512, hidden_size=256, num_attention_heads=4, num_key_value_heads=2,
               head_dim=128, num_hidden_layers=4,
               layer_types=["sliding_attention"] * 3 + ["full_attention"],
               mlp_layer_types=["sparse"] * 4, sliding_window=48, num_experts=8,
               num_experts_per_tok=4, moe_intermediate_size=128, max_position_embeddings=256,
               rope_parameters={
                   "full_attention": dict(ropes["full_attention"], factor=4,
                                          original_max_position_embeddings=64),
                   "sliding_attention": ropes["sliding_attention"]})
    return cfg, harness.load_module("arch", "mellum"), harness.load_module("references",
                                                                           "mellum")


def mellum_engine_run(torch, dev):
    """The small Mellum layout through DecodeServer with its defaults
    (window graphs, bursts, chunk graphs) and a budget of four 64-token
    chunks a tick, so long prompts' mid chunks meet in multi-slot waves.
    The launch counts are zeroed just before the traffic and read just
    after: on the card the expert chain ran once per layer of every
    program the host dispatched (K steps a window replay, one per chunk
    and wave), the paged kernels likewise, and the tallies hold the exact
    rows; every served token lies within 0.3 of the reference's best
    logit."""
    from nos_tpu_torch.ops import moe
    from nos_tpu_torch.ops import paged_attention as pa
    from nos_tpu_torch.runtime.decode_server import DecodeServer

    cfg, arch, ref = mellum_small()
    params = arch.make_params(cfg, 7, dev)
    K = 4
    eng = DecodeServer(params, arch.engine_config(cfg), n_slots=4, max_len=256,
                       prompt_buckets=(32, 64), block_size=16, steps_per_dispatch=K,
                       prefill_budget_tokens=256, device=dev, temperature=0.0)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, n).tolist() for n in (150, 200, 20, 64, 180, 90)]
    moe.reset_launch_counts()
    pa.reset_launch_counts()
    eng.start()
    try:
        futs = [eng.submit(p, 40) for p in prompts]
        outs = [f.result(timeout=600) for f in futs]
        counts = eng.expert_counts()
    finally:
        eng.stop()
    layers, top = 4, 4
    stats = {n: getattr(eng, n) for n in (
        "graph_captures", "graph_replays", "macro_dispatches", "burst_windows_run",
        "burst_dispatches", "prefill_graph_replays", "prefill_eager_chunks",
        "prefill_window_dispatches")}
    programs = stats["prefill_graph_replays"] + stats["prefill_eager_chunks"] + \
        stats["prefill_window_dispatches"]
    launches = {"moe_experts": moe.LAUNCHES["moe_experts"],
                "paged_decode_attention": pa.LAUNCHES["paged_decode_attention"],
                "paged_window_attention": pa.LAUNCHES["paged_window_attention"]}
    want = {"moe_experts": layers * (K * stats["graph_replays"] + programs),
            "paged_decode_attention": layers * K * stats["graph_replays"],
            "paged_window_attention": layers * programs}
    log(f"experts: engine {json.dumps(stats)} launches {json.dumps(launches)} "
        f"expected {json.dumps(want)} tallies {json.dumps(counts)}")
    if dev.type == "cuda":
        check_replays(stats, "experts engine")
        check(launches == want, f"experts engine: launches {launches}, host bookkeeping "
                                f"{want}")
    check(stats["prefill_window_dispatches"] > 0, "experts engine: no multi-slot wave ran")
    check(counts["prefill_rows"] == layers * top * sum(len(p) for p in prompts),
          f"experts engine: prefill rows {counts['prefill_rows']}")
    check(counts["decode_rows"] == layers * top * sum(len(o) - 1 for o in outs),
          f"experts engine: decode rows {counts['decode_rows']}")
    worst = 0.0
    for p, o in zip(prompts, outs):
        lg = ref.logits_at(params, cfg, p + list(o[:-1]), len(p) - 1)
        pick = torch.tensor(o, device=lg.device)[:, None]
        worst = max(worst, (lg.max(-1).values - lg.gather(1, pick)[:, 0]).max().item())
    check(worst <= 0.3, f"experts engine: a served token {worst} below the reference's best")
    return dict(stats, launches=launches, tallies=counts, max_logit_gap=worst)


def phase_experts(torch, device, small=False):
    """The Mellum cell's kernels on the card at its shapes, then the small
    Mellum layout through the engine (see the module docstring)."""
    e = EXPERTS_SMALL if small else EXPERTS
    out = {"chain": check_expert_chain(torch, device, e),
           "paged": check_windowed_paged(torch, device, e,
                                         "bfloat16" if device.type == "cuda" else "float32")}
    out["engine"] = mellum_engine_run(torch, device)
    return out


# -- phase: engine -----------------------------------------------------------------
@contextlib.contextmanager
def plain_attention():
    """Route the model programs through the kernels' plain versions (the
    oracle's arm; the package itself has no such switch): the paged
    kernels and the dense decode kernel."""
    from nos_tpu_torch.models import decode as D
    from nos_tpu_torch.ops import decode_attention as da
    from nos_tpu_torch.ops import paged_attention as pa

    saved = (pa.paged_decode_attention, pa.paged_window_attention, D.decode_attention)
    pa.paged_decode_attention = pa._reference
    pa.paged_window_attention = window_reference_rows
    D.decode_attention = da._reference
    try:
        yield
    finally:
        pa.paged_decode_attention, pa.paged_window_attention, D.decode_attention = saved


# Rows of the plain window a call computes at once: a 32768-row prefill
# chunk's scores over its keys are 34 GB in f32, so longer windows run in
# row slices (each row's softmax is its own: the same function).
PLAIN_WINDOW_ROWS = 4096


def window_reference_rows(q, pool_k, pool_v, table, pos, lengths, mask, k_scale=None,
                          v_scale=None, window=0):
    """`paged_attention._window_reference` over slices of PLAIN_WINDOW_ROWS
    rows, each at its own position and with its own count of valid rows;
    `window` as the kernel's (0: none)."""
    from nos_tpu_torch.ops import paged_attention as pa

    import torch

    w = q.shape[2]
    if w <= PLAIN_WINDOW_ROWS:
        return pa._window_reference(q, pool_k, pool_v, table, pos, lengths, mask,
                                    k_scale, v_scale, window=window)
    return torch.cat([
        pa._window_reference(q[:, :, r:r + PLAIN_WINDOW_ROWS].contiguous(), pool_k, pool_v,
                             table, pos + r, (lengths - r).clamp(0, PLAIN_WINDOW_ROWS), mask,
                             k_scale, v_scale, window=window)
        for r in range(0, w, PLAIN_WINDOW_ROWS)], dim=2)


def teacher_forced(torch, params, cfg, prompts, outputs, buckets, block_size, device,
                   mesh=None, kv_dtype=None, handoff=False):
    """Logits of a teacher-forced greedy pass over prompt+output, shaped as
    the engine's own programs: each prompt in chunks of the largest bucket
    (the final one padded to its bucket, batch 1), then the outputs fed
    back through batched single-token decode steps. Returns [n, max_new,
    vocab] f32 logits; row t predicts output token t. With a `mesh` the
    programs run tensor-parallel over its "tp" shards; `kv_dtype` "int8"
    runs them over an int8 pool. `handoff` shapes the first output token
    as a handoff's destination replays it: prompt + first token from the
    start of the last token's block (the blocks below it are revived, not
    recomputed) through one prefill chunk, whose last row predicts token
    1; the decode steps follow from there."""
    from nos_tpu_torch.models import decode as D

    tp = None
    if mesh is not None:
        params, _, tp = D.place_tp(params, cfg, mesh)
    n = len(prompts)
    max_new = len(outputs[0])
    chunk = buckets[-1]
    pages_per = [-(-(len(p) + max_new) // block_size) for p in prompts]
    width = max(pages_per)
    total = 1 + sum(pages_per)
    cache = D.init_paged_cache(cfg, total, block_size, kv_dtype=kv_dtype, device=device,
                               mesh=mesh)
    table = torch.zeros((n, width), dtype=torch.int32, device=device)
    nxt = 1
    for i, n_p in enumerate(pages_per):
        table[i, :n_p] = torch.arange(nxt, nxt + n_p, dtype=torch.int32)
        nxt += n_p
    logits = torch.empty((n, max_new, cfg.vocab), dtype=torch.float32, device=device)

    def bucket(m):
        return next((b for b in buckets if b >= m), buckets[-1])

    for i, prompt in enumerate(prompts):
        for start in range(0, len(prompt), chunk):
            piece = prompt[start:start + chunk]
            toks = torch.zeros((1, bucket(len(piece))), dtype=torch.int32, device=device)
            toks[0, : len(piece)] = torch.tensor(piece, dtype=torch.int32)
            last = start + len(piece) >= len(prompt)
            lg, _ = D.paged_prefill_chunk(params, toks, cfg, cache, table[i], start,
                                          len(piece), block_size, with_logits=last, tp=tp)
            if last:
                logits[i, 0] = lg[len(piece) - 1]
        if handoff:
            full = list(prompt) + [outputs[i][0]]
            start = (len(full) - 1) // block_size * block_size
            tail = full[start:]
            toks = torch.zeros((1, bucket(len(tail))), dtype=torch.int32, device=device)
            toks[0, : len(tail)] = torch.tensor(tail, dtype=torch.int32)
            lg, _ = D.paged_prefill_chunk(params, toks, cfg, cache, table[i], start, len(tail),
                                          block_size, tp=tp)
            logits[i, 1] = lg[len(tail) - 1]
    out_t = torch.tensor(outputs, dtype=torch.int32, device=device)
    plen = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=device)
    mask = torch.ones((n,), dtype=torch.bool, device=device)
    for t in range(1 if handoff else 0, max_new - 1):
        lg, _ = D.paged_decode_step(params, out_t[:, t].contiguous(), cfg, cache, table,
                                    plen + t, mask, block_size, tp=tp)
        logits[:, t + 1] = lg
    return logits


def greedy(torch, logits):
    top = logits.max(dim=-1, keepdim=True).values
    idx = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(logits == top, idx, logits.shape[-1]).min(dim=-1).values


def serve(torch, cfg, params, device, prompts, long_prompts, max_new, buckets, max_len,
          **engine_kw):
    """The main path: the short streams first, the long prompts together
    once the streams decode. `engine_kw` (`burst_windows`) goes to the
    engine, which otherwise runs its defaults. Returns (outputs in submit
    order, stats)."""
    from nos_tpu_torch import DecodeServer
    from nos_tpu_torch.ops import paged_attention as pa

    def engine():
        return DecodeServer(params, cfg, n_slots=8, max_len=max_len,
                            prompt_buckets=buckets, steps_per_dispatch=16,
                            prefill_budget_tokens=2 * buckets[-1], device=device,
                            tracing=profiled(), **engine_kw)

    server = engine()
    try:
        # Warm-up (not counted): one short request through both programs.
        server.start()
        server.generate(prompts[0][:40], max_new=20, timeout=600)
        server.stop(drain=True)
        server = engine()
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        pa.reset_launch_counts()
        t0 = time.perf_counter()
        futs = [server.submit(p, max_new) for p in prompts]
        server.start()
        while server.steps_run < 2:  # the streams are decoding
            time.sleep(0.001)
        t_long = time.perf_counter()
        futs += [server.submit(p, max_new) for p in long_prompts]
        outs = [f.result(timeout=900) for f in futs]
        stats = serve_stats(torch, server, device, t0, t_long, len(futs), max_new,
                            len(long_prompts))
    finally:
        server.stop()
    return outs, stats


# The engine counters two widths of one engine must agree on for one schedule.
BUDGET_COUNTERS = ("macro_dispatches", "burst_dispatches", "burst_windows_run",
                   "graph_replays", "prefill_dispatches", "prefill_window_dispatches",
                   "prefill_tokens", "steps_run", "h2d_uploads", "staging_syncs",
                   "blocking_syncs")


def serve_stats(torch, server, device, t0, t_long, n_req, max_new, n_long):
    """An engine run's numbers, read just after its last future: wall time
    from the first submit, output tok/s, TTFTs, the counters, the launch
    counts and peak device memory."""
    from nos_tpu_torch.ops import paged_attention as pa

    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(len(server.ttft_s) == n_req, f"{len(server.ttft_s)} TTFT samples")
    stats = {
        "wall_s": wall,
        "decode_tok_per_s": n_req * max_new / wall,
        "long_prompt_ttft_s": server.ttft_s[-n_long:],
        "long_submit_offset_s": t_long - t0,
        "ttft_s": server.ttft_s,
        "queue_wait_s": server.queue_wait_s,
        **{c: getattr(server, c) for c in BUDGET_COUNTERS},
        "burst_windows": server.burst_windows,
        "graph_captures": server.graph_captures,
        "prefill_graph_replays": server.prefill_graph_replays,
        "prefill_eager_chunks": server.prefill_eager_chunks,
        "ticks_with_prefill_and_macro": server.ticks_with_prefill_and_macro,
        "prefix_hit_tokens": server.prefix_hit_tokens,
        "kv_pool_bytes": server.kv_pool_bytes,
        "tick_phase_s": server.tick_phase_s,
        "launches": dict(pa.LAUNCHES),
        "routes": {n: dict(r) for n, r in pa.ROUTE_LAUNCHES.items()},
        "peak_mem_bytes": torch.cuda.max_memory_allocated() if device.type == "cuda" else None,
    }
    return stats


def check_replays(stats, what, bursts=True):
    """On the card every decode window of an engine run was a replay of its
    captured graph (one capture per engine), every batch-1 prompt chunk a
    replay of its bucket's graph where the run counted them, and with
    bursts on (the default) some windows ran inside bursts."""
    windows = stats["macro_dispatches"] + stats["burst_windows_run"]
    check(stats["graph_captures"] == 1 and stats["graph_replays"] == windows > 0,
          f"{what}: {stats['graph_replays']} graph replays for {windows} windows "
          f"({stats['graph_captures']} captures)")
    if "prefill_eager_chunks" in stats:
        check(stats["prefill_eager_chunks"] == 0 and stats["prefill_graph_replays"] > 0,
              f"{what}: {stats['prefill_eager_chunks']} eager prompt chunks, "
              f"{stats['prefill_graph_replays']} replayed")
    if bursts:
        check(stats["burst_dispatches"] > 0, f"{what}: no burst dispatched")


def check_routes(routes, name, route, what):
    """Every launch of kernel `name` in a run took `route`."""
    n = sum(routes[name].values())
    check(n > 0 and routes[name][route] == n,
          f"{what}: {name} launches by route {routes[name]}, want all {n} on {route}")


def bench_gpt(dtype, small=False):
    """The GPT of bench.py:2222 (vocab 32000, hidden 512, 8 layers, 8 heads,
    2 KV heads, context 8192), or a tiny one of the same shape for a
    rehearsal on the CPU."""
    from nos_tpu_torch import GPTConfig

    if small:
        return GPTConfig(vocab=97, hidden=32, layers=2, heads=4, kv_heads=2, max_seq=512,
                         dtype=dtype)
    return GPTConfig(vocab=32000, hidden=512, layers=8, heads=8, kv_heads=2, max_seq=8192,
                     dtype=dtype)


def engine_sizes(small):
    """(prompt buckets, max_len) of the engine runs."""
    return ((8, 16, 32), 512) if small else ((16, 32, 64, 128, 256), 8192)


def engine_traffic(cfg, small):
    """(max_new, six stream prompts, two long prompts) of the engine runs,
    from a numpy seed."""
    if small:
        max_new, lens, long_len = 40, [10, 17, 24, 31, 9, 28], 150
    else:
        max_new, lens, long_len = 128, [64, 96, 128, 160, 224, 256], 4096
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in lens]
    long_prompts = [rng.integers(1, cfg.vocab, long_len).tolist() for _ in range(2)]
    return max_new, prompts, long_prompts


def phase_engine(torch, device, dtype, small=False):
    from nos_tpu_torch import init_gpt

    cfg = bench_gpt(dtype, small)
    buckets, max_len = engine_sizes(small)
    max_new, prompts, long_prompts = engine_traffic(cfg, small)
    params = init_gpt(cfg, torch.Generator().manual_seed(0), device=device)
    outs, stats = serve(torch, cfg, params, device, prompts, long_prompts, max_new,
                        buckets, max_len)
    for o in outs:
        check(len(o) == max_new, f"a future returned {len(o)} tokens, not {max_new}")
    check(stats["prefill_window_dispatches"] > 0,
          "the long prompts' chunks never went through the multi-slot prefill window")
    if device.type == "cuda":  # bf16 windows take the tensor cores, f32 the simt kernel
        check_replays(stats, f"engine {dtype}")
        check_routes(stats["routes"], "paged_window_attention",
                     "mma" if dtype == "bfloat16" else "simt", f"engine {dtype}")
        check_routes(stats["routes"], "paged_decode_attention", "split", f"engine {dtype}")
    all_prompts = prompts + long_prompts
    kern = teacher_forced(torch, params, cfg, all_prompts, outs, buckets, 32, device)
    with plain_attention():
        plain = teacher_forced(torch, params, cfg, all_prompts, outs, buckets, 32, device)
    served = torch.tensor(outs, device=device)
    stats.update(agreement(torch, kern, plain, served, dtype))
    stats["dtype"] = dtype
    if device.type == "cuda" and dtype == "bfloat16":
        stats["step_profile"] = profile_decode_step(torch, cfg, params)
    log(f"engine {dtype}: " + json.dumps(stats))
    return stats


def agreement(torch, kern, plain, served, dtype):
    """The oracle's numbers. `top1_agreement`: the plain arm's greedy pick
    (lowest index among exact maxima) equals the served token, as
    runtime/divergence.py counts it. `top1_agreement_ties`: the served
    token attains the plain arm's maximum (exact ties count).
    `top1_agreement_1ulp`: the served token's plain logit lies within one
    rounding step of the logits' dtype below the plain maximum; in bf16 a
    32000-token vocabulary puts the top two logits in one or two adjacent
    bf16 steps at a few percent of positions, and which of them the
    lowest-index rule picks then turns on sub-step differences of the
    attention output's rounding. Also: the gaps of the disagreements in
    those steps, the share of exactly tied plain top-2, the kernel arm's
    agreement with the served tokens, and max and mean |dlogit| between
    the arms."""
    top = plain.max(dim=-1).values
    served_logit = plain.gather(-1, served[..., None].long())[..., 0]
    top2 = plain.topk(2, dim=-1).values
    mant = 7 if dtype == "bfloat16" else 23  # explicit mantissa bits of the head's output
    step = torch.exp2(torch.floor(torch.log2(top.abs().clamp_min(1e-30))) - mant)
    gap = (top - served_logit) / step
    wrong = greedy(torch, plain) != served
    miss = gap[wrong]
    return {
        "disagreements_at": wrong.nonzero()[:16].tolist(),
        "top1_agreement": (greedy(torch, plain) == served).float().mean().item(),
        "top1_agreement_ties": (served_logit == top).float().mean().item(),
        "top1_agreement_1ulp": (gap <= 1.0).float().mean().item(),
        "disagreement_gap_steps": sorted(miss.tolist()),
        "plain_top2_tied": (top2[..., 0] == top2[..., 1]).float().mean().item(),
        "top1_agreement_kernel_arm": (greedy(torch, kern) == served).float().mean().item(),
        "max_abs_dlogit": (kern - plain).abs().max().item(),
        "mean_abs_dlogit": (kern - plain).abs().mean().item(),
        "finite": bool(torch.isfinite(kern).all().item()
                       and torch.isfinite(plain).all().item()),
    }


# float32 in the radix and spec phases: a served token that is not the
# plain pass's pick must lie within this many f32 steps of its maximum, at
# no more than 1% of positions. The oracle prefills each prompt alone; the
# engine batches 8 prompts' chunks in one window (and serves cache hits and
# verify windows), programs of other shapes whose products round
# otherwise. Measured on an H100: 2 steps at 1 of 1024 positions (spec
# 8stream_mixed f32, spec off).
F32_CROSS_SHAPE_STEPS = 4


def check_logits(stats, what, f32_steps=0):
    """The teacher-forced oracle's bounds (runtime/divergence.py:43,48:
    max|dlogit| <= 0.5, top-1 agreement >= 0.98). In float32 the served
    tokens must be the plain programs' greedy picks at every position (with
    `f32_steps`, at 99% of them and within that many f32 steps of the
    plain maximum at the rest). In
    bf16 the strict rate is printed, not gated: a random model's flat
    32000-token logits put the plain top two within one bf16 step at a
    few percent of positions, where the lowest-index pick turns on
    sub-step rounding of the attention output (PERF.md). The bf16 gate
    counts a served token within one step of the plain maximum as a
    top-1 pick, and holds the kernel arm's logits against the plain
    arm's at limits pinned from measured runs."""
    dtype = stats["dtype"]
    check(stats["finite"], f"{what} {dtype}: non-finite logits")
    check(stats["max_abs_dlogit"] <= 0.5,
          f"{what} {dtype}: max|dlogit| {stats['max_abs_dlogit']} > 0.5")
    if dtype == "float32":
        gaps = stats["disagreement_gap_steps"]
        check(stats["top1_agreement"] == 1.0 or (
            f32_steps and stats["top1_agreement"] >= 0.99 and max(gaps) <= f32_steps),
              f"{what} float32: top-1 agreement {stats['top1_agreement']} < 1.0, "
              f"gaps {gaps} (f32 steps allowed {f32_steps})")
        return
    check(stats["top1_agreement_1ulp"] >= 0.98,
          f"{what} {dtype}: top-1 agreement within a step "
          f"{stats['top1_agreement_1ulp']} < 0.98")
    check(stats["max_abs_dlogit"] <= MAX_DLOGIT_BF16,
          f"{what} {dtype}: max|dlogit| {stats['max_abs_dlogit']} > {MAX_DLOGIT_BF16}")
    check(stats["mean_abs_dlogit"] <= MEAN_DLOGIT_BF16,
          f"{what} {dtype}: mean|dlogit| {stats['mean_abs_dlogit']} > {MEAN_DLOGIT_BF16}")


def profile_steps(torch, run, steps, kernel_tag):
    """Where one window of `steps` decode steps' time goes, under
    torch.profiler: host wall per step, device kernel time per step (sum of
    CUDA kernel intervals; one stream, so no overlap), the busy share,
    kernels launched per step, and the time and share of the kernels whose
    name holds `kernel_tag`. `run()` runs the window; it runs once before
    the profiled window as a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_kernels, dev_us, attn_us = 0, 0.0, 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n_kernels += 1
            us = e.time_range.elapsed_us()
            dev_us += us
            if kernel_tag in e.name:
                attn_us += us
    return {
        "wall_ms_per_step": 1e3 * wall / steps,
        "device_ms_per_step": dev_us / 1e3 / steps,
        "device_busy_share": (dev_us / 1e6) / wall if wall else None,
        "kernels_per_step": n_kernels / steps,
        "attention_ms_per_step": attn_us / 1e3 / steps,
        "attention_share_of_device": attn_us / dev_us if dev_us else None,
    }


def profile_decode_step(torch, cfg, params, steps=16, mesh=None, kv_dtype=None):
    """One macro window of the paged engine: 16 decode steps at the main
    path's B=8 lanes (MAIN_DECODE_LIMITS); tensor-parallel over a mesh's
    "tp" shards when one is given; over an int8 pool with `kv_dtype`."""
    from nos_tpu_torch.models import decode as D

    tp = None
    if mesh is not None:
        params, _, tp = D.place_tp(params, cfg, mesh)
    B, BS = 8, 32
    P = -(-max(MAIN_DECODE_LIMITS) // BS) + 1
    cache = D.init_paged_cache(cfg, 1 + B * P, BS, kv_dtype=kv_dtype, device="cuda", mesh=mesh)
    table = (torch.arange(B * P, dtype=torch.int32, device="cuda") + 1).reshape(B, P)
    pos0 = torch.tensor(MAIN_DECODE_LIMITS, dtype=torch.int32, device="cuda") - 1
    token = torch.ones((B,), dtype=torch.int32, device="cuda")
    mask = torch.ones((B,), dtype=torch.bool, device="cuda")

    def run():
        for k in range(steps):
            D.paged_decode_step(params, token, cfg, cache, table, pos0 + k, mask, BS, tp=tp)

    return profile_steps(torch, run, steps, "split_decode_kernel")


# -- phase: graph ------------------------------------------------------------------
# The graph phase's lanes on the CPU rehearsal (the card runs
# MAIN_DECODE_LIMITS).
GRAPH_SMALL_LIMITS = [9, 11, 13, 15, 19, 21, 260, 260]


def graph_engine(torch, cfg, params, device, small, **engine_kw):
    """An engine at the serving settings (8 slots, K 16, default bursts)
    whose 8 lanes decode from the main path's positions (prompts one token
    shorter than MAIN_DECODE_LIMITS, prefilled unbudgeted in one tick,
    which also runs the first window), its tick state synced. `engine_kw`
    (`kv_dtype`) goes to the engine."""
    from nos_tpu_torch import DecodeServer

    buckets, max_len = engine_sizes(small)
    server = DecodeServer(params, cfg, n_slots=8, max_len=max_len, prompt_buckets=buckets,
                          steps_per_dispatch=16, prefill_budget_tokens=0, device=device,
                          **engine_kw)
    rng = np.random.default_rng(5)
    limits = GRAPH_SMALL_LIMITS if small else MAIN_DECODE_LIMITS
    max_new = 128 if small else 1024  # more than the phase's ~37 windows of 16
    futs = [server.submit(rng.integers(1, cfg.vocab, n - 1).tolist(), max_new)
            for n in limits]
    server._tick()
    check(all(s.active and s.phase == "decoding" for s in server._slots),
          "graph: the lanes are not decoding after one tick")
    server._sync_tick_state()
    return server, futs


def window_tensors(server):
    """What a window reads and writes in place: pos, step, steps_left, the
    last tokens, the eos carry, then every pool tensor (an int8 pool's
    scales too)."""
    st = server._tick_state
    pools = server.cache if isinstance(server.cache, list) else [server.cache]
    return ([st.pos, st.step, st.steps_left, server._last_dev, server._finished]
            + [t for pool in pools for layer in pool.values() for t in layer.values()])


def replay_against_eager(torch, server):
    """One window from one engine state, run as the eager `_macro` and as
    the captured graph's replay: its tokens, the advanced state, the pool
    outside the scratch page (block 0, which masked lanes write in no fixed
    order) byte for byte, and the launches each added."""
    from nos_tpu_torch.runtime import decode_server as ds

    tensors = window_tensors(server)
    start = [t.clone() for t in tensors]
    runs = []
    for run in (server._macro, server._window):
        for t, v in zip(tensors, start):
            t.copy_(v)
        before = ds._launch_counts()
        toks = run().clone()
        sync(torch, toks.device)
        after = ds._launch_counts()
        runs.append((toks, [t.clone() for t in tensors],
                     sum(n - before[k] for k, n in after.items())))
    (toks_e, state_e, n_e), (toks_g, state_g, n_g) = runs
    pools = list(zip(state_g[5:], state_e[5:]))
    stats = {
        "tokens_equal": bool(torch.equal(toks_g, toks_e)),
        "state_equal": all(torch.equal(g, e) for g, e in zip(state_g[:5], state_e[:5])),
        "pool_bytes_equal": all(torch.equal(g[1:].view(torch.uint8), e[1:].view(torch.uint8))
                                for g, e in pools),
        "pool_max_abs_diff": max((g[1:].float() - e[1:].float()).abs().max().item()
                                 for g, e in pools),
        "launches_eager": n_e, "launches_replay": n_g,
        "advanced": not torch.equal(state_e[0], start[0]),
    }
    return stats


def window_ms(torch, run, iters=5):
    """CUDA-event ms per window over `iters` windows after one warm-up: the
    wall of a window as the stream sees it (no L2 flush)."""
    run()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def issue_ms(torch, run, iters=10):
    """Host ms to issue one window: `iters` calls with no synchronize
    between them (the queue drained before and after), over the host
    clock. For a replay, the host's whole share of a window."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * dt / iters


def phase_graph(torch, device, small=False):
    """The engine's captured decode window. (1) From one engine state at the
    serving shape (8 lanes at MAIN_DECODE_LIMITS, K 16), in bf16 and f32:
    the replay against the eager `_macro`, tokens, state and pool pages
    byte for byte, launches equal. (2) bf16: torch.profiler over one
    16-step window replayed and one eager, from that engine, CUDA-event ms
    per window of each, and the host ms to issue one. (3) The engine
    phase's bf16 traffic served with burst_windows=1 and with the default
    4, in turns (1, 4, 4, 1): tok/s, long-prompt TTFT, dispatch and replay
    counters."""
    from nos_tpu_torch import init_gpt

    t0 = time.perf_counter()
    cuda = device.type == "cuda"
    stats = {}
    main_dtype = "float32" if small else "bfloat16"
    for dtype in ("float32",) if small else ("bfloat16", "float32"):
        cfg = bench_gpt(dtype, small)
        params = init_gpt(cfg, torch.Generator().manual_seed(0), device=device)
        server, futs = graph_engine(torch, cfg, params, device, small)
        run = replay_against_eager(torch, server)
        run["graph_captures"] = server.graph_captures
        check(run["tokens_equal"] and run["state_equal"] and run["advanced"],
              f"graph {dtype}: the replayed window differs from the eager one: {run}")
        check(run["pool_bytes_equal"] and run["launches_eager"] == run["launches_replay"],
              f"graph {dtype}: pool pages or launches differ: {run}")
        if cuda:
            check(server.graph_captures == 1 and run["launches_replay"] > 0,
                  f"graph {dtype}: no captured window, or it launched no kernel: {run}")
        if cuda and dtype == main_dtype:
            run["window_eager"] = profile_steps(torch, server._macro, 16, "split_decode_kernel")
            run["window_replay"] = profile_steps(torch, server._window, 16,
                                                 "split_decode_kernel")
            run["window_event_ms_eager"] = window_ms(torch, server._macro)
            run["window_event_ms_replay"] = window_ms(torch, server._window)
            run["window_issue_ms_eager"] = issue_ms(torch, server._macro)
            run["window_issue_ms_replay"] = issue_ms(torch, server._window)
        for f in futs:
            f.cancel()
        server.stop()
        del server
        stats[dtype] = run
        log(f"graph {dtype}: " + json.dumps(run))
    cfg = bench_gpt(main_dtype, small)
    params = init_gpt(cfg, torch.Generator().manual_seed(0), device=device)
    buckets, max_len = engine_sizes(small)
    max_new, prompts, long_prompts = engine_traffic(cfg, small)
    serving = []
    for bw in (1, 4, 4, 1):
        outs, st = serve(torch, cfg, params, device, prompts, long_prompts, max_new, buckets,
                         max_len, burst_windows=bw)
        check(all(len(o) == max_new for o in outs), f"graph burst_windows={bw}: short output")
        check((st["burst_dispatches"] > 0) == (bw > 1),
              f"graph burst_windows={bw}: {st['burst_dispatches']} bursts")
        if cuda:
            check_replays(st, f"graph burst_windows={bw}", bursts=bw > 1)
        serving.append({k: st[k] for k in (
            "burst_windows", "decode_tok_per_s", "long_prompt_ttft_s", "wall_s", "steps_run",
            "macro_dispatches", "burst_dispatches", "burst_windows_run", "graph_replays",
            "tick_phase_s")})
    stats["serving"] = serving
    stats["phase_s"] = time.perf_counter() - t0
    log("graph serving: " + json.dumps(serving))
    return stats


# -- phase: tp ---------------------------------------------------------------------
SHARDED = ("paged_decode_attention_sharded", "paged_window_attention_sharded")
SHARDED_REPLACES = {"paged_decode_attention_sharded": "nos_tpu/ops/paged_attention.py:193",
                    "paged_window_attention_sharded": "nos_tpu/ops/paged_attention.py:226"}


def _heads(x, n=2):
    """x split into n contiguous shards on its head axis (dim 1)."""
    return [t.contiguous() for t in x.chunk(n, dim=1)]


def check_sharded(torch):
    """The sharded kernels at the serving shapes over two shards (nh 4, nkv
    1 per shard: the bench GPT at tp=2), f32 and bf16: each shard's output
    equals the unsharded kernel's on the same heads bit for bit, and the
    gathered output is held against the plain version (`held`). Decode at
    the main path's limits and at edge limits; windows of 16 and 256 with
    ragged lengths and masked lanes, and the main path's two-lane wave.
    Returns the worst max|err| and relative error per kernel."""
    from nos_tpu_torch.ops import paged_attention as pa

    B, NH, NKV, HD, BS = 8, 8, 2, 64, 32
    P = 8192 // BS
    T = 1 + B * P
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = {n + sfx: 0.0 for n in SHARDED for sfx in ("", "_rel")}
    for dtype in ("float32", "bfloat16"):
        k, v, _, _, dt = _pools(torch, gen, dtype, T, NKV, BS, HD)
        ks, vs = _heads(k), _heads(v)
        table = _table(torch, gen, B, P, T)
        q = torch.randn((B, NH, HD), generator=gen, device="cuda").to(dt)
        for limits in (MAIN_DECODE_LIMITS, [1, 31, 32, 33, 2048, 8192, 100, 4160],
                       split_limits(split_keys())):
            tab = table.clone()
            tab[:, -(-max(limits) // BS):] = 0
            lim = torch.tensor(limits, dtype=torch.int32, device="cuda")
            got = torch.cat(pa.paged_decode_attention_sharded(_heads(q), ks, vs, tab, lim), 1)
            whole = pa.paged_decode_attention(q, k, v, tab, lim)
            torch.cuda.synchronize()
            check(torch.equal(got, whole),
                  f"paged_decode_attention_sharded {dtype} limits={limits}: differs from the "
                  f"unsharded kernel by {(got.float() - whole.float()).abs().max().item()}")
            held(torch, got, pa._reference(q, k, v, tab, lim), dtype,
                 f"paged_decode_attention_sharded limits={limits}", worst)
        windows = [(16, [0, 31, 33, 1000, 2047, 4096, 7000, 8192 - 16], [16, 1, 13, 16, 5, 16, 8, 16],
                    [True, True, True, False, True, True, False, True]),
                   (256, [0, 31, 33, 1000, 2047, 4096, 7000, 8192 - 256],
                    [256, 1, 253, 256, 5, 256, 128, 256],
                    [True, True, True, False, True, True, False, True]),
                   (256, [2048] * B, [256] * B, [False] * 6 + [True, True])]
        for w, pos, lengths, mask in windows:
            qw = torch.randn((B, NH, w, HD), generator=gen, device="cuda").to(dt)
            args = [torch.tensor(x, device="cuda", dtype=torch.bool if x is mask else torch.int32)
                    for x in (pos, lengths, mask)]
            got = torch.cat(pa.paged_window_attention_sharded(_heads(qw), ks, vs, table, *args), 1)
            whole = pa.paged_window_attention(qw, k, v, table, *args)
            torch.cuda.synchronize()
            check(torch.equal(got, whole),
                  f"paged_window_attention_sharded {dtype} W={w}: differs from the unsharded "
                  f"kernel by {(got.float() - whole.float()).abs().max().item()}")
            held(torch, got, pa._window_reference(qw, k, v, table, *args), dtype,
                 f"paged_window_attention_sharded W={w}", worst)
        del k, v, ks, vs
    log(f"kernels sharded: bit-identical to the unsharded kernel per head, and within "
        f"{json.dumps(TOL)} of the plain versions (worst {json.dumps(worst)})")
    return worst


def time_sharded(torch):
    """The sharded kernels at the tp=2 main path's shapes, bf16 pool split
    over two shards: the decode step's B=8 lanes at MAIN_DECODE_LIMITS, and
    the two-lane 256-token window wave at position 2048. ms is one sharded
    call (both shards' launches), plain the plain version per shard, and
    library SDPA over each shard's heads on its pre-gathered cache. The
    bound sums the two shards: each reads its half of the K/V bytes and of
    q and out, and all of the table and limits."""
    from nos_tpu_torch.ops import paged_attention as pa
    from nos_tpu_torch.runtime.mfu import H100_BF16_PEAK_FLOPS

    B, NH, NKV, HD, BS = 8, 8, 2, 64, 32
    P = 8192 // BS
    T = 1 + B * P
    gen = torch.Generator(device="cuda").manual_seed(7)
    k, v, _, _, dt = _pools(torch, gen, "bfloat16", T, NKV, BS, HD)
    ks, vs = _heads(k), _heads(v)
    table = _table(torch, gen, B, P, T)
    table[1, :8] = torch.arange(9, 17, device="cuda", dtype=torch.int32)  # no sharing
    shards = range(2)

    def bound(nbytes, flops):
        by_bytes = nbytes / H100_BYTES_PER_S >= flops / H100_BF16_PEAK_FLOPS
        return {"bound_ms": 1e3 * max(nbytes / H100_BYTES_PER_S, flops / H100_BF16_PEAK_FLOPS),
                "bound_by": "bytes" if by_bytes else "operations", "bytes": nbytes,
                "flops": flops}

    def dense(pool, tab, s):
        return pa._gather_pool(pool[s], tab, None, dt).repeat_interleave(NH // NKV, dim=1)

    out = {}
    lim = torch.tensor(MAIN_DECODE_LIMITS, dtype=torch.int32, device="cuda")
    qs = _heads(torch.randn((B, NH, HD), generator=gen, device="cuda").to(dt))
    tab = table[:, :-(-max(MAIN_DECODE_LIMITS) // BS)].contiguous()
    kd, vd = [dense(ks, tab, s) for s in shards], [dense(vs, tab, s) for s in shards]
    mask = (torch.arange(kd[0].shape[2], device="cuda")[None, :] < lim[:, None])[:, None, None, :]
    out["decode"] = {
        "ms": time_cuda(torch, lambda: pa.paged_decode_attention_sharded(qs, ks, vs, tab, lim)),
        "device_ms": device_ms(torch, lambda: pa.paged_decode_attention_sharded(
            qs, ks, vs, tab, lim)),
        "plain_ms": time_cuda(torch, lambda: [pa._reference(qs[s], ks[s], vs[s], tab, lim)
                                              for s in shards]),
        "library_ms": time_cuda(torch, lambda: [_sdpa_decode(torch, qs[s][:, :, None, :], kd[s],
                                                             vd[s], mask) for s in shards]),
        **bound(2 * decode_bytes(MAIN_DECODE_LIMITS, NH // 2, NKV // 2, HD, BS, 2, 2),
                4.0 * NH * HD * sum(MAIN_DECODE_LIMITS)),
    }
    W, pos0 = 256, 2048
    active = torch.tensor([False] * 6 + [True, True], device="cuda")
    qw = _heads(torch.randn((B, NH, W, HD), generator=gen, device="cuda").to(dt))
    tab = table[:, :-(-(pos0 + W) // BS)].contiguous()
    pos = torch.full((B,), pos0, dtype=torch.int32, device="cuda")
    lengths = torch.full((B,), W, dtype=torch.int32, device="cuda")
    kd, vd = [dense(ks, tab, s) for s in shards], [dense(vs, tab, s) for s in shards]
    wlim = torch.where(active[:, None], pos0 + torch.arange(W, device="cuda")[None, :] + 1, 1)
    causal = (torch.arange(kd[0].shape[2], device="cuda")[None, None, :]
              < wlim[:, :, None])[:, None]
    pages = sum(-(-int(x) // BS) for x in wlim.max(dim=1).values.tolist())
    shard_bytes = (pages * (NKV // 2) * BS * HD * 2 * 2 + 2 * B * (NH // 2) * W * HD * 2
                   + 4 * pages + 9 * B)
    out["window"] = {
        "ms": time_cuda(torch, lambda: pa.paged_window_attention_sharded(
            qw, ks, vs, tab, pos, lengths, active)),
        "plain_ms": time_cuda(torch, lambda: [pa._window_reference(
            qw[s], ks[s], vs[s], tab, pos, lengths, active) for s in shards]),
        "library_ms": time_cuda(torch, lambda: [_sdpa_decode(torch, qw[s], kd[s], vd[s], causal)
                                                for s in shards]),
        **bound(2 * shard_bytes, 4.0 * NH * HD * float(wlim.sum().item())),
    }
    log("sharded_kernel_times " + json.dumps(out))
    return out


def tick_until(server, done):
    """Drive an engine on this thread, as its loop would, until `done()`."""
    while not done():
        server._tick()


def tp_serve(torch, cfg, params, device, mesh, prompts, long_prompts, max_new, buckets,
             max_len, **engine_kw):
    """The engine phase's traffic and settings, at tp=2 over `mesh` or at
    tp=1 (mesh None), driven tick by tick on this thread: the loop start()'s
    thread runs, without a thread's timing, so both widths see one schedule
    and their counters compare. Launch counts are zeroed just before the
    run and read just after. `engine_kw` (`burst_windows`) goes to the
    engine. Returns (outputs in submit order, stats)."""
    from nos_tpu_torch import DecodeServer
    from nos_tpu_torch.ops import paged_attention as pa

    def engine():
        return DecodeServer(params, cfg, n_slots=8, max_len=max_len, prompt_buckets=buckets,
                            steps_per_dispatch=16, prefill_budget_tokens=2 * buckets[-1],
                            mesh=mesh, device=None if mesh is not None else device,
                            tracing=profiled(), **engine_kw)

    warm = engine()  # warm-up (not counted): one short request through both programs
    fut = warm.submit(prompts[0][:40], 20)
    tick_until(warm, fut.done)
    fut.result()
    del warm
    server = engine()
    sync(torch, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    pa.reset_launch_counts()
    t0 = time.perf_counter()
    futs = [server.submit(p, max_new) for p in prompts]
    tick_until(server, lambda: server.steps_run >= 2)  # the streams are decoding
    t_long = time.perf_counter()
    futs += [server.submit(p, max_new) for p in long_prompts]
    tick_until(server, lambda: all(f.done() for f in futs))
    outs = [f.result() for f in futs]
    stats = serve_stats(torch, server, device, t0, t_long, len(futs), max_new,
                        len(long_prompts))
    stats["tp"] = server.tp
    if server.tp > 1 and server.kv_quant_enabled:
        stats["scale_copies_equal"] = all(
            torch.equal(a[n], b[n].to(a[n].device))
            for a, b in zip(server.cache[0].values(), server.cache[1].values())
            for n in ("k_scale", "v_scale"))
    server.stop()
    return outs, stats


def phase_tp(torch, device, small=False):
    """Tensor-parallel serving at tp=2 with both shards on one device, against
    tp=1 on the same traffic. Returns the stats; the bf16 tp=2 run is the
    main path."""
    from nos_tpu_torch import init_gpt
    from nos_tpu_torch.parallel import build_mesh

    t0 = time.perf_counter()
    cuda = device.type == "cuda"
    mesh = build_mesh({"tp": 2}, devices=[device, device])
    buckets, max_len = engine_sizes(small)
    stats = {}
    if cuda:
        stats["kernels"] = check_sharded(torch)
        stats["times"] = time_sharded(torch)
    for dtype in ("float32",) if small else ("bfloat16", "float32"):
        cfg = bench_gpt(dtype, small)
        params = init_gpt(cfg, torch.Generator().manual_seed(0), device=device)
        max_new, prompts, long_prompts = engine_traffic(cfg, small)
        run = {}
        outs1, run["tp1"] = tp_serve(torch, cfg, params, device, None, prompts, long_prompts,
                                     max_new, buckets, max_len)
        outs2, run["tp2"] = tp_serve(torch, cfg, params, device, mesh, prompts, long_prompts,
                                     max_new, buckets, max_len)
        # Teacher-forced over the tp=2 engine's tokens: tp=2 programs against
        # tp=1 programs (both through the kernels on the card).
        all_prompts = prompts + long_prompts
        t1 = teacher_forced(torch, params, cfg, all_prompts, outs2, buckets, 32, device)
        t2 = teacher_forced(torch, params, cfg, all_prompts, outs2, buckets, 32, device,
                            mesh=mesh)
        run.update(agreement(torch, t2, t1, torch.tensor(outs2, device=device), dtype))
        run["dtype"] = dtype
        run["engine_token_match"] = float(np.mean(np.array(outs1) == np.array(outs2)))
        for c in BUDGET_COUNTERS:
            check(run["tp2"][c] == run["tp1"][c],
                  f"tp {dtype}: {c} {run['tp2'][c]} at tp=2, {run['tp1'][c]} at tp=1")
        if cuda:
            check_replays(run["tp1"], f"tp {dtype} tp=1")
            check_replays(run["tp2"], f"tp {dtype} tp=2")
            l1, l2 = run["tp1"]["launches"], run["tp2"]["launches"]
            for name, sharded in zip(("paged_decode_attention", "paged_window_attention"),
                                     SHARDED):
                check(l1[name] > 0 and l1[sharded] == 0 and l2[name] == 0
                      and l2[sharded] == 2 * l1[name],
                      f"tp {dtype}: launches {l2} at tp=2 against {l1} at tp=1")
            window_route = "mma" if dtype == "bfloat16" else "simt"
            check_routes(run["tp2"]["routes"], "paged_window_attention_sharded", window_route,
                         f"tp {dtype} tp=2")
            check_routes(run["tp1"]["routes"], "paged_window_attention", window_route,
                         f"tp {dtype} tp=1")
            check_routes(run["tp2"]["routes"], "paged_decode_attention_sharded", "split",
                         f"tp {dtype} tp=2")
            check_routes(run["tp1"]["routes"], "paged_decode_attention", "split",
                         f"tp {dtype} tp=1")
        if dtype == "float32":
            check(outs2 == outs1, f"tp float32: {run['engine_token_match']} of the tp=2 "
                  f"tokens equal tp=1's")
        check_logits(run, "tp")
        if cuda and dtype == "bfloat16":
            run["step_profile_tp1"] = profile_decode_step(torch, cfg, params)
            run["step_profile_tp2"] = profile_decode_step(torch, cfg, params, mesh=mesh)
        if dtype == ("float32" if small else "bfloat16"):
            # The main path's traffic with every window its own tick, at
            # both widths: what bursts change end to end.
            for w, m in (("tp1", None), ("tp2", mesh)):
                outs, run[f"{w}_burst1"] = tp_serve(torch, cfg, params, device, m, prompts,
                                                    long_prompts, max_new, buckets, max_len,
                                                    burst_windows=1)
                check(run[f"{w}_burst1"]["burst_dispatches"] == 0,
                      f"tp {dtype} {w}: burst_windows=1 dispatched a burst")
                if cuda:
                    check_replays(run[f"{w}_burst1"], f"tp {dtype} {w} burst_windows=1",
                                  bursts=False)
        log(f"tp {dtype}: " + json.dumps(run))
        stats[dtype] = run
    main = stats["float32" if small else "bfloat16"]
    summary = {w: {k: main[w][k] for k in ("decode_tok_per_s", "long_prompt_ttft_s", "wall_s",
                                           "peak_mem_bytes", "launches", "burst_dispatches",
                                           "graph_replays")}
               for w in ("tp1", "tp2", "tp1_burst1", "tp2_burst1")}
    for w in ("tp1", "tp2"):
        if f"step_profile_{w}" in main:
            summary[w]["step_profile"] = main[f"step_profile_{w}"]
    summary.update({k: main[k] for k in ("dtype", "engine_token_match", "top1_agreement",
                                         "top1_agreement_1ulp", "max_abs_dlogit",
                                         "mean_abs_dlogit")})
    if not small:
        summary["float32"] = {k: stats["float32"][k] for k in (
            "engine_token_match", "top1_agreement", "max_abs_dlogit", "mean_abs_dlogit")}
    summary["phase_s"] = stats["phase_s"] = time.perf_counter() - t0
    log("tp: " + json.dumps(summary))
    return stats


# -- phase: radix ------------------------------------------------------------------
CHAT = {"n_convs": 8, "sys": 2048, "shared": 16, "greet": 64, "user": 200, "gen": 128,
        "turns": 3}
CHAT_SMALL = {"n_convs": 4, "sys": 128, "shared": 16, "greet": 24, "user": 20, "gen": 12,
              "turns": 3}
COPY_CHECKS = 4  # copy-ins and COW copies read back and held, per arm


def chat_traffic(cfg, small):
    """Multi-turn chat, the shape of bench.py::_multi_turn_chat at full width:
    conversations over two system prompts (three quarters on the first), each
    greeting a shared head of `shared` tokens inside one block, then its own
    tokens (so COW serves the head), and a user message per later turn. From
    a numpy seed."""
    c = CHAT_SMALL if small else CHAT
    rng = np.random.default_rng(13)
    sys_prompts = [rng.integers(1, cfg.vocab, c["sys"]).tolist() for _ in range(2)]
    head = rng.integers(1, cfg.vocab, c["shared"]).tolist()
    first = [sys_prompts[0 if i < 3 * c["n_convs"] // 4 else 1] + head
             + rng.integers(1, cfg.vocab, c["greet"] - c["shared"]).tolist()
             for i in range(c["n_convs"])]
    users = [[rng.integers(1, cfg.vocab, c["user"]).tolist() for _ in range(c["n_convs"])]
             for _ in range(c["turns"] - 1)]
    return dict(c, first=first, users=users)


def spill_pool_blocks(chat, block_size=32):
    """A pool two last-turn requests fill: each turn evicts other
    conversations' paths to the host tier, and their next turn revives
    them."""
    longest = (len(chat["first"][0]) + (chat["turns"] - 1) * (chat["user"] + chat["gen"])
               + chat["gen"])
    return 1 + 2 * -(-longest // block_size)


def checked_copies(torch, server, seen):
    """Wrap the engine's copy-in (`_revive`) and COW copy (`_cow_copy`): the
    first COPY_CHECKS of each read the block back at once (full width) and
    hold it byte for byte against the payload (codes and scales for an int8
    pool), or the COW destination's first `length` rows against its
    source's (an int8 pool: the scales equal too, the tail zeroed).
    Instrumentation only: the package has no such hook."""
    revive, cow = server._revive, server._cow_copy

    def raw(t):
        return t.contiguous().view(torch.uint8)

    def checked_revive(tensors, block):
        revive(tensors, block)
        if seen["revive"] < COPY_CHECKS:
            got = [t[:, 0] for t in server._gather_blocks([block])]
            check(len(got) == len(tensors)
                  and all(torch.equal(raw(g), raw(t)) for g, t in zip(got, tensors)),
                  f"radix: block {block} differs from the payload revived into it")
            seen["revive"] += 1

    def checked_cow(src, dst, length):
        cow(src, dst, length)
        if seen["cow"] < COPY_CHECKS:
            s, d = ([t[:, 0] for t in server._gather_blocks([b])] for b in (src, dst))
            ok = all(torch.equal(raw(dt[:, :, :length]), raw(st[:, :, :length]))
                     for st, dt in zip(s[:2], d[:2]))
            if len(s) == 4:
                ok = ok and all(torch.equal(raw(dt), raw(st)) for st, dt in zip(s[2:], d[2:]))
                ok = ok and not any(dt[:, :, length:].any().item() for dt in d[:2])
            check(ok, f"radix: COW block {dst} differs from its source {src} in {length} rows")
            seen["cow"] += 1

    server._revive, server._cow_copy = checked_revive, checked_cow


def chat_run(torch, cfg, params, device, chat, buckets, max_len, **engine_kw):
    """Serve the chat on the threaded engine, turn by turn: conversation 0's
    first turn alone (its prefix is what the others' greetings diverge from,
    mid-block), then the rest of the turn together; each later turn
    re-submits every history grown by its output and a user message. Launch
    counts are zeroed just before the run and read just after. Returns
    (prompts, outputs, stats, the stopped server)."""
    from nos_tpu_torch import DecodeServer
    from nos_tpu_torch.ops import paged_attention as pa

    server = DecodeServer(params, cfg, n_slots=8, max_len=max_len, prompt_buckets=buckets,
                          steps_per_dispatch=16, prefill_budget_tokens=2 * buckets[-1],
                          device=device, tracing=profiled(), **engine_kw)
    seen = {"revive": 0, "cow": 0}
    checked_copies(torch, server, seen)
    n, gen = chat["n_convs"], chat["gen"]
    histories = [list(h) for h in chat["first"]]
    prompts, outs = [], []
    sync(torch, device)
    pa.reset_launch_counts()
    t0 = time.perf_counter()
    server.start()
    try:
        for turn in range(chat["turns"]):
            got = [server.generate(histories[0], gen, timeout=900)] if turn == 0 else []
            futs = [server.submit(h, gen) for h in histories[len(got):]]
            got += [f.result(timeout=900) for f in futs]
            if turn == 0:
                n_first = len(server.ttft_s)
            prompts += [list(h) for h in histories]
            outs += got
            if turn + 1 < chat["turns"]:
                histories = [h + o + u for h, o, u in zip(histories, got, chat["users"][turn])]
        sync(torch, device)
        wall = time.perf_counter() - t0
    finally:
        server.stop()
    later = sorted(server.ttft_s[n_first:])
    stats = {
        "wall_s": wall, "decode_tok_per_s": n * chat["turns"] * gen / wall,
        "ttft_first_turn_s": server.ttft_s[:n_first],
        "ttft_later_p50_s": later[len(later) // 2], "ttft_later_max_s": later[-1],
        "copies_checked": dict(seen),
        **{c: getattr(server, c) for c in RADIX_COUNTERS},
        "tick_phase_s": server.tick_phase_s,
        "launches": dict(pa.LAUNCHES),
        "routes": {k: dict(r) for k, r in pa.ROUTE_LAUNCHES.items()},
    }
    return prompts, outs, stats, server


RADIX_COUNTERS = ("prefill_tokens", "prefix_hit_tokens", "prefix_cow_hits", "prefix_cow_tokens",
                  "output_blocks_registered", "radix_nodes", "prefix_evictions", "spills",
                  "revives", "spill_drops", "spill_host_bytes", "macro_dispatches",
                  "burst_windows_run", "graph_captures", "graph_replays", "burst_dispatches",
                  "blocking_syncs")


class TeacherForced:
    """Teacher-forced agreement of served tokens, one pass per distinct
    (prompts, outputs): arms that served the same tokens share it."""

    def __init__(self, torch, params, cfg, buckets, device):
        self.args = (torch, params, cfg)
        self.buckets, self.device = buckets, device
        self.done = {}

    def __call__(self, prompts, outs, dtype):
        key = (tuple(map(tuple, prompts)), tuple(map(tuple, outs)))
        if key not in self.done:
            torch, params, cfg = self.args
            kern = teacher_forced(torch, params, cfg, prompts, outs, self.buckets, 32,
                                  self.device)
            with plain_attention():
                plain = teacher_forced(torch, params, cfg, prompts, outs, self.buckets, 32,
                                       self.device)
            served = torch.tensor(outs, device=self.device)
            self.done[key] = dict(agreement(torch, kern, plain, served, dtype), dtype=dtype)
            del kern, plain
        return self.done[key]


def check_main_routes(stats, what, dtype, window="paged_window_attention",
                      decode="paged_decode_attention"):
    """An engine run launched both paged kernels, the decode kernel on
    "split" and the window on "mma" in bf16 ("simt" in f32)."""
    check_routes(stats["routes"], window, "mma" if dtype == "bfloat16" else "simt", what)
    check_routes(stats["routes"], decode, "split", what)


def payload_across_widths(torch, server, cfg, params, device):
    """A block of the served pool, placed in a tp=2 engine (two shards on the
    card) by its KV-head halves: the tp=2 copy-out equals the tp=1 payload
    byte for byte, and the tp=2 copy-in of the tp=1 payload writes each
    shard its half."""
    from nos_tpu_torch import DecodeServer
    from nos_tpu_torch.parallel import build_mesh

    block = next(b for b in range(1, server.total_blocks)
                 if server._gather_blocks([b])[0].abs().sum().item() > 0)
    (k, v), nbytes = server._extract_block(block)
    mesh = build_mesh({"tp": 2}, devices=[device, device])
    two = DecodeServer(params, cfg, n_slots=1, max_len=64, prompt_buckets=(8,),
                       total_blocks=4, mesh=mesh, spill_blocks=0)
    width = cfg.n_kv // 2
    for s, pool in enumerate(two.cache):
        for i, layer in pool.items():
            layer["k"][1].copy_(k[int(i), s * width:(s + 1) * width])
            layer["v"][1].copy_(v[int(i), s * width:(s + 1) * width])
    (k2, v2), nbytes2 = two._extract_block(1)
    raw = lambda t: t.view(torch.uint8)  # noqa: E731
    check(nbytes2 == nbytes and torch.equal(raw(k2), raw(k)) and torch.equal(raw(v2), raw(v)),
          "radix: the tp=2 payload differs from the tp=1 payload of the same block")
    two._dispatch_revive((k, v), 2)
    for s, pool in enumerate(two.cache):
        for i, layer in pool.items():
            check(torch.equal(raw(layer["k"][2].cpu()), raw(k[int(i), s * width:(s + 1) * width]))
                  and torch.equal(raw(layer["v"][2].cpu()),
                                  raw(v[int(i), s * width:(s + 1) * width])),
                  "radix: the tp=2 copy-in wrote a shard other than its half")
    two.stop()
    return {"block": block, "nbytes": nbytes}


def copy_ms(torch, server):
    """CUDA-event ms of one block's copy-out (`_extract_block`: the stacked
    gather and the blocking copy to host) and one copy-in
    (`_dispatch_revive`: two uploads and the in-place copy) at the served
    pool's shape; the copy-in writes block 0, the scratch page."""
    (payload, _) = server._extract_block(1)
    return {"extract_ms": time_cuda(torch, lambda: server._extract_block(1)),
            "revive_ms": time_cuda(torch, lambda: server._dispatch_revive(payload, 0))}


def phase_radix(torch, device, small=False):
    """The radix cache and the spill tier at the serving cell's width. The
    bench GPT (bf16, the main path, then f32) on the engine's defaults
    serves the multi-turn chat in four arms: the radix tree, the flat chain
    (`radix_cache=False`), cold (`prefix_cache=False`), and the tree over a
    pool small enough that later turns spill other conversations' paths to
    the host tier and revive them. Gates: every arm's tokens against a
    teacher-forced plain pass (check_logits); COW hits and registered output
    blocks in the tree arm, spills and revives in the spill arm; prefill
    tokens tree < chain < cold; the first copy-ins and COW copies of the
    tree and spill arms read back byte for byte; a payload at tp=2 equal to
    tp=1's; every window a graph replay. Prints tok/s, TTFT and prefill
    tokens per arm, arm-against-arm token equality and the ms of one
    copy-out and one copy-in."""
    from nos_tpu_torch import init_gpt

    t0 = time.perf_counter()
    cuda = device.type == "cuda"
    buckets, max_len = engine_sizes(small)
    stats = {}
    for dtype in ("float32",) if small else ("bfloat16", "float32"):
        cfg = bench_gpt(dtype, small)
        params = init_gpt(cfg, torch.Generator().manual_seed(0), device=device)
        chat = chat_traffic(cfg, small)
        tf = TeacherForced(torch, params, cfg, buckets, device)
        arms = {"tree": {}, "chain": {"radix_cache": False}, "cold": {"prefix_cache": False},
                "spill": {"total_blocks": spill_pool_blocks(chat)}}
        run, outs = {}, {}
        for arm, kw in arms.items():
            prompts, outs[arm], st, server = chat_run(torch, cfg, params, device, chat, buckets,
                                                      max_len, **kw)
            st.update(tf(prompts, outs[arm], dtype))
            log(f"radix {dtype} {arm}: " + json.dumps(st))
            check_logits(st, f"radix {arm}", F32_CROSS_SHAPE_STEPS)
            check(all(len(o) == chat["gen"] for o in outs[arm]), f"radix {arm}: short output")
            if cuda:
                check_replays(st, f"radix {dtype} {arm}", bursts=False)
                check_main_routes(st, f"radix {dtype} {arm}", dtype)
            if arm == "tree":
                copies = copy_ms(torch, server) if cuda else {}
                copies["tp2_payload"] = payload_across_widths(torch, server, cfg, params,
                                                              device)
                log(f"radix {dtype} copies: " + json.dumps(copies))
                st.update(copies)
            del server
            run[arm] = st
        tree, chain, cold, spill = (run[a] for a in arms)
        check(tree["prefix_cow_hits"] > 0 and tree["output_blocks_registered"] > 0,
              f"radix {dtype}: the tree arm staged no COW or registered no output")
        check(spill["spills"] > 0 and spill["revives"] > 0,
              f"radix {dtype}: the spill arm spilled {spill['spills']}, revived "
              f"{spill['revives']}")
        check(tree["prefill_tokens"] < chain["prefill_tokens"] < cold["prefill_tokens"],
              f"radix {dtype}: prefill tokens tree {tree['prefill_tokens']}, chain "
              f"{chain['prefill_tokens']}, cold {cold['prefill_tokens']}")
        check(tree["copies_checked"]["cow"] > 0 and spill["copies_checked"]["revive"] > 0,
              f"radix {dtype}: copies checked {tree['copies_checked']}, "
              f"{spill['copies_checked']}")
        run["tokens_equal_to_tree"] = {a: outs[a] == outs["tree"] for a in arms}
        run["summary"] = {a: {k: run[a][k] for k in (
            "decode_tok_per_s", "ttft_later_p50_s", "prefill_tokens", "prefix_hit_tokens",
            "prefix_cow_tokens", "spills", "revives", "top1_agreement", "wall_s")}
            for a in arms}
        log(f"radix {dtype} summary: " + json.dumps(
            {k: run[k] for k in ("tokens_equal_to_tree", "summary")}))
        stats[dtype] = run
    stats["phase_s"] = time.perf_counter() - t0
    log(f"radix phase_s={stats['phase_s']:.1f}")
    return stats


# -- phase: spec -------------------------------------------------------------------
SPEC_K = 8
# (name, streams, prompt tokens, new tokens, max_len, repetitive streams,
# spec_sync): bench.py:2341-2380's two decode cells.
SPEC_CASES = (("1k_repetitive", 1, 1024, 128, 8192, 1, True),
              ("8stream_mixed", 8, 128, 128, 512, 1, False))
SPEC_CASES_SMALL = (("1k_repetitive", 1, 96, 24, 512, 1, True),
                    ("8stream_mixed", 8, 24, 24, 128, 1, False))
TEMPLATED = {"n": 3, "phrase": 8, "prompt": 256, "gen": 64}
TEMPLATED_SMALL = {"n": 3, "phrase": 8, "prompt": 56, "gen": 40}
VERIFY_POS = 1143  # W = 9 rows at 1143..1151: limits near 1152


def spec_prompts(cfg, n, prompt_len, max_new, repetitive):
    """bench.py::measure's prompts: the first `repetitive` loop a 16-token
    pattern, the rest random, seeded by the cell's shape."""
    rng = np.random.default_rng([n, prompt_len, max_new, repetitive])
    pattern = rng.integers(1, cfg.vocab, 16).tolist()
    return [(pattern * (prompt_len // 16 + 1))[:prompt_len] if i < repetitive
            else rng.integers(1, cfg.vocab, prompt_len).tolist() for i in range(n)]


def templated_prompts(cfg, t):
    """bench.py::_templated_output's prompts: each a distinct phrase looped."""
    rng = np.random.default_rng([2026, 19, t["n"]])
    phrases = [rng.integers(1, cfg.vocab, t["phrase"]).tolist() for _ in range(t["n"])]
    return [(p * (t["prompt"] // t["phrase"] + 1))[: t["prompt"]] for p in phrases]


@contextlib.contextmanager
def verify_launches():
    """Count, by entry point and route, the window launches made inside the
    engine's verify rounds (`paged_verify_window`): the package counts
    launches per entry point only; this splits off the verify share."""
    from nos_tpu_torch.ops import paged_attention as pa
    from nos_tpu_torch.runtime import decode_server as ds

    counts = {n: dict.fromkeys(r, 0) for n, r in pa.ROUTE_LAUNCHES.items()}
    real = ds.paged_verify_window

    def counted(*args, **kw):
        before = {n: dict(r) for n, r in pa.ROUTE_LAUNCHES.items()}
        out = real(*args, **kw)
        for n, r in pa.ROUTE_LAUNCHES.items():
            for route, c in r.items():
                counts[n][route] += c - before[n][route]
        return out

    ds.paged_verify_window = counted
    try:
        yield counts
    finally:
        ds.paged_verify_window = real


def spec_run(torch, cfg, params, device, rounds, max_len, n_slots, mesh=None, **engine_kw):
    """Serve `rounds` (lists of (prompt, max_new), each round's requests
    submitted together after the previous round) on the threaded engine,
    after a warm-up request of the first prompt (bench.py::measure's; with
    the radix cache on, its output is in the tree). Launch counts are
    zeroed just before the timed rounds and read just after."""
    from nos_tpu_torch import DecodeServer
    from nos_tpu_torch.ops import paged_attention as pa

    server = DecodeServer(params, cfg, n_slots=n_slots, max_len=max_len,
                          prompt_buckets=(16, 32, 64, 128, 256), steps_per_dispatch=16,
                          mesh=mesh, device=None if mesh is not None else device, **engine_kw)
    server.start()
    try:
        server.generate(rounds[0][0][0], rounds[0][0][1], timeout=900)
        warm = {c: getattr(server, c) for c in SPEC_COUNTERS}
        sync(torch, device)
        pa.reset_launch_counts()
        with verify_launches() as verify:
            t0 = time.perf_counter()
            outs = []
            for reqs in rounds:
                futs = [server.submit(p, m) for p, m in reqs]
                outs.append([f.result(timeout=900) for f in futs])
            sync(torch, device)
            wall = time.perf_counter() - t0
    finally:
        server.stop()
    n_tok = sum(m for reqs in rounds for _, m in reqs)
    stats = {"wall_s": wall, "decode_tok_per_s": n_tok / wall,
             **{c: getattr(server, c) - warm[c] for c in SPEC_COUNTERS},
             "graph_replays_total": server.graph_replays,
             "windows_total": server.macro_dispatches + server.burst_windows_run,
             "launches": dict(pa.LAUNCHES),
             "routes": {k: dict(r) for k, r in pa.ROUTE_LAUNCHES.items()},
             "verify_routes": verify, "tp": server.tp}
    rounds_n = stats["spec_rounds"]
    stats["accepted_per_round"] = stats["spec_tokens_accepted"] / rounds_n if rounds_n else 0.0
    return outs, stats


SPEC_COUNTERS = ("spec_rounds", "spec_tokens_accepted", "spec_tree_rounds",
                 "spec_history_rounds", "spec_tree_tokens_accepted",
                 "spec_history_tokens_accepted", "spec_demotions", "both_dispatch_ticks",
                 "macro_dispatches", "burst_dispatches", "burst_windows_run", "graph_replays",
                 "prefill_tokens")


def verify_window_case(torch):
    """The window kernel at the verify width: W = spec_k + 1 = 9 rows for
    each of B = 8 lanes at positions 1143..1151 (limits up to 1152), bf16,
    against its plain version, and timed beside the plain version and SDPA
    on the same gathered cache."""
    from nos_tpu_torch.ops import paged_attention as pa
    from nos_tpu_torch.runtime.mfu import H100_BF16_PEAK_FLOPS

    B, NH, NKV, HD, BS, W = 8, 8, 2, 64, 32, SPEC_K + 1
    P = -(-(VERIFY_POS + W) // BS)
    T = 1 + B * P
    gen = torch.Generator(device="cuda").manual_seed(5)
    k, v, _, _, dt = _pools(torch, gen, "bfloat16", T, NKV, BS, HD)
    table = _table(torch, gen, B, P, T)
    q = torch.randn((B, NH, W, HD), generator=gen, device="cuda").to(dt)
    pos = torch.full((B,), VERIFY_POS, dtype=torch.int32, device="cuda")
    lengths = torch.tensor([W, W, 5, W, 1, W, 7, W], dtype=torch.int32, device="cuda")
    mask = torch.ones((B,), dtype=torch.bool, device="cuda")
    before = dict(pa.ROUTE_LAUNCHES["paged_window_attention"])
    got = pa.paged_window_attention(q, k, v, table, pos, lengths, mask)
    want = pa._window_reference(q, k, v, table, pos, lengths, mask)
    check(pa.ROUTE_LAUNCHES["paged_window_attention"]["mma"] == before["mma"] + 1,
          "spec: the W = 9 window did not take the mma route")
    worst = {"paged_window_attention": 0.0, "paged_window_attention_rel": 0.0}
    live = (torch.arange(W, device="cuda")[None, :] < lengths[:, None])[:, None, :, None]
    held(torch, torch.where(live, got, 0), torch.where(live, want, 0), "bfloat16",
         "paged_window_attention W=9", worst)
    kd = pa._gather_pool(k, table, None, dt).repeat_interleave(NH // NKV, dim=1)
    vd = pa._gather_pool(v, table, None, dt).repeat_interleave(NH // NKV, dim=1)
    lim = pos[:, None] + torch.arange(W, device="cuda")[None, :] + 1  # [B, W]
    causal = (torch.arange(kd.shape[2], device="cuda")[None, None, :]
              < lim[:, :, None])[:, None]
    out = {"max_abs_err": worst["paged_window_attention"],
           "ms": time_cuda(torch, lambda: pa.paged_window_attention(q, k, v, table, pos,
                                                                     lengths, mask)),
           "plain_ms": time_cuda(torch, lambda: pa._window_reference(q, k, v, table, pos,
                                                                     lengths, mask)),
           "library_ms": time_cuda(torch, lambda: _sdpa_decode(torch, q, kd, vd, causal))}
    pages = B * P
    nbytes = pages * NKV * BS * HD * 2 * 2 + 2 * B * NH * W * HD * 2 + 4 * pages + 9 * B
    flops = 4.0 * NH * HD * float(lim.sum().item())
    out["bound_ms"] = 1e3 * max(nbytes / H100_BYTES_PER_S, flops / H100_BF16_PEAK_FLOPS)
    out["bound_by"] = ("bytes" if nbytes / H100_BYTES_PER_S >= flops / H100_BF16_PEAK_FLOPS
                       else "operations")
    log("spec verify_window_W9: " + json.dumps(out))
    return out


def phase_spec(torch, device, small=False):
    """Speculative decoding at the serving cell's width: the bench GPT,
    greedy, spec_k = 8 (verify windows of W = 9), bf16 (the main path) and
    f32, on bench.py's `decode:1k_repetitive` (spec_sync) and
    `decode:8stream_mixed` (pipelined) cells and a templated regeneration
    round (bench.py::_templated_output's shape: each prompt served, then
    served again, so the radix tree drafts the second round), spec on
    against spec off; then the three spec-on at tp=2 with both shards on
    the card, bf16. Gates: every arm's tokens against a teacher-forced plain
    pass; spec rounds and accepted tokens > 0; tree drafts > 0 on the
    regeneration; every verify window's kernel launches on the window
    kernel (8 a round per shard; "mma" in bf16), at tp=2 through the
    sharded entry point; every window a graph replay; and the window kernel
    at W = 9 against its plain version. Prints spec-on against spec-off
    tok/s, accepted tokens a round, and that window's ms beside SDPA."""
    from nos_tpu_torch import init_gpt
    from nos_tpu_torch.parallel import build_mesh

    t0 = time.perf_counter()
    cuda = device.type == "cuda"
    cases = SPEC_CASES_SMALL if small else SPEC_CASES
    tmpl = TEMPLATED_SMALL if small else TEMPLATED
    stats = {"verify_window_W9": verify_window_case(torch)} if cuda else {}
    mesh = build_mesh({"tp": 2}, devices=[device, device])
    for dtype in ("float32",) if small else ("bfloat16", "float32"):
        cfg = bench_gpt(dtype, small)
        params = init_gpt(cfg, torch.Generator().manual_seed(0), device=device)
        buckets = (16, 32, 64, 128, 256)
        tf = TeacherForced(torch, params, cfg, buckets, device)
        traffic = {name: ([[(p, new) for p in spec_prompts(cfg, n, plen, new, rep)]],
                          max_len, n, sync_)
                   for name, n, plen, new, max_len, rep, sync_ in cases}
        templ = [(p, tmpl["gen"]) for p in templated_prompts(cfg, tmpl)]
        traffic["templated"] = ([templ, templ], 512 if small else 1024, tmpl["n"], True)
        run = {}
        for name, (rounds, max_len, n_slots, spec_sync) in traffic.items():
            widths = ((1, None), (2, mesh)) if dtype == ("float32" if small else "bfloat16") \
                else ((1, None),)
            arms = [("off", 1, None, {})] + [
                (f"on_tp{w}", w, m, dict(spec_k=SPEC_K, spec_sync=spec_sync))
                for w, m in widths]
            outs = {}
            for arm, width, m, kw in arms:
                outs[arm], st = spec_run(torch, cfg, params, device, rounds, max_len, n_slots,
                                         mesh=m, **kw)
                prompts = [p for reqs in rounds for p, _ in reqs]
                flat = [o for r in outs[arm] for o in r]
                st.update(tf(prompts, flat, dtype))
                what = f"spec {dtype} {name} {arm}"
                log(f"{what}: " + json.dumps(st))
                check_logits(st, f"spec {name} {arm}", F32_CROSS_SHAPE_STEPS)
                if kw:
                    check(st["spec_rounds"] > 0 and st["spec_tokens_accepted"] > 0,
                          f"{what}: {st['spec_rounds']} rounds, "
                          f"{st['spec_tokens_accepted']} accepted")
                    if cuda:  # every verify round: one window launch a layer a shard
                        entry = "paged_window_attention" + ("_sharded" if width == 2 else "")
                        other = "paged_window_attention" + ("" if width == 2 else "_sharded")
                        route = "mma" if dtype == "bfloat16" else "simt"
                        got = st["verify_routes"][entry]
                        check(got[route] == sum(got.values())
                              == width * cfg.layers * st["spec_rounds"]
                              and sum(st["verify_routes"][other].values()) == 0,
                              f"{what}: verify launches {st['verify_routes']} for "
                              f"{st['spec_rounds']} rounds")
                    if name == "templated":
                        check(st["spec_tree_rounds"] > 0 and st["spec_tree_tokens_accepted"] > 0,
                              f"{what}: {st['spec_tree_rounds']} tree rounds, "
                              f"{st['spec_tree_tokens_accepted']} tree tokens accepted")
                if cuda:
                    check(st["graph_replays_total"] == st["windows_total"],
                          f"{what}: {st['graph_replays_total']} replays for "
                          f"{st['windows_total']} windows")
                    suffix = "_sharded" if width == 2 else ""
                    check_routes(st["routes"], "paged_window_attention" + suffix,
                                 "mma" if dtype == "bfloat16" else "simt", what)
                    decode = st["routes"]["paged_decode_attention" + suffix]
                    check(decode["split"] == sum(decode.values()),
                          f"{what}: decode launches by route {decode}")
                run[f"{name}_{arm}"] = st
            run[f"{name}_summary"] = {
                "tok_per_s": {a: run[f"{name}_{a}"]["decode_tok_per_s"] for a, *_ in arms},
                "accepted_per_round": {a: run[f"{name}_{a}"]["accepted_per_round"]
                                       for a, *_ in arms[1:]},
                "tokens_equal_to_off": {a: outs[a] == outs["off"] for a, *_ in arms[1:]}}
            log(f"spec {dtype} {name} summary: " + json.dumps(run[f"{name}_summary"]))
        stats[dtype] = run
    stats["phase_s"] = time.perf_counter() - t0
    log(f"spec phase_s={stats['phase_s']:.1f}")
    return stats


# -- phase: quant ------------------------------------------------------------------
QUANT_ORACLE_STEPS = 12
# The int8 pool's routes by q's dtype: decode on the split kernel; a window
# with a bf16 q on the tensor cores, with an f32 q on simt.
QUANT_ROUTES = {"bfloat16": {"paged_decode_attention": "split", "paged_window_attention": "mma"},
                "float32": {"paged_decode_attention": "split",
                            "paged_window_attention": "simt"}}
QUANT_NAMES = ("paged_decode_attention", "paged_window_attention") + SHARDED


def int8_bound(nbytes, flops):
    """The least time of an int8-pool launch: its bytes (int8 codes, one f32
    scale per page for K and for V, the bf16 q and output, the table and
    the per-lane scalars) at the HBM rate, or its operations at the bf16
    tensor-core rate (the codes are exact in bf16), whichever is larger."""
    from nos_tpu_torch.runtime.mfu import H100_BF16_PEAK_FLOPS

    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_BF16_PEAK_FLOPS
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def int8_timed(torch, kernel, plain, library, nbytes, flops):
    return {"ms": time_cuda(torch, kernel), "device_ms": device_ms(torch, kernel),
            "plain_ms": time_cuda(torch, plain), "library_ms": time_cuda(torch, library),
            "library_device_ms": device_ms(torch, library), **int8_bound(nbytes, flops)}


def int8_kernels(torch):
    """The int8 routes of the four paged kernels of the serving path at its
    shapes (bf16 q over an int8 pool with per-block scales; B 8, nh 8, nkv
    2, hd 64, block 32): decode at MAIN_DECODE_LIMITS, the 256-token
    two-lane window wave at position 2048, the W = 9 verify window at
    VERIFY_POS, and the two sharded entry points over two shards (nh 4, nkv
    1 each, each shard its own copy of the scales). Each held against its
    plain version (`held`, the int8 bounds), the sharded ones also against
    the unsharded kernel bit for bit per head, then timed beside the plain
    version and SDPA on the dequantized gather (the library call the port
    never makes). Returns (worst max|err| per kernel, times per case)."""
    from nos_tpu_torch.ops import paged_attention as pa

    B, NH, NKV, HD, BS = 8, 8, 2, 64, 32
    P = 8192 // BS
    T = 1 + B * P
    gen = torch.Generator(device="cuda").manual_seed(11)
    k, v, ks, vs, dt = _pools(torch, gen, "int8", T, NKV, BS, HD)
    table = _table(torch, gen, B, P, T)
    table[1, :8] = torch.arange(9, 17, device="cuda", dtype=torch.int32)  # no sharing
    shards = range(2)
    kh, vh = _heads(k), _heads(v)
    kss, vss = [ks, ks.clone()], [vs, vs.clone()]
    worst = {n + sfx: 0.0 for n in QUANT_NAMES for sfx in ("", "_rel")}
    out = {}

    def dense(pool, scale, tab):
        return pa._gather_pool(pool, tab, scale, dt).repeat_interleave(NH // NKV, dim=1)

    def nbytes(pages, b, rows, shards=1):
        """K and V codes under `pages` pages with one f32 scale each, the
        bf16 q and output of b lanes x rows, the table entries and the
        per-lane scalars (decode: the limit; a window: pos, length and
        mask); split over `shards` on the KV heads (every shard reads the
        scales, the table and the scalars)."""
        codes, qo = pages * NKV * BS * HD * 2, 2 * b * NH * rows * HD * 2
        scalars = 4 * b if rows == 1 else 9 * b
        return codes + qo + shards * (pages * 2 * 4 + 4 * pages + scalars)

    # Decode at the main path's limits, unsharded and over two shards.
    lim = torch.tensor(MAIN_DECODE_LIMITS, dtype=torch.int32, device="cuda")
    q = torch.randn((B, NH, HD), generator=gen, device="cuda").to(dt)
    tab = table[:, :-(-max(MAIN_DECODE_LIMITS) // BS)].contiguous()
    got = pa.paged_decode_attention(q, k, v, tab, lim, ks, vs)
    held(torch, got, pa._reference(q, k, v, tab, lim, ks, vs), "int8",
         "paged_decode_attention int8 decode_main", worst)
    qs = _heads(q)
    shard_out = pa.paged_decode_attention_sharded(qs, kh, vh, tab, lim, kss, vss)
    torch.cuda.synchronize()
    check(torch.equal(torch.cat(shard_out, 1), got),
          "quant: the sharded int8 decode differs from the unsharded kernel")
    held(torch, torch.cat(shard_out, 1), pa._reference(q, k, v, tab, lim, ks, vs), "int8",
         "paged_decode_attention_sharded int8 decode_main", worst)
    mask = (torch.arange(tab.shape[1] * BS, device="cuda")[None, :] < lim[:, None])[:, None,
                                                                                     None, :]
    kd, vd = dense(k, ks, tab), dense(v, vs, tab)
    kdh, vdh = _heads(kd), _heads(vd)
    pages = sum(-(-int(x) // BS) for x in MAIN_DECODE_LIMITS)
    flops = 4.0 * NH * HD * sum(MAIN_DECODE_LIMITS)
    out["decode_main"] = int8_timed(
        torch, lambda: pa.paged_decode_attention(q, k, v, tab, lim, ks, vs),
        lambda: pa._reference(q, k, v, tab, lim, ks, vs),
        lambda: _sdpa_decode(torch, q[:, :, None, :], kd, vd, mask), nbytes(pages, B, 1), flops)
    out["decode_sharded"] = int8_timed(
        torch, lambda: pa.paged_decode_attention_sharded(qs, kh, vh, tab, lim, kss, vss),
        lambda: [pa._reference(qs[s], kh[s], vh[s], tab, lim, ks, vs) for s in shards],
        lambda: [_sdpa_decode(torch, qs[s][:, :, None, :], kdh[s], vdh[s], mask)
                 for s in shards],
        nbytes(pages, B, 1, shards=2), flops)
    del kd, vd, kdh, vdh

    def window(w, pos0, lengths, active, name):
        b = len(active)
        qw = torch.randn((b, NH, w, HD), generator=gen, device="cuda").to(dt)
        tabw = table[:b, :-(-(pos0 + w) // BS)].contiguous()
        pos = torch.full((b,), pos0, dtype=torch.int32, device="cuda")
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        act = torch.tensor(active, device="cuda")
        args = (tabw, pos, lens, act, ks, vs)
        live = ((torch.arange(w, device="cuda")[None, :] < lens[:, None])
                & act[:, None])[:, None, :, None]
        got = pa.paged_window_attention(qw, k, v, *args)
        want = pa._window_reference(qw, k, v, *args)
        held(torch, torch.where(live, got, 0), torch.where(live, want, 0), "int8",
             f"paged_window_attention int8 {name}", worst)
        wlim = torch.where(live[:, 0, :, 0], pos0 + torch.arange(w, device="cuda")[None, :] + 1,
                           1)
        causal = (torch.arange(tabw.shape[1] * BS, device="cuda")[None, None, :]
                  < wlim[:, :, None])[:, None]
        pages = sum(-(-int(x) // BS) for x in wlim.max(dim=1).values.tolist())
        flops = 4.0 * NH * HD * float(wlim.sum().item())
        kd, vd = dense(k, ks, tabw), dense(v, vs, tabw)
        out[name] = int8_timed(
            torch, lambda: pa.paged_window_attention(qw, k, v, *args),
            lambda: pa._window_reference(qw, k, v, *args),
            lambda: _sdpa_decode(torch, qw, kd, vd, causal), nbytes(pages, b, w), flops)
        out[name]["route"] = pa._window_route(qw, k, ks)
        if name != "window_main":
            return
        qwh = _heads(qw)
        shard_out = pa.paged_window_attention_sharded(qwh, kh, vh, tabw, pos, lens, act, kss,
                                                      vss)
        torch.cuda.synchronize()
        check(torch.equal(torch.cat(shard_out, 1), got),
              "quant: the sharded int8 window differs from the unsharded kernel")
        held(torch, torch.where(live, torch.cat(shard_out, 1), 0), torch.where(live, want, 0),
             "int8", "paged_window_attention_sharded int8 window_main", worst)
        kdh, vdh = _heads(kd), _heads(vd)
        out["window_sharded"] = int8_timed(
            torch, lambda: pa.paged_window_attention_sharded(qwh, kh, vh, tabw, pos, lens, act,
                                                             kss, vss),
            lambda: [pa._window_reference(qwh[s], kh[s], vh[s], tabw, pos, lens, act, ks, vs)
                     for s in shards],
            lambda: [_sdpa_decode(torch, qwh[s], kdh[s], vdh[s], causal) for s in shards],
            nbytes(pages, b, w, shards=2), flops)
        out["window_sharded"]["route"] = pa._window_route(qwh[0], kh[0], ks)

    window(256, 2048, [256] * B, [False] * 6 + [True, True], "window_main")
    W = SPEC_K + 1
    window(W, VERIFY_POS, [W, W, 5, W, 1, W, 7, W], [True] * B, "window_verify")
    log("quant kernels: " + json.dumps({"worst": worst, "times": out}))
    return worst, out


def profile_prefill_chunk(torch, cfg, params, kv_dtype, tag):
    """One 256-token prefill chunk at position 2048 (the long prompts' 9th)
    under torch.profiler, over a pool the first 8 chunks filled: device ms
    and the share of the window kernel (name holding `tag`)."""
    from nos_tpu_torch.models import decode as D

    BS, C, POS = 32, 256, 2048
    pages = (POS + C) // BS
    cache = D.init_paged_cache(cfg, 1 + pages, BS, kv_dtype=kv_dtype, device="cuda")
    row = torch.arange(1, pages + 1, dtype=torch.int32, device="cuda")
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(1, cfg.vocab, (1, POS + C), generator=gen).to("cuda", torch.int32)
    for start in range(0, POS, C):
        D.paged_prefill_chunk(params, toks[:, start:start + C], cfg, cache, row, start, C, BS,
                              with_logits=False)

    def run():
        D.paged_prefill_chunk(params, toks[:, POS:], cfg, cache, row, POS, C, BS,
                              with_logits=False)

    return profile_steps(torch, run, 1, tag)


def oracle_near_ties(torch, params, cfg, prompt, steps, block_size, device, deltas):
    """The native arm of `measure_divergence` again (the same programs and
    teacher-forced greedy picks): its top-2 logit gap at each position, and
    at how many positions that gap is within twice the oracle's max|dlogit|
    there (`deltas`, its per-token deltas): where a top-1 flip between the
    arms is possible at all."""
    from nos_tpu_torch.models import decode as D

    n = len(prompt)
    n_pages = -(-(n + steps) // block_size)
    cache = D.init_paged_cache(cfg, 2 + n_pages, block_size, device=device)
    table = torch.arange(1, n_pages + 1, dtype=torch.int32, device=device)[None, :]
    lg, _ = D.paged_prefill_chunk(params, torch.tensor([prompt], dtype=torch.int32,
                                                       device=device),
                                  cfg, cache, table[0], 0, n, block_size)
    lg = lg[n - 1][None, :]
    mask = torch.ones((1,), dtype=torch.bool, device=device)
    gaps = []
    for step in range(steps + 1):
        top2 = lg.topk(2, dim=-1).values[0]
        gaps.append((top2[0] - top2[1]).item())
        if step == steps:
            break
        lg, _ = D.paged_decode_step(params, D.greedy(lg), cfg, cache, table,
                                    torch.tensor([n + step], dtype=torch.int32, device=device),
                                    mask, block_size)
    return sum(g <= 2 * d for g, d in zip(gaps, deltas)), gaps


def phase_quant(torch, device, small=False):
    """The int8 engine (`kv_dtype="int8"`) at the serving cell's width: the
    bench GPT and engine settings of the engine phase, bf16 (the main path)
    then f32, on the engine's defaults. Per dtype: (1) the engine phase's
    traffic on a native and an int8 engine: tok/s, long-prompt TTFT, peak
    memory, tick phases, pool bytes; gates: blocks per pool byte >= 1.9x
    native, the int8 tokens against a teacher-forced pass of the plain int8
    programs (check_logits: f32 exact, bf16 within one step), every window a
    replay, decode launches on "split" and window launches on "simt"; (2)
    the captured window replayed against the eager `_macro` on one int8
    engine state, codes and scales byte for byte; (3) the radix phase's chat
    over an undersized int8 pool: spills and revives, the first copies byte
    for byte (codes and scales), spill host bytes per block <= 0.55x
    native; (4) the oracle (`runtime/divergence.py`) over two serving
    prompts, 12 steps: max|dlogit| <= MAX_ABS_LOGIT_DELTA, top-1 agreement
    and the native arm's near-ties reported. f32 only: (5) tp=2 (both
    shards on the card) against tp=1 on the int8 pool, tick by tick: equal
    tokens and counters, the shards' scale copies equal. bf16 only, on the
    card: the int8 kernels held and timed (`int8_kernels`), and the decode
    step and a prefill chunk profiled over an int8 and a native pool."""
    from nos_tpu_torch import init_gpt
    from nos_tpu_torch.ops import paged_attention as pa
    from nos_tpu_torch.parallel import build_mesh
    from nos_tpu_torch.runtime.divergence import MAX_ABS_LOGIT_DELTA, MIN_TOP1_AGREEMENT
    from nos_tpu_torch.runtime.divergence import measure_divergence

    t0 = time.perf_counter()
    cuda = device.type == "cuda"
    buckets, max_len = engine_sizes(small)
    main = "float32" if small else "bfloat16"
    stats = {}
    if cuda:
        stats["kernels"], stats["times"] = int8_kernels(torch)
    for dtype in ("float32",) if small else ("bfloat16", "float32"):
        cfg = bench_gpt(dtype, small)
        params = init_gpt(cfg, torch.Generator().manual_seed(0), device=device)
        max_new, prompts, long_prompts = engine_traffic(cfg, small)
        run = {}
        # (1) serving, native then int8.
        _, native = serve(torch, cfg, params, device, prompts, long_prompts, max_new, buckets,
                          max_len, kv_dtype="fp16")
        outs, st = serve(torch, cfg, params, device, prompts, long_prompts, max_new, buckets,
                         max_len, kv_dtype="int8")
        check(all(len(o) == max_new for o in outs), f"quant {dtype}: short output")
        if cuda:
            check_replays(st, f"quant {dtype}")
            for name, route in QUANT_ROUTES[dtype].items():
                check_routes(st["routes"], name, route, f"quant {dtype}")
        all_prompts = prompts + long_prompts
        kern = teacher_forced(torch, params, cfg, all_prompts, outs, buckets, 32, device,
                              kv_dtype="int8")
        with plain_attention():
            plain = teacher_forced(torch, params, cfg, all_prompts, outs, buckets, 32, device,
                                   kv_dtype="int8")
        st.update(agreement(torch, kern, plain, torch.tensor(outs, device=device), dtype))
        del kern, plain
        st["dtype"] = dtype
        check_logits(st, f"quant {dtype} serving")
        st["pool_bytes_ratio"] = native["kv_pool_bytes"] / st["kv_pool_bytes"]
        check(st["pool_bytes_ratio"] >= 1.9,
              f"quant {dtype}: blocks per pool byte {st['pool_bytes_ratio']}x native < 1.9x")
        for arm, s in (("native", native), ("int8", st)):
            log(f"quant {dtype} serving {arm}: " + json.dumps(
                {k: s.get(k) for k in ("decode_tok_per_s", "long_prompt_ttft_s", "wall_s",
                                       "peak_mem_bytes", "kv_pool_bytes", "tick_phase_s",
                                       "graph_replays", "launches", "routes",
                                       "top1_agreement", "top1_agreement_1ulp",
                                       "max_abs_dlogit", "mean_abs_dlogit",
                                       "pool_bytes_ratio")}))
        run["serving"], run["native"] = st, native
        # (2) the captured window over an int8 pool, replay against eager.
        server, futs = graph_engine(torch, cfg, params, device, small, kv_dtype="int8")
        rep = replay_against_eager(torch, server)
        check(rep["tokens_equal"] and rep["state_equal"] and rep["advanced"]
              and rep["pool_bytes_equal"] and rep["launches_eager"] == rep["launches_replay"],
              f"quant {dtype}: the replayed int8 window differs from the eager one: {rep}")
        if cuda:
            check(server.graph_captures == 1 and rep["launches_replay"] > 0,
                  f"quant {dtype}: no captured int8 window: {rep}")
        if cuda and dtype == main:
            rep["window_replay"] = profile_steps(torch, server._window, 16,
                                                 "split_decode_kernel")
            rep["window_event_ms_replay"] = window_ms(torch, server._window)
        for f in futs:
            f.cancel()
        server.stop()
        del server
        log(f"quant {dtype} replay: " + json.dumps(rep))
        run["replay"] = rep
        # (3) the chat over an undersized int8 pool.
        chat = chat_traffic(cfg, small)
        _, _, sp, server = chat_run(torch, cfg, params, device, chat, buckets, max_len,
                                    kv_dtype="int8", total_blocks=spill_pool_blocks(chat))
        entries = len(server.spill_tier)
        check(sp["spills"] > 0 and sp["revives"] > 0 and sp["copies_checked"]["revive"] > 0
              and entries > 0,
              f"quant {dtype} spill: spills {sp['spills']}, revives {sp['revives']}, "
              f"copies checked {sp['copies_checked']}, {entries} host entries")
        native_block = (cfg.layers * 2 * cfg.n_kv * 32 * cfg.head_dim
                        * torch.empty((), dtype=cfg.torch_dtype).element_size())
        sp["host_bytes_per_block"] = sp["spill_host_bytes"] / entries
        sp["host_bytes_ratio"] = sp["host_bytes_per_block"] / native_block
        check(sp["host_bytes_per_block"] == server._bytes_per_block
              and sp["host_bytes_ratio"] <= 0.55,
              f"quant {dtype} spill: {sp['host_bytes_per_block']} host bytes per block, "
              f"{sp['host_bytes_ratio']}x native")
        if cuda:
            check_replays(sp, f"quant {dtype} spill", bursts=False)
            for name, route in QUANT_ROUTES[dtype].items():
                check_routes(sp["routes"], name, route, f"quant {dtype} spill")
        del server
        log(f"quant {dtype} spill: " + json.dumps(sp))
        run["spill"] = sp
        # (4) the bounded-divergence oracle.
        reports = []
        for prompt in prompts[:2]:
            r = measure_divergence(params, cfg, prompt, QUANT_ORACLE_STEPS, block_size=32,
                                   device=device)
            ties, gaps = oracle_near_ties(torch, params, cfg, prompt, QUANT_ORACLE_STEPS, 32,
                                          device, r.per_token_delta)
            reports.append({"summary": r.summary(), "max_abs_logit_delta": r.max_abs_logit_delta,
                            "mean_abs_logit_delta": r.mean_abs_logit_delta,
                            "top1_agreement": r.top1_agreement,
                            "within_pinned_bounds": r.within(),
                            "below_min_top1_agreement": r.top1_agreement < MIN_TOP1_AGREEMENT,
                            "per_token_delta": r.per_token_delta, "near_ties": ties,
                            "native_top2_gaps": gaps})
            check(r.max_abs_logit_delta <= MAX_ABS_LOGIT_DELTA,
                  f"quant {dtype} oracle: {r.summary()} (bound {MAX_ABS_LOGIT_DELTA})")
        log(f"quant {dtype} oracle: " + json.dumps(reports))
        run["oracle"] = reports
        # (5) tp=2 against tp=1 on the int8 pool.
        if dtype == "float32":
            mesh = build_mesh({"tp": 2}, devices=[device, device])
            outs1, tp1 = tp_serve(torch, cfg, params, device, None, prompts, long_prompts,
                                  max_new, buckets, max_len, kv_dtype="int8")
            outs2, tp2 = tp_serve(torch, cfg, params, device, mesh, prompts, long_prompts,
                                  max_new, buckets, max_len, kv_dtype="int8")
            check(outs2 == outs1, f"quant tp: {float(np.mean(np.array(outs1) == np.array(outs2)))}"
                  " of the tp=2 int8 tokens equal tp=1's")
            for c in BUDGET_COUNTERS:
                check(tp2[c] == tp1[c], f"quant tp: {c} {tp2[c]} at tp=2, {tp1[c]} at tp=1")
            check(tp2["scale_copies_equal"], "quant tp: the shards' scale copies differ")
            if cuda:
                for name, sharded in zip(QUANT_ROUTES[dtype], SHARDED):
                    check(tp2["launches"][sharded] == 2 * tp1["launches"][name] > 0,
                          f"quant tp: launches {tp2['launches']} at tp=2, {tp1['launches']}")
                    check_routes(tp2["routes"], sharded, QUANT_ROUTES[dtype][name],
                                 "quant tp=2")
            log("quant float32 tp: " + json.dumps({w: {k: s[k] for k in (
                "decode_tok_per_s", "long_prompt_ttft_s", "wall_s", "kv_pool_bytes", "launches",
                "routes", "graph_replays")} for w, s in (("tp1", tp1), ("tp2", tp2))}))
            run["tp1"], run["tp2"] = tp1, tp2
        if cuda and dtype == main:
            run["step_profile"] = {kv: profile_decode_step(torch, cfg, params, kv_dtype=kv)
                                   for kv in ("fp16", "int8")}
            run["prefill_profile"] = {
                "fp16": profile_prefill_chunk(torch, cfg, params, "fp16", "window_mma_kernel"),
                "int8": profile_prefill_chunk(torch, cfg, params, "int8", "window_mma_kernel")}
            log(f"quant {dtype} profiles: " + json.dumps(
                {k: run[k] for k in ("step_profile", "prefill_profile")}))
        stats[dtype] = run
    stats["phase_s"] = time.perf_counter() - t0
    log(f"quant phase_s={stats['phase_s']:.1f}")
    return stats


# -- phase: faults -----------------------------------------------------------------
# The seeded schedule of the faults phase: a transient at admit#1, a
# device-lost at admit#8 and a poison at dispatch_prefill_wave#6
# (FaultInjector.seeded(6, n_faults=3, sites=FAULT_SITES, max_occurrence=8)),
# over sites the serving traffic visits more than 8 times.
FAULT_SEED = 6
FAULT_SITES = ("admit", "block_admit", "dispatch_prefill_wave", "dispatch_macro")
FAULT_COUNTERS = ("recoveries", "slots_restored", "replay_tokens", "requests_poisoned",
                  "transient_retries", "fail_all_recoveries")


def fault_run(torch, cfg, params, device, prompts, max_new, buckets, max_len, injector=None,
              **engine_kw):
    """The engine phase's model, settings and traffic on an engine at its
    defaults (surgical recovery, bursts, the captured window, radix and
    spill) with `injector` (None: the fault-free run), every request
    queued before start() so that the engine loop (`_run`, which routes
    each fault through `_recover`) runs one deterministic schedule.
    Returns (outcomes in submit order: tokens or the exception, stats)."""
    from nos_tpu_torch import DecodeServer

    server = DecodeServer(params, cfg, n_slots=8, max_len=max_len, prompt_buckets=buckets,
                          steps_per_dispatch=16, prefill_budget_tokens=2 * buckets[-1],
                          device=device, fault_injector=injector, transient_backoff_s=0.001,
                          **engine_kw)
    futs = [server.submit(p, max_new) for p in prompts]
    t0 = time.perf_counter()
    server.start()
    outcomes = []
    try:
        for f in futs:
            try:
                outcomes.append(f.result(timeout=600))
            except Exception as exc:  # noqa: BLE001 — the outcome the gates read
                outcomes.append(exc)
        sync(torch, device)
        wall = time.perf_counter() - t0
    finally:
        server.stop()
    lat = sorted(server.restore_latency_s)
    counts = server._block_mgr.counts()
    stats = {
        "wall_s": wall,
        **{c: getattr(server, c) for c in FAULT_COUNTERS},
        "restore_latency_s": {"n": len(lat), "p50": lat[len(lat) // 2] if lat else None,
                              "max": lat[-1] if lat else None},
        "pool": counts, "conserved": server._block_mgr.conserved(),
        "graph_captures": server.graph_captures, "graph_replays": server.graph_replays,
        "windows": server.macro_dispatches + server.burst_windows_run,
        "burst_dispatches": server.burst_dispatches,
        "schedule": [list(map(str, (s.site, s.occurrence, s.kind)))
                     for s in (injector.schedule if injector else ())],
        "fired": [[s.site, s.occurrence, s.kind, slot]
                  for s, slot in (injector.fired if injector else ())],
        "pending": bool(injector and injector.has_pending()),
    }
    if injector is not None:
        stats["fired_by_kind"] = {k: sum(1 for s, _ in injector.fired if s.kind == k)
                                  for k in ("transient", "poison", "device-lost")}
    return outcomes, stats


def check_fault_run(torch, st, outcomes, base, what, max_new, cuda):
    """The faults phase's gates on one run against its fault-free run
    `base`: every non-poisoned future resolved with its max_new tokens,
    every failed one with a PoisonRequestError, as many as the engine
    counted; every scheduled fault fired; the legacy sweep never ran; the
    pool conserved, nothing in use and as many blocks free or cached as
    after the fault-free run; on the card one capture and every window a
    replay of it, across the recoveries."""
    from nos_tpu_torch.runtime.faults import PoisonRequestError

    poisoned = [o for o in outcomes if isinstance(o, Exception)]
    for o in outcomes:
        check(isinstance(o, PoisonRequestError) or (isinstance(o, list) and len(o) == max_new),
              f"{what}: an outcome is neither {max_new} tokens nor a poison: {o!r}")
    check(len(poisoned) == st["requests_poisoned"],
          f"{what}: {len(poisoned)} poisoned futures, {st['requests_poisoned']} counted")
    check(not st["pending"] and len(st["fired"]) == len(st["schedule"]),
          f"{what}: scheduled faults that never fired: {st['schedule']} fired {st['fired']}")
    check(st["fail_all_recoveries"] == 0, f"{what}: the fail-all sweep ran")
    free = st["pool"]["free"] + st["pool"]["cached"]
    check(st["conserved"] and st["pool"]["in_use"] == 0
          and free == base["pool"]["free"] + base["pool"]["cached"],
          f"{what}: pool {st['pool']} after the drain, fault-free {base['pool']}")
    if cuda:
        check(st["graph_captures"] == 1 and st["graph_replays"] == st["windows"] > 0,
              f"{what}: {st['graph_replays']} replays for {st['windows']} windows "
              f"({st['graph_captures']} captures)")


def fault_tokens(torch, cfg, params, device, prompts, outcomes, base_outs, buckets, dtype,
                 kv_dtype=None):
    """The resolved streams against the fault-free run (equal streams and
    positionwise agreement, reported) and against a teacher-forced pass of
    the plain programs (`agreement`, gated by check_logits: bf16 within
    one step; f32 exact or within F32_CROSS_SHAPE_STEPS at under 1% of
    positions, since a restore re-derives decode-written KV through the
    prefill window)."""
    live = [i for i, o in enumerate(outcomes) if isinstance(o, list)]
    outs = [outcomes[i] for i in live]
    same = [outcomes[i] == base_outs[i] for i in live]
    pos = float(np.mean([a == b for i in live for a, b in zip(outcomes[i], base_outs[i])]))
    ps = [prompts[i] for i in live]
    kern = teacher_forced(torch, params, cfg, ps, outs, buckets, 32, device, kv_dtype=kv_dtype)
    with plain_attention():
        plain = teacher_forced(torch, params, cfg, ps, outs, buckets, 32, device,
                               kv_dtype=kv_dtype)
    st = agreement(torch, kern, plain, torch.tensor(outs, device=device), dtype)
    st.update(dtype=dtype, streams_equal_to_fault_free=sum(same), streams=len(live),
              positions_equal_to_fault_free=pos)
    return st


def replay_after_recovery(torch, cfg, params, device, small):
    """From one engine state after a device-lost recovery (graph_engine's 8
    lanes checkpointed, the pool zeroed in place, the restores replayed
    through the prefill programs and one window run), the captured
    window's replay against the eager `_macro`, byte for byte
    (replay_against_eager)."""
    from nos_tpu_torch.runtime.faults import DeviceLostError

    server, futs = graph_engine(torch, cfg, params, device, small)
    server._recover(DeviceLostError("forced device-lost"))
    check(server.recoveries == 1 and server.slots_restored == len(futs),
          f"faults replay: {server.recoveries} recoveries, {server.slots_restored} restored")
    server._tick()
    check(all(s.active and s.phase == "decoding" for s in server._slots),
          "faults replay: the restored lanes are not decoding after one tick")
    server._sync_tick_state()
    rep = replay_against_eager(torch, server)
    rep["graph_captures"] = server.graph_captures
    for f in futs:
        f.cancel()
    server.stop()
    check(rep["tokens_equal"] and rep["state_equal"] and rep["advanced"]
          and rep["pool_bytes_equal"] and rep["launches_eager"] == rep["launches_replay"],
          f"faults: after a device-lost recovery the replayed window differs from the eager "
          f"one: {rep}")
    if device.type == "cuda":
        check(rep["graph_captures"] == 1, f"faults replay: {rep['graph_captures']} captures")
    return rep


def phase_faults(torch, device, small=False):
    """Surgical recovery at the serving cell's width (the bench GPT, the
    engine phase's settings, its traffic queued at once), the engine at its
    defaults. bf16, native pool: the fault-free run, the seeded schedule
    (FAULT_SEED: a transient, a device-lost at admission, a poison in a
    prefill wave), a device-lost at the third macro window (mid-decode)
    and a poison at the fourth prefill wave (mid-prefill). bf16, int8 pool:
    the fault-free run and the seeded schedule. f32: the fault-free run and
    the mid-decode device-lost. Each fault run is held to check_fault_run
    and its resolved tokens to fault_tokens; then, from one engine state
    after a forced device-lost, the replay against the eager window byte
    for byte. Prints the recoveries by kind, slots restored, replay tokens
    and the restore latency (p50, max) of every run."""
    from nos_tpu_torch import init_gpt
    from nos_tpu_torch.runtime.faults import FaultInjector, FaultSpec

    t0 = time.perf_counter()
    cuda = device.type == "cuda"
    buckets, max_len = engine_sizes(small)
    stats = {}
    cases = [("bfloat16", "fp16", ("seeded", "device_lost", "poison")),
             ("bfloat16", "int8", ("seeded",)),
             ("float32", "fp16", ("device_lost",))]
    injectors = {
        "seeded": lambda: FaultInjector.seeded(FAULT_SEED, n_faults=3, sites=FAULT_SITES,
                                               max_occurrence=8),
        "device_lost": lambda: FaultInjector([FaultSpec("dispatch_macro", 3, "device-lost")]),
        "poison": lambda: FaultInjector([FaultSpec("dispatch_prefill_wave", 4, "poison")])}
    params_by = {}
    for dtype, kv, runs in cases:
        cfg = bench_gpt(dtype, small)
        if dtype not in params_by:
            params_by[dtype] = init_gpt(cfg, torch.Generator().manual_seed(0), device=device)
        params = params_by[dtype]
        max_new, prompts, long_prompts = engine_traffic(cfg, small)
        prompts = prompts + long_prompts
        base_outs, base = fault_run(torch, cfg, params, device, prompts, max_new, buckets,
                                    max_len, kv_dtype=kv)
        check(all(isinstance(o, list) and len(o) == max_new for o in base_outs),
              f"faults {dtype} {kv}: the fault-free run failed a request")
        arm = {"fault_free": base}
        for name in runs:
            what = f"faults {dtype} {kv} {name}"
            outcomes, st = fault_run(torch, cfg, params, device, prompts, max_new, buckets,
                                     max_len, injectors[name](), kv_dtype=kv)
            check_fault_run(torch, st, outcomes, base, what, max_new, cuda)
            if name != "seeded":
                check(st["recoveries"] == 1 and st["slots_restored"] > 0,
                      f"{what}: {st['recoveries']} recoveries, {st['slots_restored']} restored")
            if name == "poison":
                check(st["requests_poisoned"] == 1, f"{what}: no request poisoned")
            st["tokens"] = fault_tokens(torch, cfg, params, device, prompts, outcomes,
                                        base_outs, buckets, dtype,
                                        kv_dtype="int8" if kv == "int8" else None)
            check_logits(st["tokens"], what, F32_CROSS_SHAPE_STEPS)
            log(f"{what}: " + json.dumps({k: st[k] for k in (
                "recoveries", "fired_by_kind", "slots_restored", "replay_tokens",
                "requests_poisoned", "transient_retries", "restore_latency_s", "fired",
                "graph_replays", "windows", "burst_dispatches", "pool", "wall_s")}
                | {"tokens": {k: st["tokens"][k] for k in (
                    "streams_equal_to_fault_free", "streams", "positions_equal_to_fault_free",
                    "top1_agreement", "top1_agreement_1ulp", "max_abs_dlogit",
                    "disagreement_gap_steps")}}))
            arm[name] = st
        stats[f"{dtype}_{kv}"] = arm
    cfg = bench_gpt("bfloat16", small)
    stats["replay"] = replay_after_recovery(torch, cfg, params_by["bfloat16"], device, small)
    log("faults replay after recovery: " + json.dumps(stats["replay"]))
    stats["phase_s"] = time.perf_counter() - t0
    log(f"faults phase_s={stats['phase_s']:.1f}")
    return stats


# -- phase: quota ------------------------------------------------------------------
# bench.py's overload_quota (bench.py:2698): a borrower floods the engine,
# a guaranteed tenant's closed loop lands through preemption. bench.py lets
# the borrowers run 4 windows first; at 4 the youngest borrower is still
# unprefilled (one 256-token chunk a tick), so its preemption spills
# nothing. At 8 all four decode and the victim's prompt blocks go to the
# host tier, to be revived by its restore.
QUOTA = {"n_slots": 8, "max_len": 1024, "buckets": (16, 32, 64, 128, 256), "k": 16,
         "block_size": 32, "total_blocks": 1 + 64, "window_ticks": 128,
         "n_b": 6, "b_len": 256, "b_new": 256, "n_g": 4, "g_len": 64, "g_new": 32,
         "b_lead_windows": 8}
QUOTA_SMALL = {"n_slots": 2, "max_len": 64, "buckets": (8, 16), "k": 4, "block_size": 8,
               "total_blocks": 1 + 10, "window_ticks": 64,
               "n_b": 3, "b_len": 16, "b_new": 24, "n_g": 2, "g_len": 4, "g_new": 8,
               "b_lead_windows": 2}
QUOTA_SHARES = {"g": (0.5, 1.0), "b": (0.0, 1.0)}
# Counters a traced arm and its untraced twin must agree on.
QUOTA_COUNTERS = ("steps_run", "macro_dispatches", "burst_dispatches", "burst_windows_run",
                  "prefill_dispatches", "prefill_tokens", "h2d_uploads", "staging_syncs",
                  "blocking_syncs", "preemptions", "borrowed_ticks", "spills", "revives",
                  "replay_tokens", "graph_replays")


def profiled():
    """A tracing bundle with only its tick profiler armed: the engine's
    `tick_phase_s` and the other tick read-throughs are the profiler's, and
    read zeros without one, as in the reference."""
    from nos_tpu_torch.tracing import EngineTracing

    bundle = EngineTracing()
    bundle.tracer = bundle.recorder = None
    return bundle


def quota_traffic(cfg, q):
    """bench.py's prompts: six borrower prompts, then four of the guaranteed
    tenant, from default_rng([2026, 7, 64])."""
    rng = np.random.default_rng([2026, 7, 64])
    b = [rng.integers(1, cfg.vocab, q["b_len"]).tolist() for _ in range(q["n_b"])]
    g = [rng.integers(1, cfg.vocab, q["g_len"]).tolist() for _ in range(q["n_g"])]
    return b, g


def quota_run(torch, cfg, params, device, q, quota=True, borrowers=True, traced=False,
              kv_dtype="fp16"):
    """One arm of the overload cell on the engine at its defaults (bursts,
    the captured window, radix and spill), driven tick by tick on this
    thread so that a traced arm and its untraced twin run one schedule: a
    warm-up (one g and one b request of 8 tokens), then the borrowers
    (unless `borrowers` is off: the g-solo arm), and once they have decoded
    `b_lead_windows` windows, the guaranteed tenant's closed loop (each
    request submitted when the last resolves). `traced` arms a CostLedger,
    a Metrics registry and EngineTracing. Every quota-armed burst's
    per-window fold is held to the host's nominal bookkeeping as it
    happens. The paged kernels' launch counts are zeroed just before the
    run and read just after. Returns (b outputs, g outputs, stats)."""
    from nos_tpu_torch import DecodeServer
    from nos_tpu_torch.observability import Metrics
    from nos_tpu_torch.ops import paged_attention as pa
    from nos_tpu_torch.runtime.quota import QuotaPolicy, TenantShare
    from nos_tpu_torch.serving import CostLedger
    from nos_tpu_torch.telemetry import percentile
    from nos_tpu_torch.tracing import EngineTracing

    b_prompts, g_prompts = quota_traffic(cfg, q)
    policy = None
    if quota:
        policy = QuotaPolicy({t: TenantShare(*a) for t, a in QUOTA_SHARES.items()},
                             window_ticks=q["window_ticks"])
    server = DecodeServer(
        params, cfg, n_slots=q["n_slots"], max_len=q["max_len"], prompt_buckets=q["buckets"],
        steps_per_dispatch=q["k"], block_size=q["block_size"], total_blocks=q["total_blocks"],
        quota=policy, kv_dtype=kv_dtype, device=device,
        tracing=EngineTracing() if traced else None, metrics=Metrics() if traced else None,
        cost_ledger=CostLedger() if traced else None)
    folds = {"bursts": 0, "windows": 0}
    burst = server._dispatch_burst
    K = q["k"]

    def checked_burst(idxs, n):
        # The host's nominal bookkeeping: a lane runs from the burst's first
        # step until it runs out, so window w executes min(K, total - w*K).
        before = [(s.remaining, s.pos, s.tenant or "") for s in server._slots]
        burst(idxs, n)
        if server._quota is None:
            return
        want = []
        for w in range(n):
            entry = {}
            for i in idxs:
                rem, pos, tenant = before[i]
                took = min(K, max(0, min(n * K, rem, server.max_len - pos) - w * K))
                if took:
                    entry[tenant] = entry.get(tenant, 0) + took
            want.append(entry)
        got = [dict(e) for e in list(server._quota._window)[-n:]]
        check(got == want, f"quota fold: the burst's windows folded {got}, the host's "
                           f"bookkeeping says {want}")
        folds["bursts"] += 1
        folds["windows"] += n

    server._dispatch_burst = checked_burst
    preempt = server._preempt_slot
    moved = {"bytes": 0}

    def counted_preempt(idx):
        spills0 = server.spills
        preempt(idx)
        moved["bytes"] += (server.spills - spills0) * server._bytes_per_block

    server._preempt_slot = counted_preempt
    for p, t in ((g_prompts[0], "g"), (b_prompts[0], "b")):
        fut = server.submit(p, max_new=8, tenant=t)
        tick_until(server, fut.done)
        fut.result()
    n_ttft, n_restore = len(server.ttft_s_by_tenant.get("g", [])), len(server.restore_latency_s)
    warm_windows = server.macro_dispatches + server.burst_windows_run
    sync(torch, device)
    pa.reset_launch_counts()
    t0 = time.perf_counter()
    fbs = [server.submit(p, max_new=q["b_new"], tenant="b") for p in b_prompts] \
        if borrowers else []
    if borrowers:
        tick_until(server, lambda: server.macro_dispatches + server.burst_windows_run
                   >= warm_windows + q["b_lead_windows"])
    lat, g_outs = [], []
    tg0 = time.perf_counter()
    for p in g_prompts:
        tg = time.perf_counter()
        fut = server.submit(p, max_new=q["g_new"], tenant="g")
        tick_until(server, fut.done)
        g_outs.append(fut.result())
        lat.append(time.perf_counter() - tg)
    g_wall = time.perf_counter() - tg0
    tick_until(server, lambda: all(f.done() for f in fbs))
    b_outs = [f.result() for f in fbs]
    sync(torch, device)
    wall = time.perf_counter() - t0
    restore = sorted(server.restore_latency_s[n_restore:])
    stats = {
        "quota": quota, "borrowers": borrowers, "traced": traced, "kv_dtype": kv_dtype,
        "wall_s": wall,
        "g_tok_s": sum(map(len, g_outs)) / g_wall,
        "g_ttft_p95_s": percentile(server.ttft_s_by_tenant["g"][n_ttft:], 95),
        "g_latency_p95_s": percentile(lat, 95),
        "b_tok_s": sum(map(len, b_outs)) / wall if borrowers else None,
        **{c: getattr(server, c) for c in QUOTA_COUNTERS},
        "preempt_spill_bytes": moved["bytes"],
        "restore_latency_s": {"n": len(restore), "p50": percentile(restore, 50) if restore
                              else None, "max": restore[-1] if restore else None},
        "fold_checked": dict(folds),
        "graph_captures": server.graph_captures,
        "windows": server.macro_dispatches + server.burst_windows_run,
        "conserved": server._block_mgr.conserved(),
        "pool": server._block_mgr.counts(),
        "launches": dict(pa.LAUNCHES),
        "routes": {n: dict(r) for n, r in pa.ROUTE_LAUNCHES.items()},
    }
    if traced:
        totals = server._cost.tenant_totals()
        billed = sum(a["decode_tokens"] for a in totals.values())
        served = int(sum(server.macro_tokens_by_slot)) + server.spec_tokens_accepted
        stats["cost_by_tenant"] = totals
        stats["ledger"] = {
            "decode_tokens_billed": billed, "decode_tokens_served": served,
            "slot_seconds_charged": server._cost.charged_slot_seconds(),
            "slot_seconds_total": server.slot_seconds_total,
            "receipts": server.cost_receipts}
        prof = server.tracing.profiler
        stats["tracing"] = {"ticks_profiled": prof.ticks,
                            "coverage": prof.attribution_coverage(),
                            "trace_events": sum(len(server.tracing.tracer.trace(t))
                                                for t in server.tracing.tracer.trace_ids()),
                            "flight_events": server.tracing.recorder.events_recorded,
                            "metric_preemptions": server.metrics.get(
                                "nos_tpu_decode_preemptions")}
    server.stop()
    return b_outs, g_outs, stats


def check_quota_run(st, b_outs, g_outs, q, what, cuda):
    """Every future resolved with its tokens; with a quota, at least one
    preemption, borrowed ticks and the fold held at every burst; the pool
    conserved; on the card one capture and every window a replay of it."""
    check(all(len(o) == q["b_new"] for o in b_outs) and len(b_outs) == (
        q["n_b"] if st["borrowers"] else 0), f"{what}: a borrower future came back short")
    check(len(g_outs) == q["n_g"] and all(len(o) == q["g_new"] for o in g_outs),
          f"{what}: a guaranteed future came back short")
    if st["quota"] and st["borrowers"]:
        check(st["preemptions"] >= 1 and st["borrowed_ticks"] > 0,
              f"{what}: {st['preemptions']} preemptions, {st['borrowed_ticks']} borrowed ticks")
        check(st["preempt_spill_bytes"] > 0 and st["revives"] > 0,
              f"{what}: the preemptions spilled {st['preempt_spill_bytes']} bytes, "
              f"{st['revives']} revives")
        check(st["fold_checked"]["bursts"] > 0, f"{what}: no quota-armed burst was checked")
    check(st["conserved"] and st["pool"]["in_use"] == 0, f"{what}: pool {st['pool']}")
    if cuda:
        check(st["graph_captures"] == 1 and st["graph_replays"] == st["windows"] > 0,
              f"{what}: {st['graph_replays']} replays for {st['windows']} windows "
              f"({st['graph_captures']} captures)")


def quota_tokens(torch, cfg, params, device, q, b_outs, g_outs, dtype, kv_dtype):
    """The served streams (the preempted and restored borrowers and the
    guarantee) against a teacher-forced pass of the plain programs, as the
    faults phase holds restored streams (check_logits; f32 within
    F32_CROSS_SHAPE_STEPS)."""
    b_prompts, g_prompts = quota_traffic(cfg, q)
    kv = "int8" if kv_dtype == "int8" else None
    out = {}
    for name, prompts, outs in (("b", b_prompts, b_outs), ("g", g_prompts, g_outs)):
        kern = teacher_forced(torch, params, cfg, prompts, outs, q["buckets"],
                              q["block_size"], device, kv_dtype=kv)
        with plain_attention():
            plain = teacher_forced(torch, params, cfg, prompts, outs, q["buckets"],
                                   q["block_size"], device, kv_dtype=kv)
        st = agreement(torch, kern, plain, torch.tensor(outs, device=device), dtype)
        del kern, plain
        st["dtype"] = dtype
        check_logits(st, f"quota {dtype} {kv_dtype} {name}", F32_CROSS_SHAPE_STEPS)
        out[name] = {k: st[k] for k in ("top1_agreement", "top1_agreement_1ulp",
                                         "max_abs_dlogit", "mean_abs_dlogit",
                                         "disagreement_gap_steps")}
    return out


def phase_quota(torch, device, small=False):
    """Elastic quotas with preemption at the serving cell's width
    (bench.py's overload_quota on the bench GPT: 8 slots, max_len 1024, K
    16, a pool of 64 blocks that holds four borrowers; six borrower
    requests of 256 tokens x 256 new and a closed loop of four guaranteed
    requests of 64 x 32). Arms: g solo, quota off, quota on with a
    CostLedger, Metrics and EngineTracing armed and its untraced twin, quota
    on over an int8 pool, and quota on in f32. Gates (check_quota_run): every
    future resolves; preemptions and borrowed ticks in the on arms; every
    quota-armed burst's per-window fold equals the host's bookkeeping; the
    pool conserved; one capture, every window a replay; the traced arm's
    tokens, counters and blocking reads equal its twin's; the ledger bills
    every decode token served and its slot-seconds conserve; the on arms'
    streams against the plain programs' oracle. The paged kernels'
    launches of the traced bf16 arm are the phase's own main path: the
    split decode kernel and the window kernel's mma route (the restores'
    prefill tails) launched."""
    from nos_tpu_torch import init_gpt

    t0 = time.perf_counter()
    cuda = device.type == "cuda"
    q = QUOTA_SMALL if small else QUOTA
    main = "float32" if small else "bfloat16"
    stats = {}
    params_by = {}
    arms = [(main, "fp16", "solo", dict(quota=False, borrowers=False)),
            (main, "fp16", "off", dict(quota=False)),
            (main, "fp16", "on_traced", dict(traced=True)),
            (main, "fp16", "on", {}),
            (main, "int8", "on", dict(kv_dtype="int8"))]
    if not small:
        arms.append(("float32", "fp16", "on", {}))
    runs = {}
    for dtype, kv, name, kw in arms:
        cfg = bench_gpt(dtype, small)
        if dtype not in params_by:
            params_by[dtype] = init_gpt(cfg, torch.Generator().manual_seed(0), device=device)
        what = f"quota {dtype} {kv} {name}"
        b_outs, g_outs, st = quota_run(torch, cfg, params_by[dtype], device, q, **kw)
        check_quota_run(st, b_outs, g_outs, q, what, cuda)
        runs[(dtype, kv, name)] = (b_outs, g_outs, st)
        if st["quota"] and st["borrowers"] and name != "on_traced":
            st["tokens"] = quota_tokens(torch, cfg, params_by[dtype], device, q, b_outs,
                                        g_outs, dtype, kv)
        log(f"{what}: " + json.dumps({k: st[k] for k in (
            "g_tok_s", "g_ttft_p95_s", "g_latency_p95_s", "b_tok_s", "preemptions",
            "borrowed_ticks", "spills", "revives", "preempt_spill_bytes",
            "restore_latency_s", "fold_checked", "graph_replays", "windows",
            "burst_dispatches", "blocking_syncs", "wall_s")}
            | {k: st[k] for k in ("tokens", "ledger", "cost_by_tenant", "tracing")
               if k in st}))
        stats[f"{dtype}_{kv}_{name}"] = st
    traced = runs[(main, "fp16", "on_traced")]
    twin = runs[(main, "fp16", "on")]
    check(traced[0] == twin[0] and traced[1] == twin[1],
          "quota: the traced arm's tokens differ from its untraced twin's")
    diff = {c: (traced[2][c], twin[2][c]) for c in QUOTA_COUNTERS
            if traced[2][c] != twin[2][c]}
    check(not diff, f"quota: counters differ tracing on against off: {diff}")
    led = traced[2]["ledger"]
    check(led["decode_tokens_billed"] == led["decode_tokens_served"] > 0,
          f"quota: the ledger billed {led['decode_tokens_billed']} decode tokens, "
          f"the engine served {led['decode_tokens_served']}")
    check(abs(led["slot_seconds_charged"] - led["slot_seconds_total"])
          <= 1e-9 * max(1.0, led["slot_seconds_total"]),
          f"quota: slot-seconds charged {led['slot_seconds_charged']}, "
          f"held {led['slot_seconds_total']}")
    routes = traced[2]["routes"]
    if cuda:
        check_routes(routes, "paged_decode_attention", "split", "quota")
        check_routes(routes, "paged_window_attention",
                     "mma" if main == "bfloat16" else "simt", "quota")
    stats["main"] = {"launches": traced[2]["launches"], "routes": routes}
    stats["phase_s"] = time.perf_counter() - t0
    log(f"quota phase_s={stats['phase_s']:.1f}")
    return stats


# -- phase: trace ------------------------------------------------------------------
# bench.py::_trace_timeline (bench.py:252): the tracing bundle's cost.
TRACE = {"streams": 8, "prompt": 128, "new": 64, "max_len": 512, "k": 16, "block_size": 32,
         "buckets": (16, 32, 64, 128, 256)}
TRACE_SMALL = {"streams": 4, "prompt": 20, "new": 12, "max_len": 64, "k": 4, "block_size": 8,
               "buckets": (8, 16)}


def trace_run(torch, cfg, params, device, t, prompts, traced):
    """One arm: a warm-up pass of the traffic, then the same traffic timed,
    every stream submitted at once and the engine ticked on this thread
    until they resolve. Returns (outputs, wall seconds, report, tracing)."""
    from nos_tpu_torch import DecodeServer
    from nos_tpu_torch.telemetry import collect_serving
    from nos_tpu_torch.tracing import EngineTracing

    tracing = EngineTracing() if traced else None
    server = DecodeServer(params, cfg, n_slots=t["streams"], max_len=t["max_len"],
                          prompt_buckets=t["buckets"], steps_per_dispatch=t["k"],
                          block_size=t["block_size"], tracing=tracing, device=device)
    for _ in range(2):  # warm-up, then the timed pass
        futs = [server.submit(p, max_new=t["new"]) for p in prompts]
        sync(torch, device)
        t0 = time.perf_counter()
        tick_until(server, lambda: all(f.done() for f in futs))
        outs = [f.result() for f in futs]
        sync(torch, device)
        wall = time.perf_counter() - t0
    report = collect_serving(server)
    server.stop()
    return outs, wall, report, tracing


def phase_trace(torch, device, small=False):
    """The tracing cell (bench.py::_trace_timeline on the bench GPT in
    bf16: 8 streams, prompts of 128 tokens, 64 new, max_len 512, K 16),
    tracing off and on in turns (off, on, on, off, off, on). Gates: tokens and every
    counter of collect_serving (the profiler's own tick count aside) equal
    between the arms, blocking reads included; the phases attribute >= 0.95
    of the profiled tick wall. Reports tok/s of each arm (best of three), the
    overhead, the off arm's own wall noise, per-phase ms, and the host
    overhead per engine dispatch (the profiler's dispatch windows are host
    issue time on CUDA)."""
    from nos_tpu_torch import init_gpt
    from nos_tpu_torch.telemetry import report_counter_fields

    t0 = time.perf_counter()
    t = TRACE_SMALL if small else TRACE
    dtype = "float32" if small else "bfloat16"
    cfg = bench_gpt(dtype, small)
    params = init_gpt(cfg, torch.Generator().manual_seed(0), device=device)
    rng = np.random.default_rng([2026, 9, t["streams"], t["prompt"]])
    prompts = [rng.integers(1, cfg.vocab, t["prompt"]).tolist() for _ in range(t["streams"])]
    fields = [f for f in report_counter_fields() if f != "ticks_profiled"]
    walls = {False: [], True: []}
    runs = []
    for traced in (False, True, True, False, False, True):
        o, wall, rep, tr = trace_run(torch, cfg, params, device, t, prompts, traced)
        walls[traced].append(wall)
        runs.append((traced, o, {f: getattr(rep, f) for f in fields}))
        if traced:
            report, tracing = rep, tr
    for traced, o, counters in runs[1:]:
        check(o == runs[0][1], f"trace: tokens differ (tracing {traced}) from the first run's")
        diff = {f: (counters[f], runs[0][2][f]) for f in fields if counters[f] != runs[0][2][f]}
        check(not diff, f"trace: counters differ (tracing {traced}) from the first run's: {diff}")
    coverage = tracing.profiler.attribution_coverage()
    check(coverage >= 0.95, f"trace: phase attribution covers {coverage} < 0.95 of tick wall")
    tokens = t["streams"] * t["new"]
    tok_off, tok_on = tokens / min(walls[False]), tokens / min(walls[True])
    dispatches = report.steps_run + report.prefill_dispatches
    stats = {
        "streams": t["streams"], "max_new": t["new"], "dtype": dtype,
        "tok_s_tracing_off": tok_off, "tok_s_tracing_on": tok_on,
        "tracing_overhead_pct": 100.0 * (1.0 - tok_on / tok_off),
        "wall_noise_pct": 100.0 * (max(walls[False]) / min(walls[False]) - 1.0),
        "walls_s": {"off": walls[False], "on": walls[True]},
        "blocking_syncs": runs[0][2]["blocking_syncs"],
        "ticks_profiled": report.ticks_profiled,
        "phase_ms": {k: v * 1e3 for k, v in sorted(report.tick_phase_s.items())},
        "phase_attribution_coverage": coverage,
        "tick_wall_ms": report.tick_wall_s * 1e3,
        "dispatch_issue_ms": report.tick_dispatch_s * 1e3,
        "host_overhead_ms": report.tick_host_overhead_s * 1e3,
        "engine_dispatches": dispatches,
        "host_overhead_ms_per_dispatch": 1e3 * report.tick_host_overhead_s / max(1, dispatches),
        "flight_recorder_events": tracing.recorder.events_recorded,
        "phase_s": time.perf_counter() - t0,
    }
    log("trace: " + json.dumps(stats))
    return stats


# -- phase: fleet ------------------------------------------------------------------
# bench.py's three fleet cells on the bench GPT, each at its own engine
# settings, seeds and traffic: _multi_replica (:125; with a migrate under
# live engine threads added), _fleet_failover (:1488) and _shared_kv_fleet
# (:1701); then a cross-width drain (tests/test_sharded_decode.py:254).
MULTI = {"replicas": 3, "n_slots": 4, "max_len": 1024, "buckets": (16, 32, 64, 128, 256),
         "k": 16, "block_size": 32, "sys": 256, "suffix": 32, "counts": (6, 4, 3, 2, 2, 1),
         "max_new": 32, "warm": 288,
         # The migrate arm: prompts of mig_prompt tokens and mig_new new ones,
         # mig_src of them on the migrated replica and mig_other on each other.
         "mig_prompt": 64, "mig_new": 384, "mig_src": 12, "mig_other": 4}
MULTI_SMALL = {"replicas": 3, "n_slots": 2, "max_len": 128, "buckets": (8, 16), "k": 4,
               "block_size": 8, "sys": 24, "suffix": 8, "counts": (3, 2, 2, 1, 1, 1),
               "max_new": 8, "warm": 30, "mig_prompt": 10, "mig_new": 40, "mig_src": 6,
               "mig_other": 2}
# The failover and shared-KV cells' engine (bench.py:1546, :1770): tiny by
# design, the bench GPT's width.
TINY_ENGINE = {"n_slots": 2, "max_len": 64, "prompt_buckets": (8, 16), "steps_per_dispatch": 2,
               "burst_windows": 1, "block_size": 8, "seed": 11}
FAILOVER = {"replicas": 3, "streams": 6, "prompt": 12, "max_new": 24, "kill_wave": 5,
            "max_waves": 600}
SHARED_KV = {"replicas": 3, "streams": 6, "sys": 16, "user": 8, "max_new": 8}
# The cross-width drain's two streams (tests/test_sharded_decode.py:254).
CROSS_TP = {"prompts": ([5, 11, 3, 42, 7, 9, 2, 1], [9, 8, 7, 6, 5, 4, 3, 2, 1]),
            "max_new": (40, 34)}


def card_line(torch, device):
    """`nvidia-smi --query-gpu=name,power.limit`, printed beside every number
    the fleet phase reports (a rehearsal says so)."""
    if device.type != "cuda":
        return "cpu rehearsal, no card"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    return out[0] if out else "nvidia-smi: no output"


def check_windows(engines, what, cuda):
    """On the card every engine captured its window once and every window it
    ran was a replay of that capture."""
    if not cuda:
        return
    for i, e in enumerate(engines):
        windows = e.macro_dispatches + e.burst_windows_run
        check(e.graph_captures == 1 and e.graph_replays == windows,
              f"{what}: engine {i} ran {windows} windows with {e.graph_replays} replays "
              f"and {e.graph_captures} captures")


def fleet_oracle(torch, cfg, params, device, prompts, outs, buckets, block_size, dtype,
                 mesh=None):
    """The served streams against a teacher-forced pass of the plain
    programs (`agreement`); returns (stats, the plain logits)."""
    kern = teacher_forced(torch, params, cfg, prompts, outs, buckets, block_size, device,
                          mesh=mesh)
    with plain_attention():
        plain = teacher_forced(torch, params, cfg, prompts, outs, buckets, block_size,
                               device, mesh=mesh)
    st = agreement(torch, kern, plain, torch.tensor(outs, device=device), dtype)
    st["dtype"] = dtype
    return st, plain


def same_streams(torch, plain, outs, other, dtype, what):
    """Streams of one arm (`outs`, whose teacher-forced plain logits are
    `plain`) against another placement's (`other`): how many are equal, and
    at each first divergence the gap, in steps of the logits' dtype, between
    the two arms' tokens in the plain logits there (one prefix, so one
    distribution). Gated in f32 only: a divergence must be a near-tie
    within F32_CROSS_SHAPE_STEPS, the rule for programs of other shapes."""
    gaps = []
    for i, (a, b) in enumerate(zip(outs, other)):
        t = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if t is None:
            continue
        row = plain[i, t]
        top = row.max().abs().clamp_min(1e-30)
        step = float(torch.exp2(torch.floor(torch.log2(top)) - (7 if dtype == "bfloat16"
                                                                 else 23)))
        gaps.append(abs(float(row[a[t]] - row[b[t]])) / step)
    st = {"streams": len(outs), "equal": len(outs) - len(gaps),
          "divergence_gap_steps": sorted(gaps)}
    if dtype == "float32":
        check(all(g <= F32_CROSS_SHAPE_STEPS for g in gaps),
              f"{what}: f32 streams diverge across placements beyond the cross-shape "
              f"rule: gaps {sorted(gaps)} steps > {F32_CROSS_SHAPE_STEPS}")
    return st


def multi_traffic(cfg, m):
    """bench.py:144: six tenants' 256-token system prompts, one populator
    each, a skewed burst interleaved round-robin across tenants, and an
    out-of-trace warm prompt, from default_rng([2026, 8, 3]); then the
    migrate arm's prompts from default_rng([2026, 8, 4])."""
    srng = np.random.default_rng([2026, 8, 3])
    tenants = [f"t{k}" for k in range(6)]
    sys_prompts = {t: srng.integers(1, cfg.vocab, m["sys"]).tolist() for t in tenants}
    warm_trace = [(t, sys_prompts[t] + srng.integers(1, cfg.vocab, m["suffix"]).tolist())
                  for t in tenants]
    by_tenant = [[(t, sys_prompts[t] + srng.integers(1, cfg.vocab, m["suffix"]).tolist())
                  for _ in range(c - 1)] for t, c in zip(tenants, m["counts"])]
    burst = [rows[j] for j in range(max(m["counts"])) for rows in by_tenant if j < len(rows)]
    warm_prompt = srng.integers(1, cfg.vocab, m["warm"]).tolist()
    mrng = np.random.default_rng([2026, 8, 4])
    n_mig = m["mig_src"] + (m["replicas"] - 1) * m["mig_other"]
    mig = [mrng.integers(1, cfg.vocab, m["mig_prompt"]).tolist() for _ in range(n_mig)]
    return warm_trace, burst, warm_prompt, mig


def multi_run(torch, cfg, params, device, m, policy, migrate):
    """One arm of bench.py's _multi_replica: 3 replicas of 4 slots behind a
    PrefixRouter (`policy`), each engine on its own thread (`start=True`),
    one shared Tracer; the warm-up, the six populators, then the skewed
    burst, timed. Then the migrate traffic, submitted to the replicas
    directly (mig_src on replica-0): with `migrate`, once replica-0
    decodes, a new replica is built (its window captured while the other
    engines serve) and `migrate_replica` moves replica-0's streams; with
    `migrate` False the traffic runs where it was placed (the reference
    placement); with None there is no migrate traffic."""
    from nos_tpu_torch import DecodeServer, constants
    from nos_tpu_torch.runtime.decode_server import _DEVICE_GATE
    from nos_tpu_torch.serving import PrefixRouter, ReplicaSet, migrate_replica
    from nos_tpu_torch.telemetry import percentile
    from nos_tpu_torch.tracing import EngineTracing, Tracer

    warm_trace, burst, warm_prompt, mig_prompts = multi_traffic(cfg, m)
    tracer = Tracer()
    build_s = []

    def engine():
        t = time.perf_counter()
        e = DecodeServer(params, cfg, n_slots=m["n_slots"], max_len=m["max_len"],
                         prompt_buckets=m["buckets"], steps_per_dispatch=m["k"],
                         block_size=m["block_size"], tracing=EngineTracing(tracer=tracer),
                         device=device)
        build_s.append(time.perf_counter() - t)
        return e

    rs = ReplicaSet([engine() for _ in range(m["replicas"])], start=True)
    router = PrefixRouter(rs, policy=policy)
    engines = [h.engine for h in rs.handles]
    try:
        for h in rs.handles:
            for _ in range(2):
                h.engine.generate(warm_prompt, max_new=m["max_new"], timeout=600)
        warm_ttft = {h.replica_id: len(h.engine.ttft_s) for h in rs.handles}
        hits0 = sum(h.engine.prefix_hit_blocks for h in rs.handles)
        charged0 = sum(h.engine.prefill_tokens for h in rs.handles)
        sync(torch, device)
        phase0 = [dict(h.engine.tick_phase_s) for h in rs.handles]
        t0 = time.perf_counter()
        futs = [router.submit(p, max_new=m["max_new"], tenant=t) for t, p in warm_trace]
        outs = [list(f.result(timeout=600)) for f in futs]
        futs = [router.submit(p, max_new=m["max_new"], tenant=t) for t, p in burst]
        outs += [list(f.result(timeout=600)) for f in futs]
        sync(torch, device)
        wall = time.perf_counter() - t0
        report = rs.fleet_report()
        # The timed phase's tick time by phase, summed over the replicas'
        # profilers (host wall; the three threads overlap).
        tick_phase_ms = {}
        for h, before in zip(rs.handles, phase0):
            for k, v in h.engine.tick_phase_s.items():
                tick_phase_ms[k] = tick_phase_ms.get(k, 0.0) + 1e3 * (v - before.get(k, 0.0))
        ttft = [s for h in rs.handles for s in h.engine.ttft_s[warm_ttft[h.replica_id]:]]
        hittable = sum((len(p) - 1) // rs.block_size for _, p in burst)
        stats = {
            "policy": policy,
            "tok_s_aggregate": len(outs) * m["max_new"] / wall, "wall_s": wall,
            "ttft_p50_s": percentile(ttft, 50), "ttft_p95_s": percentile(ttft, 95),
            "prefix_hit_rate_burst": (report.prefix_hit_blocks - hits0) / hittable,
            "prefill_tokens_charged": report.prefill_tokens - charged0,
            "tick_phase_ms": tick_phase_ms,
            "router": {k: v for k, v in router.snapshot().items() if k != "replicas"},
        }
        mig_outs = []
        if migrate is None:
            mig_prompts = []
        # The migrate traffic: mig_src requests on replica-0, mig_other on
        # each other replica, all on their engines' threads.
        n_src = m["mig_src"] if mig_prompts else 0
        targets = [0] * n_src + [1 + i // m["mig_other"]
                                 for i in range(len(mig_prompts) - n_src)]
        mig_futs = [rs.handles[r].engine.submit(p, max_new=m["mig_new"])
                    for r, p in zip(targets, mig_prompts)]
        src = rs.handles[0]
        deadline = time.perf_counter() + 600
        while mig_futs and not any(s.active and s.phase == "decoding" and len(s.refs) >= 2
                                   for s in src.engine._slots):
            check(time.perf_counter() < deadline, "fleet migrate: replica-0 never decoded")
            time.sleep(0.0005)
        if migrate:
            # The new replica's window is captured while the other engines'
            # threads serve: their ticks wait at the device gate during the
            # capture itself and run around it.
            steps0 = [h.engine.steps_run for h in rs.handles]
            new = engine()
            stats["capture_under_load_s"] = build_s[-1]
            stats["build_idle_s"] = build_s[:m["replicas"]]
            if new._graph is not None:
                stats["gate_wait_s"] = new._graph.gate_wait_s
                stats["warmup_and_capture_s"] = new._graph.capture_s
                stats["warmup_and_capture_idle_s"] = [e._graph.capture_s
                                                      for e in engines[:m["replicas"]]]
            stats["steps_during_build"] = [h.engine.steps_run - n
                                           for h, n in zip(rs.handles, steps0)]
            # The build may outlast the streams it started beside. Under
            # the device gate no tick runs: there, find a replica-0 slot
            # decoding with more tokens left than one tick dispatches and
            # stop that engine's loop, which then runs at most the one tick
            # waiting at the gate, so the drain finds the slot mid-decode.
            room = src.engine.burst_windows * m["k"]
            deadline = time.perf_counter() + 600
            while True:
                with _DEVICE_GATE.exclusive():
                    held = any(s.active and s.phase == "decoding" and len(s.refs) >= 2
                               and s.remaining > room for s in src.engine._slots)
                    if held:
                        src.engine._stop.set()
                if held:
                    break
                check(time.perf_counter() < deadline,
                      "fleet migrate: replica-0 never decoded after the build")
                time.sleep(0.0005)
            t_d = time.perf_counter()
            new_handle, drain = migrate_replica(rs, router, src.replica_id, new, start=True)
            stats["drain_wall_s"] = time.perf_counter() - t_d
            stats["slots_migrated"] = drain.slots_migrated
            stats["requests_migrated"] = drain.requests_migrated
            stats["destinations"] = drain.destinations
            check(drain.slots_migrated >= 1 and drain.rolled_back == 0,
                  f"fleet migrate: no stream moved mid-decode ({drain})")
            check(src.state == constants.REPLICA_STATE_RETIRED
                  and src.engine._block_mgr.conserved(),
                  f"fleet migrate: the source is {src.state}, pool conserved "
                  f"{src.engine._block_mgr.conserved()}")
            engines.append(new)
        mig_outs = [list(f.result(timeout=600)) for f in mig_futs]
        sync(torch, device)
    finally:
        rs.stop()
    # Read the engines once their threads have stopped: a future resolves
    # just before its slot is released.
    for e in engines:
        check(e._block_mgr.conserved(), f"fleet multi {policy}: a pool is not conserved")
    stats["engines"] = [{k: getattr(e, k) for k in ("steps_run", "graph_captures",
                                                     "graph_replays", "macro_dispatches",
                                                     "burst_windows_run")}
                        for e in engines]
    check_windows(engines, f"fleet multi {policy}", device.type == "cuda")
    return outs, mig_outs, [p for _, p in warm_trace + burst], mig_prompts, stats


def failover_traffic(cfg):
    srng = np.random.default_rng([2026, 14, 1])
    return [srng.integers(1, cfg.vocab, FAILOVER["prompt"]).tolist()
            for _ in range(FAILOVER["streams"])]


def failover_run(torch, cfg, params, device, prompts, arm, state):
    """One arm of bench.py's _fleet_failover, ticked on this thread: the
    reference (supervised, fault-free) or `on` (replica-0's host dies once
    every victim stream holds a checkpoint, at or after kill_wave; the
    supervisor walks it to dead and fails its streams over)."""
    from nos_tpu_torch import DecodeServer, constants
    from nos_tpu_torch.runtime.faults import (FAULT_REPLICA_LOST, ReplicaLostError,
                                              classify_fault)
    from nos_tpu_torch.serving import (FleetSupervisor, PrefixRouter, ReplicaFaultInjector,
                                       ReplicaSet)
    from nos_tpu_torch.tracing import EngineTracing, Tracer

    f = FAILOVER
    tracer = Tracer()
    rs = ReplicaSet([DecodeServer(params, cfg, tracing=EngineTracing(tracer=tracer),
                                  device=device, **TINY_ENGINE)
                     for _ in range(f["replicas"])])
    router = PrefixRouter(rs)
    inj = ReplicaFaultInjector() if arm == "on" else None
    sup = FleetSupervisor(rs, router, suspect_after=2, dead_after=3, fault_injector=inj,
                          sleep=lambda s: None)
    victim = "replica-0"
    futs = [sup.submit(p, max_new=f["max_new"]) for p in prompts]
    if arm == "on":
        state["victim_idx"] = [i for i, fu in enumerate(futs)
                               if id(fu) in (sup._streams.get(victim) or {})]
    handle = rs.get(victim)
    killed_at = dead_sel = None
    waves = 0
    t0 = time.perf_counter()
    while waves < f["max_waves"]:
        waves += 1
        for h in rs.handles:
            if h.replica_id == victim and killed_at is not None:
                continue
            if h.state == constants.REPLICA_STATE_ACTIVE:
                h.engine._tick()
        if arm == "on" and killed_at is None and waves >= f["kill_wave"]:
            cks = sup._checkpoints.get(victim) or {}
            if all(id(futs[i]) in cks and len(cks[id(futs[i])].generated) >= 1
                   for i in state["victim_idx"]):
                inj.kill(victim)
                killed_at = waves
        sup.probe()
        if dead_sel is None and handle.health == constants.REPLICA_HEALTH_DEAD:
            dead_sel = handle.routed_requests
        if all(fu.done() for fu in futs):
            break
    sync(torch, device)
    wall = time.perf_counter() - t0
    check(all(fu.done() for fu in futs), f"fleet failover {arm}: stranded futures")
    outcomes = []
    for fu in futs:
        exc = fu.exception()
        if exc is not None:
            check(isinstance(exc, ReplicaLostError)
                  and classify_fault(exc) == FAULT_REPLICA_LOST,
                  f"fleet failover {arm}: an unclassified failure {exc!r}")
        outcomes.append(exc if exc is not None else list(fu.result()))
    survivors = [h.engine for h in rs.handles if h.replica_id != victim or arm != "on"]
    for e in survivors:
        check(e._block_mgr.conserved(), f"fleet failover {arm}: a survivor's pool leaks")
    rep = sup.report()
    st = {"arm": arm, "waves": waves, "killed_at": killed_at, "wall_s": wall,
          "completed": sum(isinstance(o, list) for o in outcomes),
          "errored": sum(not isinstance(o, list) for o in outcomes),
          "replica_deaths": rep.replica_deaths, "failovers": rep.failovers,
          "futures_errored": rep.futures_errored,
          "failover_replay_tokens": rep.failover_replay_tokens,
          "failover_latency_p50_s": rep.failover_latency_p50_s,
          "failover_latency_p95_s": rep.failover_latency_p95_s,
          "replay_tokens": sum(e.replay_tokens for e in survivors),
          "selections_of_dead_after_detection": (
              0 if dead_sel is None else handle.routed_requests - dead_sel)}
    if arm == "on":
        check(killed_at is not None and rep.replica_deaths == 1 and rep.failovers >= 1
              and st["selections_of_dead_after_detection"] == 0,
              f"fleet failover: the kill did not fail over: {st}")
    check_windows(survivors, f"fleet failover {arm}", device.type == "cuda")
    rs.stop()
    return outcomes, st


def shared_kv_traffic(cfg):
    s = SHARED_KV
    srng = np.random.default_rng([2026, 16, 1])
    system = srng.integers(1, cfg.vocab, s["sys"]).tolist()
    return [system + srng.integers(1, cfg.vocab, s["user"]).tolist()
            for _ in range(s["streams"])]


def shared_kv_runs(torch, cfg, params, device, prompts):
    """bench.py's _shared_kv_fleet, ticked on this thread: dedup (three
    replicas serving the same six streams, a store each against one shared
    store), turn 2 on a fresh replica (cold against prewarmed from the
    shared store), and failover with the store against without. Returns
    (outputs by arm, stats)."""
    from nos_tpu_torch import DecodeServer, constants
    from nos_tpu_torch.serving import (FleetKVStore, FleetSupervisor, PrefixRouter,
                                       ReplicaFaultInjector, ReplicaSet)
    from nos_tpu_torch.telemetry import percentile
    from nos_tpu_torch.tracing import EngineTracing

    s = SHARED_KV
    cuda = device.type == "cuda"
    built = []

    def make(store):
        e = DecodeServer(params, cfg, kv_store=store, tracing=EngineTracing(), device=device,
                         **TINY_ENGINE)
        built.append(e)
        return e

    def serve(engine, reqs, idle_ticks=8):
        futs = [engine.submit(p, max_new=s["max_new"]) for p in reqs]
        for _ in range(4000):
            if all(f.done() for f in futs):
                break
            engine._tick()
        outs = [list(f.result(timeout=10)) for f in futs]
        for _ in range(idle_ticks):
            engine._tick()  # the idle sweep publishes into the store
        return outs

    def dedup(shared):
        fleet_store = FleetKVStore(1 << 24) if shared else None
        stores, outs, engines = [], [], []
        for _ in range(s["replicas"]):
            store = fleet_store if shared else FleetKVStore(1 << 24)
            stores.append(store)
            engines.append(make(store))
            outs.append(serve(engines[-1], prompts))
        st = {"store_entries": (fleet_store.entries if shared
                                else sum(x.entries for x in stores)),
              "store_bytes": (fleet_store.host_bytes if shared
                              else sum(x.host_bytes for x in stores)),
              "store_dedup_hits": sum(e.store_dedup_hits for e in engines),
              "store_hits": sum(e.store_hits for e in engines),
              "store_published_blocks": sum(e.store_published_blocks for e in engines),
              "blocking_syncs": sum(e.blocking_syncs for e in engines),
              "spills": sum(e.spills for e in engines)}
        check(all(x.conserved() and x.pinned_entries == 0 for x in stores),
              f"fleet shared_kv dedup shared={shared}: a store not conserved or pinned")
        for e in engines:
            e.stop()
        return outs, st, fleet_store

    private_outs, private, _ = dedup(False)
    shared_outs, shared, fleet_store = dedup(True)
    check(shared["store_entries"] * 2 <= private["store_entries"],
          f"fleet shared_kv: shared entries {shared['store_entries']} > 1/2 of the "
          f"summed private {private['store_entries']}")

    def turn2(store, prewarm):
        engine = make(store)
        queued = engine.prewarm_from_store() if prewarm else 0
        for _ in range(500):
            if not engine._pending_prewarm:
                break
            engine._tick()
        sync(torch, device)
        outs = serve(engine, prompts, idle_ticks=0)
        st = {"prewarm_blocks_queued": queued, "prewarm_tokens": engine.prewarm_tokens,
              "prefill_tokens_charged": engine.prefill_tokens,
              "prefix_hit_tokens": engine.prefix_hit_tokens, "store_hits": engine.store_hits,
              "ttft_p50_s": percentile(engine.ttft_s, 50),
              "ttft_p95_s": percentile(engine.ttft_s, 95)}
        engine.stop()
        return outs, st

    cold_outs, cold = turn2(None, False)
    warm_outs, warm = turn2(fleet_store, True)
    check(warm["prefill_tokens_charged"] < cold["prefill_tokens_charged"],
          f"fleet shared_kv turn 2: prewarmed prefill {warm['prefill_tokens_charged']} "
          f"not below cold {cold['prefill_tokens_charged']}")
    check(fleet_store.conserved() and fleet_store.pinned_entries == 0,
          "fleet shared_kv: the shared store is not conserved after the prewarm")

    fo_prompts = prompts[:2]
    ref = make(None)
    fo_want = serve(ref, fo_prompts, idle_ticks=0)
    ref.stop()

    def failover(store):
        rs = ReplicaSet([make(store) for _ in range(2)])
        router = PrefixRouter(rs)
        inj = ReplicaFaultInjector()
        sup = FleetSupervisor(rs, router, suspect_after=2, dead_after=3, fault_injector=inj,
                              sleep=lambda x: None)
        futs = [sup.submit(p, max_new=s["max_new"]) for p in fo_prompts]
        vid = rs.handles[0].replica_id

        def ticked(pred, downed=()):
            for _ in range(800):
                for h in rs.handles:
                    if (h.state == constants.REPLICA_STATE_ACTIVE
                            and h.replica_id not in downed):
                        h.engine._tick()
                sup.probe()
                if pred():
                    return True
            return False

        n_victim = len(sup._streams.get(vid, {}))
        captured = ticked(lambda: len(sup._checkpoints.get(vid, {})) >= n_victim and all(
            len(ck.generated) >= 2 for ck in sup._checkpoints.get(vid, {}).values()))
        inj.kill(vid)
        finished = ticked(lambda: all(f.done() for f in futs), downed={vid})
        check(captured and finished and all(f.exception() is None for f in futs),
              f"fleet shared_kv failover store={store is not None}: captured {captured}, "
              f"finished {finished}")
        outs = [list(f.result(0)) for f in futs]
        survivors = [h.engine for h in rs.handles if h.replica_id != vid]
        st = {"victim_streams": n_victim, "failovers": sup.failovers,
              "replay_tokens": sum(e.replay_tokens for e in survivors),
              "failover_revive_tokens": sum(e.failover_revive_tokens for e in survivors),
              "failover_latency_p50_s": sup.report().failover_latency_p50_s}
        check(all(e._block_mgr.conserved() for e in survivors),
              "fleet shared_kv failover: a survivor's pool leaks")
        rs.stop()
        return outs, st

    fo_cold_outs, fo_cold = failover(None)
    fo_store_obj = FleetKVStore(1 << 24)
    fo_store_outs, fo_store = failover(fo_store_obj)
    check(fo_store["failover_revive_tokens"] > 0
          and fo_store["replay_tokens"] < fo_cold["replay_tokens"],
          f"fleet shared_kv failover: with the store {fo_store}, without {fo_cold}")
    check(fo_store_obj.conserved() and fo_store_obj.pinned_entries == 0,
          "fleet shared_kv failover: the store is not conserved or holds pins")
    check_windows(built, "fleet shared_kv", cuda)
    stats = {"dedup": {"private": private, "shared": shared,
                       "entries_ratio_shared_vs_summed":
                           shared["store_entries"] / max(1, private["store_entries"])},
             "turn2": {"cold": cold, "prewarmed": warm},
             "failover": {"without_store": fo_cold, "with_store": fo_store}}
    outs = {"private": private_outs, "shared": shared_outs, "cold": cold_outs,
            "prewarmed": warm_outs, "fo_want": fo_want, "fo_cold": fo_cold_outs,
            "fo_store": fo_store_outs}
    return outs, stats


def cross_tp_drain(torch, cfg, params, device):
    """The f32 cross-width drain (tests/test_sharded_decode.py:254): two
    streams start on a tp=2 replica (both shards on this card), drain to a
    tp=1 replica, then migrate to a fresh tp=2 one; they finish as an
    undrained tp=1 run within the cross-shape rule."""
    from nos_tpu_torch import DecodeServer
    from nos_tpu_torch.parallel import build_mesh
    from nos_tpu_torch.serving import PrefixRouter, ReplicaSet, drain_replica, migrate_replica

    c = CROSS_TP
    mesh = build_mesh({"tp": 2}, devices=[device, device])

    def make(wide):
        kw = dict(TINY_ENGINE)
        return (DecodeServer(params, cfg, mesh=mesh, **kw) if wide
                else DecodeServer(params, cfg, device=device, **kw))

    base = make(False)
    futs = [base.submit(p, max_new=n) for p, n in zip(c["prompts"], c["max_new"])]
    tick_until(base, lambda: all(f.done() for f in futs))
    baseline = [list(f.result()) for f in futs]
    src, mid = make(True), make(False)
    rs = ReplicaSet([src, mid])
    router = PrefixRouter(rs)
    futs = [src.submit(p, max_new=n) for p, n in zip(c["prompts"], c["max_new"])]
    for _ in range(4):
        src._tick()
    report = drain_replica(rs, router, "replica-0")
    check(report.slots_migrated + report.requests_migrated == 2 and src._block_mgr.conserved(),
          f"fleet cross-tp: the drain to tp=1 moved {report}")
    for _ in range(4):
        mid._tick()
    back = make(True)
    _, report2 = migrate_replica(rs, router, "replica-1", back, start=False)
    check(mid._block_mgr.conserved(), "fleet cross-tp: the tp=1 pool leaks")
    tick_until(back, lambda: all(f.done() for f in futs))
    got = [list(f.result()) for f in futs]
    check(back._block_mgr.conserved() and back.replay_tokens > 0,
          "fleet cross-tp: the streams did not replay on the tp=2 destination")
    check_windows([base, src, mid, back], "fleet cross-tp", device.type == "cuda")
    rs.stop()
    return got, baseline, {"to_tp1": {"slots": report.slots_migrated,
                                      "requests": report.requests_migrated},
                           "to_tp2": {"slots": report2.slots_migrated,
                                      "requests": report2.requests_migrated}}


def phase_fleet(torch, device, small=False):
    """The serving plane on the card: bench.py's _multi_replica (round_robin
    against prefix, then a migrate under live engine threads),
    _fleet_failover (the supervisor against a fault-free reference) and
    _shared_kv_fleet (dedup, prewarm, failover with and without the store)
    on the bench GPT, bf16 (the main path) then f32, and in f32 the
    cross-width drain. The f32 half serves no migrate traffic (its 20
    requests of 384 new tokens and their oracle; the script's time limit).
    The launch counts are zeroed before each dtype's
    arms and read after them, before any oracle runs. Gates: every future
    resolves (the supervisor's ReplicaLostErrors classified), every pool
    and store conserved with no pin left, shared entries <= 1/2 of the
    summed private ones, the prewarmed turn 2 charging less prefill than
    cold, the store failover reviving tokens and replaying fewer than
    without it, one capture per engine and every window a replay of it,
    every stream held to the plain programs' teacher-forced oracle
    (check_logits; f32 within F32_CROSS_SHAPE_STEPS), every decode launch
    on "split" and every bf16 window launch on "mma". Streams equal across
    placements are reported, and gated in f32 under the cross-shape rule
    (same_streams)."""
    from nos_tpu_torch import init_gpt
    from nos_tpu_torch.ops import paged_attention as pa

    t0 = time.perf_counter()
    cuda = device.type == "cuda"
    card = card_line(torch, device)
    m = MULTI_SMALL if small else MULTI
    tiny = TINY_ENGINE["prompt_buckets"]
    stats = {"card": card}
    for dtype in ("bfloat16", "float32"):
        cfg = bench_gpt(dtype, small)
        params = init_gpt(cfg, torch.Generator().manual_seed(0), device=device)
        st = stats[dtype] = {}
        # The serving arms.
        parts = st["parts_s"] = {}
        t1 = time.perf_counter()
        pa.reset_launch_counts()
        bf16 = dtype == "bfloat16"
        rr_outs, rr_mig, prompts, mig_prompts, st["round_robin"] = multi_run(
            torch, cfg, params, device, m, "round_robin", migrate=False if bf16 else None)
        px_outs, px_mig, _, _, st["prefix"] = multi_run(
            torch, cfg, params, device, m, "prefix", migrate=True if bf16 else None)
        parts["multi"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        fprompts = failover_traffic(cfg)
        state = {}
        ref_outs, st["failover_reference"] = failover_run(torch, cfg, params, device,
                                                          fprompts, "reference", state)
        on_outs, st["failover_on"] = failover_run(torch, cfg, params, device, fprompts, "on",
                                                  state)
        parts["failover"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        sprompts = shared_kv_traffic(cfg)
        skv, st["shared_kv"] = shared_kv_runs(torch, cfg, params, device, sprompts)
        parts["shared_kv"] = time.perf_counter() - t1
        if dtype == "float32":
            t1 = time.perf_counter()
            cross, cross_base, st["cross_tp"] = cross_tp_drain(torch, cfg, params, device)
            parts["cross_tp"] = time.perf_counter() - t1
        sync(torch, device)
        t1 = time.perf_counter()
        routes = st["routes"] = {n: dict(r) for n, r in pa.ROUTE_LAUNCHES.items()}
        launches = st["launches"] = dict(pa.LAUNCHES)
        if cuda:
            check_routes(routes, "paged_decode_attention", "split", f"fleet {dtype}")
            check_routes(routes, "paged_window_attention",
                         "mma" if dtype == "bfloat16" else "simt", f"fleet {dtype}")
        # The oracles.
        for name, outs, other, ps, n in (
                ("round_robin", rr_outs, None, prompts, m["max_new"]),
                ("prefix", px_outs, rr_outs, prompts, m["max_new"]),
                ("migrate", px_mig, rr_mig, mig_prompts, m["mig_new"])):
            if not outs:
                continue
            check(all(len(o) == n for o in outs), f"fleet {name} {dtype}: short streams")
            tok, plain = fleet_oracle(torch, cfg, params, device, ps, outs, m["buckets"],
                                      m["block_size"], dtype)
            check_logits(tok, f"fleet {name}", F32_CROSS_SHAPE_STEPS)
            st[f"{name}_tokens"] = {k: tok[k] for k in (
                "top1_agreement", "top1_agreement_1ulp", "max_abs_dlogit",
                "disagreement_gap_steps")}
            if other is not None:
                st[f"{name}_equal"] = same_streams(torch, plain, outs, other, dtype,
                                                   f"fleet {name} {dtype}")
        done = [i for i, o in enumerate(on_outs) if isinstance(o, list)]
        check(all(isinstance(o, list) for o in ref_outs) and done,
              f"fleet failover {dtype}: the reference failed a stream or none completed")
        tok, plain = fleet_oracle(torch, cfg, params, device, [fprompts[i] for i in done],
                                  [on_outs[i] for i in done], tiny, 8, dtype)
        check_logits(tok, "fleet failover", F32_CROSS_SHAPE_STEPS)
        st["failover_equal"] = same_streams(torch, plain, [on_outs[i] for i in done],
                                            [ref_outs[i] for i in done], dtype,
                                            f"fleet failover {dtype}")
        base = skv["private"][0]
        tok, plain = fleet_oracle(torch, cfg, params, device, sprompts, base, tiny, 8, dtype)
        check_logits(tok, "fleet shared_kv", F32_CROSS_SHAPE_STEPS)
        eq = {}
        arms = [(f"{name}_{r}", o) for name in ("private", "shared")
                for r, o in enumerate(skv[name])] + [(n, skv[n]) for n in ("cold", "prewarmed")]
        for name, o in arms:
            eq[name] = same_streams(torch, plain, base, o, dtype,
                                    f"fleet shared_kv {name} {dtype}")["equal"]
        tok, plain = fleet_oracle(torch, cfg, params, device, sprompts[:2], skv["fo_want"],
                                  tiny, 8, dtype)
        check_logits(tok, "fleet shared_kv failover", F32_CROSS_SHAPE_STEPS)
        for name in ("fo_cold", "fo_store"):
            eq[name] = same_streams(torch, plain, skv["fo_want"], skv[name], dtype,
                                    f"fleet shared_kv {name} {dtype}")["equal"]
        st["shared_kv"]["streams_equal"] = eq
        if dtype == "float32":
            n = min(CROSS_TP["max_new"])
            got, want = [g[:n] for g in cross], [w[:n] for w in cross_base]
            tok, plain = fleet_oracle(torch, cfg, params, device, list(CROSS_TP["prompts"]),
                                      got, tiny, 8, dtype)
            check_logits(tok, "fleet cross-tp", F32_CROSS_SHAPE_STEPS)
            st["cross_tp"]["equal"] = same_streams(torch, plain, got, want, dtype,
                                                   "fleet cross-tp")
        parts["oracles"] = time.perf_counter() - t1
        skd = st["shared_kv"]
        summary = {
            "card": card,
            "tok_s_aggregate": {p: st[p]["tok_s_aggregate"] for p in ("round_robin", "prefix")},
            "ttft_p50_p95_s": {p: [st[p]["ttft_p50_s"], st[p]["ttft_p95_s"]]
                               for p in ("round_robin", "prefix")},
            "prefix_hit_rate": {p: st[p]["prefix_hit_rate_burst"]
                                for p in ("round_robin", "prefix")},
            "prefill_tokens_charged": {p: st[p]["prefill_tokens_charged"]
                                       for p in ("round_robin", "prefix")},
            "policies_equal": st["prefix_equal"],
            "tick_phase_ms": {p: st[p]["tick_phase_ms"] for p in ("round_robin", "prefix")},
            "migrate": {k: st["prefix"].get(k) for k in (
                "capture_under_load_s", "build_idle_s", "gate_wait_s", "warmup_and_capture_s",
                "warmup_and_capture_idle_s", "steps_during_build", "drain_wall_s",
                "slots_migrated", "requests_migrated")} | {"equal": st.get("migrate_equal")},
            "failover": {k: st["failover_on"][k] for k in (
                "failover_latency_p50_s", "failover_latency_p95_s", "failover_replay_tokens",
                "replay_tokens", "completed", "errored", "killed_at")}
            | {"equal": st["failover_equal"]},
            "store_private_vs_shared": {k: [skd["dedup"]["private"][k],
                                            skd["dedup"]["shared"][k]]
                                        for k in ("store_entries", "store_bytes")},
            "turn2_cold_vs_prewarmed": {k: [skd["turn2"]["cold"][k],
                                            skd["turn2"]["prewarmed"][k]]
                                        for k in ("prefill_tokens_charged", "ttft_p50_s",
                                                  "ttft_p95_s")},
            "store_failover": skd["failover"], "parts_s": parts,
            "launches": {n: launches[n] for n in ("paged_decode_attention",
                                                  "paged_window_attention")},
            "launches_by_route": {n: routes[n] for n in ("paged_decode_attention",
                                                         "paged_window_attention")},
        }
        log(f"fleet {dtype}: " + json.dumps(summary))
        log(f"fleet {dtype} detail: " + json.dumps(st))
    stats["main"] = {"routes": stats["bfloat16"]["routes"]}
    stats["phase_s"] = time.perf_counter() - t0
    log(f"fleet phase_s={stats['phase_s']:.1f} ({card})")
    return stats


# -- phase: disagg -----------------------------------------------------------------
# bench.py's phase-disaggregation cells (_disagg_long_context, bench.py:1932):
# interference_4k_disagg (:2480) and disagg_long_context (:2498), with
# bench.py's parameters, and its fleet_pressure cell (_fleet_pressure, :1154).
DISAGG_4K = {"name": "interference_4k_disagg", "prompt_len": 4096, "budget": 1024,
             "n_short": 7, "short_len": 128, "short_new": 512, "long_new": 16,
             "block_size": 32, "k": 4, "max_seq": 8192}
DISAGG_32K = {"name": "disagg_long_context", "prompt_len": 32768, "budget": 1024,
              "n_short": 4, "short_len": 24, "short_new": 512, "long_new": 32,
              "block_size": 32, "k": 4, "max_seq": 32896}
DISAGG_4K_SMALL = dict(DISAGG_4K, prompt_len=96, budget=16, n_short=3, short_len=12,
                       short_new=24, long_new=6, block_size=8, k=2, max_seq=512)
DISAGG_32K_SMALL = dict(DISAGG_32K, prompt_len=160, budget=16, n_short=2, short_len=6,
                        short_new=24, long_new=8, block_size=8, k=2, max_seq=512)
DISAGG_SEED = 11
PRESSURE = {"replicas": 3, "n_slots": 2, "max_len": 64, "buckets": (8, 16), "k": 4,
            "block_size": 8, "new": 16, "every": 2, "trials": 2,
            "window_ticks": 64, "shares": {"gold": (0.5, 1.0), "bulk": (0.0, 1.0)},
            "slo_ttft_p95_s": 2.0, "slo_min_tok_s": 1.0}
# The kernel shapes held and timed for the disagg cells: the windows the
# main path launches for the long prompts (one chunk of 32768 rows over
# 32768 keys, and of 4096 over 4096), and a 1024-row window (the prefill
# budget's width) whose keys end at 32768; the decode replica's batch of
# four short lanes beside the 32k lane.
DISAGG_WINDOWS = ({"w": 32768, "keys": 32768}, {"w": 4096, "keys": 4096},
                  {"w": 1024, "keys": 32768})
DISAGG_DECODE_LIMITS = [280, 280, 280, 280, 32784]


def disagg_traffic(cfg, c):
    """bench.py:1983: the short prompts, a warm long prompt and the measured
    long prompt (distinct, so the measured prefill is real admission work),
    from default_rng([prompt_len, n_short, short_max_new])."""
    srng = np.random.default_rng([c["prompt_len"], c["n_short"], c["short_new"]])
    shorts = [srng.integers(1, cfg.vocab, c["short_len"]).tolist() for _ in range(c["n_short"])]
    warm_long = srng.integers(1, cfg.vocab, c["prompt_len"]).tolist()
    longs = [srng.integers(1, cfg.vocab, c["prompt_len"]).tolist()]
    return shorts, warm_long, longs


def disagg_buckets(c):
    """bench.py:2002: the shorts' shape, the chunk shape, the whole prompt's."""
    p = c["prompt_len"]
    return tuple(sorted({max(8, 1 << (c["short_len"] - 1).bit_length()),
                         max(16, c["budget"]),
                         p if p & (p - 1) == 0 else 1 << (p - 1).bit_length()}))


def disagg_arm(torch, cfg, params, device, c, temperature, disagg):
    """One arm of bench.py's _disagg_long_context on engine threads: the
    shorts to steady state, then the long prompt; the decode tokens the
    shorts produce between its submit and its first token (counted at
    dispatch, as the engine counts them), that window and the long TTFT
    (bench.py's measures: the final chunk's dispatch, which runs ahead of
    the device unless a tick syncs), and the long request's latency to
    its last token, device work included. Colocated: one unified engine.
    Disaggregated: a prefill and a decode replica over one
    FleetKVStore(1 << 31), a PrefixRouter and a HandoffCoordinator, every
    request submitted through the coordinator; the prefill engine's
    `_export_handoff` is timed by a wrapper (the export runs before the
    hook, outside the coordinator's latency)."""
    from nos_tpu_torch import DecodeServer, constants
    from nos_tpu_torch.serving import (FleetKVStore, HandoffCoordinator, PrefixRouter,
                                       ReplicaSet, utilization_block)
    from nos_tpu_torch.telemetry import collect_serving
    from nos_tpu_torch.tracing import EngineTracing

    shorts, warm_long, longs = disagg_traffic(cfg, c)
    max_len = c["prompt_len"] + c["long_new"] + 2 * c["block_size"]
    what = f"disagg {c['name']} {cfg.dtype} t={temperature} " + (
        "disaggregated" if disagg else "colocated")

    def engine(store=None):
        return DecodeServer(params, cfg, n_slots=c["n_short"] + 1, max_len=max_len,
                            prompt_buckets=disagg_buckets(c), steps_per_dispatch=c["k"],
                            prefill_budget_tokens=c["budget"], block_size=c["block_size"],
                            kv_store=store, temperature=temperature, seed=DISAGG_SEED,
                            tracing=EngineTracing(), device=device)

    def wait(cond, t0, label):
        while not cond():
            check(time.perf_counter() - t0 < 900, f"{what}: {label} timed out")
            time.sleep(0.002)

    mem0 = None
    if device.type == "cuda":
        gc.collect()  # an earlier arm's engines, still in reference cycles
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
    store = coord = None
    export_s, capture_s, publish_s = [], [], []
    if disagg:
        store = FleetKVStore(1 << 31)
        pre, dec = engine(store), engine(store)
        rs = ReplicaSet([pre, dec], start=True,
                        roles=[constants.REPLICA_ROLE_PREFILL, constants.REPLICA_ROLE_DECODE])
        coord = HandoffCoordinator(rs, PrefixRouter(rs, kv_store=store))
        engines = [pre, dec]

        def timed(obj, name, into):
            fn = getattr(obj, name)

            def wrapper(*args):
                t = time.perf_counter()
                out = fn(*args)
                into.append(time.perf_counter() - t)
                return out

            setattr(obj, name, wrapper)

        # The export, and inside it the capture (its first-token read waits
        # for the final chunk on the device) and the chain's publish.
        timed(pre, "_export_handoff", export_s)
        timed(pre, "_checkpoint_slot", capture_s)
        timed(pre._block_mgr, "publish_slot_chain", publish_s)
        submit = lambda p, m: coord.submit(p, max_new=m)  # noqa: E731
        stop = rs.stop
    else:
        pre = dec = engine().start()
        engines = [pre]
        submit = lambda p, m: pre.submit(p, max_new=m)  # noqa: E731
        stop = pre.stop
    cuda = device.type == "cuda"
    mem = {}

    def peak(stage):
        # The arm's peak so far above what was allocated when it began.
        if cuda:
            mem[stage] = torch.cuda.max_memory_allocated() - mem0

    def tick_window():
        return [(dict(e.tick_phase_s), e.blocking_syncs, e.steps_run) for e in engines]

    peak("built")
    try:
        for e in engines:  # the short shape, on every engine
            e.generate(shorts[0], max_new=4, timeout=900)
        peak("warm_short")
        pre.generate(warm_long, max_new=2, timeout=900)  # the long shape
        peak("warm_long")
        warm_ttft = len(pre.ttft_s)
        warm_tokens = int(dec.macro_tokens_by_slot.sum())
        hits0 = dec.prefix_hit_tokens
        t0 = time.perf_counter()
        futs = [submit(p, c["short_new"]) for p in shorts]
        wait(lambda: len(pre.ttft_s) >= warm_ttft + c["n_short"]
             and int(dec.macro_tokens_by_slot.sum()) >= warm_tokens + 4 * c["k"],
             t0, "short-stream steady state")
        n_ttft = len(pre.ttft_s)
        base = int(dec.macro_tokens_by_slot.sum())
        before = tick_window()
        t_long = time.perf_counter()
        futs += [submit(p, c["long_new"]) for p in longs]
        wait(lambda: len(pre.ttft_s) >= n_ttft + len(longs), t_long, "long prefill")
        window = time.perf_counter() - t_long
        during = int(dec.macro_tokens_by_slot.sum()) - base
        # Where each engine's host time went in the prefill window (the
        # tick profiler's phases), its blocking reads and decode steps.
        in_window = [{"tick_phase_ms": {k: 1e3 * (v - b[0].get(k, 0.0)) for k, v in a[0].items()
                                        if v - b[0].get(k, 0.0) > 0.0},
                      "blocking_syncs": a[1] - b[1], "steps_run": a[2] - b[2]}
                     for a, b in zip(tick_window(), before)]
        long_outs = [list(f.result(timeout=900)) for f in futs[len(shorts):]]
        long_latency = time.perf_counter() - t_long
        outs = [list(f.result(timeout=900)) for f in futs[:len(shorts)]] + long_outs
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak("served")
    finally:
        if coord is not None:
            coord.detach()
        stop()
    st = {"decode_tok_s_during_prefill": during / window,
          "decode_tokens_during_prefill": during, "prefill_window_s": window,
          "ttft_long_s": pre.ttft_s[n_ttft], "long_latency_s": long_latency, "wall_s": wall,
          # The arm's own peak above what was allocated when it began.
          "peak_mem_bytes": (torch.cuda.max_memory_allocated() - mem0
                             if device.type == "cuda" else None),
          "mem_at_start_bytes": mem0, "peak_mem_by_stage_bytes": mem,
          "prefill_window_engines": in_window,
          "chip_accounting": utilization_block([collect_serving(e) for e in engines]),
          "engines": [{k: getattr(e, k) for k in (
              "graph_captures", "graph_replays", "macro_dispatches", "burst_dispatches",
              "burst_windows_run", "prefill_dispatches", "prefix_hit_tokens",
              "handoff_exports", "handoff_ingests", "handoff_published_blocks",
              "handoff_revived_tokens", "store_published_blocks")} for e in engines]}
    check(all(len(o) == n for o, n in zip(outs, [c["short_new"]] * len(shorts)
                                              + [c["long_new"]] * len(longs))),
          f"{what}: short streams")
    for i, e in enumerate(engines):
        check(e._block_mgr.conserved(), f"{what}: engine {i}'s pool is not conserved")
        if device.type == "cuda":
            check_replays({**st["engines"][i], "graph_captures": e.graph_captures},
                          f"{what} engine {i}", bursts=False)
    if disagg:
        rep = coord.report()
        n_req = len(futs)
        # Shipped, not recomputed: every prompt block below the block of a
        # handed-off replay's last token, not already on the decode
        # engine's device, was revived from the store.
        revivable = sum((len(p) // c["block_size"]) * c["block_size"] for p in shorts + longs)
        hit = dec.prefix_hit_tokens - hits0
        st.update({
            "handoffs": coord.handoffs, "handoff_reroutes": coord.handoff_reroutes,
            "handoffs_errored": coord.handoffs_errored,
            "handoff_latency_p50_s": rep.handoff_latency_p50_s,
            "handoff_latency_p95_s": rep.handoff_latency_p95_s,
            "export_s": export_s, "export_capture_s": capture_s,
            "export_publish_s": publish_s,
            "export_share_of_handoff": (sum(export_s) / (sum(export_s) + rep.handoff_wall_s)
                                        if export_s else None),
            "handoff_exports": pre.handoff_exports, "handoff_ingests": dec.handoff_ingests,
            "handoff_published_blocks": pre.handoff_published_blocks,
            "write_through_published_blocks": pre.store_published_blocks,
            "handoff_revived_tokens": dec.handoff_revived_tokens,
            "revivable_tokens": revivable, "device_hit_tokens": hit,
            "store_entries": store.entries, "store_bytes": store.host_bytes,
            "store_drops": store.drops, "store_pinned": store.pinned_entries,
        })
        check(coord.handoffs == n_req and coord.handoffs_errored == 0
              and pre.handoff_exports == n_req and dec.handoff_ingests == n_req,
              f"{what}: handoffs {coord.handoffs}, errored {coord.handoffs_errored}, "
              f"exports {pre.handoff_exports}, ingests {dec.handoff_ingests}, want {n_req}")
        check(store.conserved() and store.pinned_entries == 0,
              f"{what}: the store is not conserved or holds pins")
        check(dec.handoff_revived_tokens > 0, f"{what}: no handed-off token revived")
        check(store.drops > 0 or dec.handoff_revived_tokens == revivable - hit,
              f"{what}: revived {dec.handoff_revived_tokens} tokens, the store held "
              f"{revivable - hit} ({revivable} revivable, {hit} device hits)")
    log(f"{what}: " + json.dumps({k: st[k] for k in (
        "wall_s", "prefill_window_s", "decode_tok_s_during_prefill", "ttft_long_s",
        "long_latency_s", "peak_mem_bytes", "peak_mem_by_stage_bytes",
        "prefill_window_engines", "handoff_revived_tokens", "handoff_latency_p50_s",
        "export_s", "export_capture_s", "export_publish_s") if k in st}))
    return outs, shorts + longs, st


def sampled_draw(torch, plain, served, serials, temperature, dtype):
    """The threefry draw over the plain logits (engine_sampled's rule, seed
    DISAGG_SEED): token t of the stream with serial s must be
    argmax(gumbel(fold_in(fold_in(key, s), t)) + logits / T). In bf16 a
    served token counts when its perturbed score lies within one bf16 step
    (over T) of the draw's maximum: check_logits' one-step rule for greedy.
    `misses_at`: the [stream, step] positions outside that rule (outside
    the exact draw in f32)."""
    from nos_tpu_torch import prng

    n, steps, vocab = plain.shape
    keys = prng.fold_in(prng.fold_in(prng.PRNGKey(DISAGG_SEED, device=plain.device),
                                     serials[:, None].expand(-1, steps)),
                        torch.arange(steps, device=plain.device))
    score = prng.gumbel(keys, (vocab,)) + plain / temperature
    want = score.argmax(dim=-1)
    got = score.gather(-1, served[..., None].long())[..., 0]
    mant = 7 if dtype == "bfloat16" else 23
    top = plain.abs().max(dim=-1).values.clamp_min(1e-30)
    step = torch.exp2(torch.floor(torch.log2(top)) - mant) / temperature
    within = (score.max(dim=-1).values - got) <= step
    ok = within if dtype == "bfloat16" else want == served
    return {"token_match": (want == served).float().mean().item(),
            "token_match_1step": within.float().mean().item(),
            "misses_at": (~ok).nonzero().tolist()}


# The long stream of a disaggregated cell (16 or 32 positions, the stream
# that carries the handoff) is gated on its own: at most LONG_MISSES of its
# positions may lie beyond one step of the plain maximum (beyond the exact
# pick in f32), each within LONG_STEPS steps of the logits' dtype, the
# count F32_CROSS_SHAPE_STEPS allows across program shapes. Every gap is
# printed.
LONG_MISSES = 1
LONG_STEPS = 4


def check_long(st, what, dtype, temperature):
    """The long stream's gate (see LONG_MISSES), beside check_logits'
    max|dlogit| bounds on its kernel arm."""
    check(st["finite"], f"{what}: non-finite logits")
    check(st["max_abs_dlogit"] <= (MAX_DLOGIT_BF16 if dtype == "bfloat16" else 0.5),
          f"{what}: max|dlogit| {st['max_abs_dlogit']}")
    if dtype == "bfloat16":
        check(st["mean_abs_dlogit"] <= MEAN_DLOGIT_BF16,
              f"{what}: mean|dlogit| {st['mean_abs_dlogit']} > {MEAN_DLOGIT_BF16}")
    if temperature != 0.0:
        check(len(st["misses_at"]) <= (LONG_MISSES if dtype == "bfloat16" else 0),
              f"{what}: {len(st['misses_at'])} tokens off the threefry draw over plain "
              f"logits at {st['misses_at']}")
        return
    tol = 1.0 if dtype == "bfloat16" else 0.0
    beyond = [g for g in st["disagreement_gap_steps"] if g > tol]
    check(len(beyond) <= LONG_MISSES and all(g <= LONG_STEPS for g in beyond),
          f"{what}: {len(beyond)} positions beyond {tol} steps of the plain maximum "
          f"(gaps {st['disagreement_gap_steps']} at {st['disagreements_at']}; allowed "
          f"{LONG_MISSES} within {LONG_STEPS})")


def disagg_oracle(torch, cfg, params, device, c, prompts, arms, temperature, serials):
    """The plain programs' teacher-forced oracle over both arms' streams
    (`arms`: the colocated and the disaggregated outputs), at the engine's
    own buckets (the long prompt in one chunk of its bucket, as the engine
    prefills it). The shorts and the long stream are forced and gated
    apart (their lengths differ). The shorts are forced once for both
    arms, each distinct stream once, and gated by check_logits (f32 within
    F32_CROSS_SHAPE_STEPS), or, sampled, against the threefry draw over
    the plain logits (sampled_draw; every token in f32, 98% within one
    step in bf16) with the kernel arm within check_logits' dlogit bounds.
    The long stream: check_long; the disaggregated arm's is forced as its
    destination replayed it (teacher_forced's `handoff`) and, greedy, also
    held against the colocated shape's plain arm (`colocated_shape`).
    Returns (stats by arm and group, the colocated arm's plain logits by
    group)."""
    n = c["n_short"]
    what = f"disagg {c['name']} t={temperature}"
    colo, dis = arms["colocated"], arms["disaggregated"]

    def forced(ps, os_, shaped, which=("kernel", "plain")):
        got = []
        for arm in which:
            with plain_attention() if arm == "plain" else contextlib.nullcontext():
                got.append(teacher_forced(torch, params, cfg, ps, os_, disagg_buckets(c),
                                          c["block_size"], device, handoff=shaped))
        return got

    def judged(name, arm, kern, plain, os_, ser, extra=None):
        served = torch.tensor(os_, device=device)
        st = agreement(torch, kern, plain, served, cfg.dtype)
        st["dtype"] = cfg.dtype
        if temperature != 0.0:
            st.update(sampled_draw(torch, plain, served, torch.tensor(ser, device=device),
                                   temperature, cfg.dtype))
        st.update(extra or {})
        label = f"{what} {arm} {name}"
        if name == "long":
            check_long(st, f"{label} {cfg.dtype}", cfg.dtype, temperature)
        elif temperature == 0.0:
            check_logits(st, label, F32_CROSS_SHAPE_STEPS)
        else:
            check(st["finite"] and st["max_abs_dlogit"] <= (
                MAX_DLOGIT_BF16 if cfg.dtype == "bfloat16" else 0.5),
                  f"{label} {cfg.dtype}: max|dlogit| {st['max_abs_dlogit']}")
            rule = "token_match" if cfg.dtype == "float32" else "token_match_1step"
            bound = 1.0 if cfg.dtype == "float32" else 0.98
            check(st[rule] >= bound, f"{label} {cfg.dtype}: {rule} {st[rule]} < {bound}")
        keys = (("top1_agreement", "top1_agreement_1ulp", "disagreement_gap_steps",
                 "disagreements_at", "top1_agreement_kernel_arm") if temperature == 0.0
                else ("token_match", "token_match_1step", "misses_at"))
        return {k: st[k] for k in keys + ("max_abs_dlogit", "mean_abs_dlogit")
                + tuple(extra or ())} | {"positions": served.numel(),
                                         "handoff_shaped": arm == "disaggregated"
                                         and name == "long"}

    stats = {"colocated": {}, "disaggregated": {}}
    # The shorts: the colocated streams, then the disaggregated ones that
    # differ, in one batch.
    differ = [i for i in range(n) if dis[i] != colo[i]]
    ps = prompts[:n] + [prompts[i] for i in differ]
    os_ = colo[:n] + [dis[i] for i in differ]
    ser = serials[:n] + [serials[i] for i in differ]
    kern, plain = forced(ps, os_, False)
    rows = {"colocated": list(range(n)),
            "disaggregated": [n + differ.index(i) if i in differ else i for i in range(n)]}
    for arm, r in rows.items():
        stats[arm]["short"] = judged("short", arm, kern[r], plain[r], [os_[i] for i in r],
                                     [ser[i] for i in r])
    plains = {"short": plain[rows["colocated"]]}
    del kern, plain
    # The long stream, each arm at its own shape.
    lp, ls = prompts[n:], serials[n:]
    kern, plain = forced(lp, colo[n:], False)
    stats["colocated"]["long"] = judged("long", "colocated", kern, plain, colo[n:], ls)
    plains["long"] = plain
    kern, plain = forced(lp, dis[n:], True)
    extra = None
    if temperature == 0.0:
        plain_c = plains["long"] if dis[n:] == colo[n:] else forced(lp, dis[n:], False,
                                                                   ("plain",))[0]
        seen = agreement(torch, plain_c, plain_c, torch.tensor(dis[n:], device=device),
                         cfg.dtype)
        extra = {"colocated_shape": {k: seen[k] for k in (
            "top1_agreement_1ulp", "disagreement_gap_steps", "disagreements_at")}}
    stats["disaggregated"]["long"] = judged("long", "disaggregated", kern, plain, dis[n:],
                                            ls, extra)
    return stats, plains


def disagg_cell(torch, device, c, dtype, temperatures, small):
    """One cell in one dtype: per temperature the colocated arm, then the
    disaggregated one, the launch counts zeroed before the arms and read
    after them; then the oracles, and the streams the arms have in common
    (same_streams: gated in f32)."""
    from nos_tpu_torch import init_gpt
    from nos_tpu_torch.ops import paged_attention as pa

    cfg = dataclasses.replace(bench_gpt(dtype, small), max_seq=c["max_seq"])
    params = init_gpt(cfg, torch.Generator().manual_seed(0), device=device)
    cuda = device.type == "cuda"
    out = {}
    pa.reset_launch_counts()
    runs = {}
    t0 = time.perf_counter()
    for t in temperatures:
        runs[t] = {arm: disagg_arm(torch, cfg, params, device, c, t, arm == "disaggregated")
                   for arm in ("colocated", "disaggregated")}
    sync(torch, device)
    out["arms_s"] = time.perf_counter() - t0
    routes = {n: dict(r) for n, r in pa.ROUTE_LAUNCHES.items()}
    out["launches"] = dict(pa.LAUNCHES)
    out["routes"] = routes
    if cuda:
        check_routes(routes, "paged_decode_attention", "split", f"disagg {c['name']} {dtype}")
        check_routes(routes, "paged_window_attention", "mma" if dtype == "bfloat16" else "simt",
                     f"disagg {c['name']} {dtype}")
    # Serials: two warm requests on the admitting engine, then the shorts
    # and the long prompt in submit order.
    serials = list(range(3, 3 + c["n_short"] + 1))
    t0 = time.perf_counter()
    for t, arms in runs.items():
        tkey = "greedy" if t == 0.0 else f"temp_{t}"
        (colo_outs, prompts, colo), (dis_outs, _, dis) = arms["colocated"], arms["disaggregated"]
        n = c["n_short"]
        tokens, plains = disagg_oracle(torch, cfg, params, device, c, prompts,
                                       {"colocated": colo_outs, "disaggregated": dis_outs},
                                       t, serials)
        colo["tokens"], dis["tokens"] = tokens["colocated"], tokens["disaggregated"]
        rate = colo["decode_tok_s_during_prefill"]
        out[tkey] = {
            "colocated": colo, "disaggregated": dis,
            "outputs_identical": dis_outs == colo_outs,
            "decode_interference_ratio": (dis["decode_tok_s_during_prefill"] / rate
                                          if rate else None),
            "same_streams": {
                "short": same_streams(torch, plains["short"], colo_outs[:n], dis_outs[:n],
                                      dtype, f"disagg {c['name']} short {dtype}"),
                "long": same_streams(torch, plains["long"], colo_outs[n:], dis_outs[n:],
                                     dtype, f"disagg {c['name']} long {dtype}")}
            if t == 0.0 else {"equal": sum(a == b for a, b in zip(colo_outs, dis_outs)),
                              "streams": len(colo_outs)},
        }
        del plains
    out["oracle_s"] = time.perf_counter() - t0
    return out


def pressure_traffic(cfg):
    """bench.py:1199: warm, light, hot-burst, bulk-flood and gold-arrival
    prompts of 12 tokens from default_rng([2026, 12, 3])."""
    srng = np.random.default_rng([2026, 12, 3])
    warm = [srng.integers(1, cfg.vocab, 12).tolist() for _ in range(3)]
    light = [("gold", srng.integers(1, cfg.vocab, 12).tolist())]
    hot = [("bulk", srng.integers(1, cfg.vocab, 12).tolist()) for _ in range(4)]
    flood = [("bulk", srng.integers(1, cfg.vocab, 12).tolist()) for _ in range(4)]
    gold = [("gold", srng.integers(1, cfg.vocab, 12).tolist()) for _ in range(3)]
    return warm, light, hot, flood, gold


def debug_plane(obs, token, tracer):
    """Every endpoint of the running ObservabilityServer: 200 with the token
    on /metrics, /healthz, /readyz, /debug, /debug/pressure,
    /debug/accounting, /debug/events and one /debug/trace/<id>; 401 without
    it on /metrics and /debug/pressure."""
    import http.client

    from nos_tpu_torch import constants as K

    def get(path, auth=True):
        conn = http.client.HTTPConnection("127.0.0.1", obs.port, timeout=30)
        try:
            conn.request("GET", path, headers={"Authorization": f"Bearer {token}"}
                         if auth else {})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    trace_ids = tracer.trace_ids()
    check(trace_ids, "disagg pressure: the shared tracer holds no trace")
    paths = ["/metrics", "/healthz", "/readyz", K.DEBUG_PATH_INDEX, K.DEBUG_PATH_PRESSURE,
             K.DEBUG_PATH_ACCOUNTING, K.DEBUG_PATH_EVENTS,
             K.DEBUG_PATH_TRACE_PREFIX + trace_ids[0]]
    status = {p: get(p)[0] for p in paths}
    status.update({p + " (no token)": get(p, auth=False)[0]
                   for p in ("/metrics", K.DEBUG_PATH_PRESSURE)})
    check(all(status[p] == 200 for p in paths)
          and status["/metrics (no token)"] == 401
          and status[K.DEBUG_PATH_PRESSURE + " (no token)"] == 401,
          f"disagg pressure: debug plane answered {status}")
    surfaces = json.loads(get(K.DEBUG_PATH_INDEX)[1])["surfaces"]
    receipt = json.loads(get(K.DEBUG_PATH_TRACE_PREFIX + trace_ids[0])[1]).get("receipt")
    return {"status": status, "surfaces": surfaces, "trace_receipt": receipt is not None}


def pressure_run(torch, cfg, params, device, p, monitor_on):
    """One arm of bench.py's _fleet_pressure: three quota-armed replicas
    sharing one CostLedger and one Tracer, ticked by hand on this thread,
    a FleetMonitor sampling every `every` ticks (monitor on); the warm-up,
    light load, the hot burst on replica-0, the bulk flood and the gold
    arrivals on replica-1. Beside the monitor-on arm an ObservabilityServer
    (127.0.0.1, an ephemeral port, a bearer token) serves the monitor, the
    tracer, a FlightRecorder and the ledger; its endpoints are read once
    the gold arrivals are in, and that time is taken out of the arm's
    wall."""
    import secrets

    from nos_tpu_torch import DecodeServer, constants
    from nos_tpu_torch.observability import HealthManager, Metrics, ObservabilityServer
    from nos_tpu_torch.runtime.quota import QuotaPolicy, TenantShare
    from nos_tpu_torch.serving import (CostLedger, FleetMonitor, ReplicaSet, SLOTarget,
                                       utilization_block)
    from nos_tpu_torch.telemetry import collect_serving
    from nos_tpu_torch.tracing import EngineTracing, Tracer

    warm, light, hot, flood, gold = pressure_traffic(cfg)
    shares = {t: TenantShare(*s) for t, s in p["shares"].items()}
    ledger, tracer = CostLedger(), Tracer()
    engines = [DecodeServer(params, cfg, n_slots=p["n_slots"], max_len=p["max_len"],
                            prompt_buckets=p["buckets"], steps_per_dispatch=p["k"],
                            burst_windows=1, block_size=p["block_size"], seed=DISAGG_SEED,
                            quota=QuotaPolicy(dict(shares), window_ticks=p["window_ticks"]),
                            tracing=EngineTracing(tracer=tracer), cost_ledger=ledger,
                            device=device)
               for _ in range(p["replicas"])]
    rs = ReplicaSet(engines)
    mon = obs = None
    token = secrets.token_hex(16)
    if monitor_on:
        mon = FleetMonitor(rs, metrics=Metrics(), ledger=ledger, slo={"gold": SLOTarget(
            ttft_p95_s=p["slo_ttft_p95_s"], min_tok_s=p["slo_min_tok_s"])})
        obs = ObservabilityServer(mon.metrics, HealthManager(), host="127.0.0.1", port=0,
                                  metrics_token=token, tracer=tracer,
                                  recorder=engines[0]._recorder, pressure=mon,
                                  accounting=ledger).start()
    reports, detect, state = [], {"starved_agrees": None}, {"ticks": 0}

    def tick(n=1):
        for _ in range(n):
            for e in engines:
                e._tick()
            state["ticks"] += 1
            if mon is not None and state["ticks"] % p["every"] == 0:
                rep = mon.sample()
                reports.append(rep)
                if (detect["starved_agrees"] is None
                        and rep.tenants.get("gold") == constants.PRESSURE_TENANT_STARVED):
                    detect["starved_agrees"] = bool(engines[1]._quota.is_starved("gold"))

    futs = []
    try:
        wf = [e.submit(pr, max_new=p["new"]) for e, pr in zip(engines, warm)]
        while not all(f.done() for f in wf):
            for e in engines:
                e._tick()
        for f in wf:
            f.result(timeout=600)
        sync(torch, device)
        t0 = time.perf_counter()
        futs += [engines[2].submit(pr, max_new=p["new"], tenant=t) for t, pr in light]
        tick(2 * p["every"])
        w_hot = mon.windows_sampled if mon is not None else 0
        futs += [engines[0].submit(pr, max_new=p["new"], tenant=t) for t, pr in hot]
        tick(2 * p["every"])
        futs += [engines[1].submit(pr, max_new=p["new"], tenant=t) for t, pr in flood]
        tick(3 * p["every"])
        w_starved = mon.windows_sampled if mon is not None else 0
        futs += [engines[1].submit(pr, max_new=p["new"], tenant=t) for t, pr in gold]
        tick(2 * p["every"])
        plane, plane_s = None, 0.0
        if obs is not None:
            t_plane = time.perf_counter()
            plane = debug_plane(obs, token, tracer)
            plane_s = time.perf_counter() - t_plane
        while not all(f.done() for f in futs):
            tick()
        if mon is not None:
            reports.append(mon.sample())
        sync(torch, device)
        wall = time.perf_counter() - t0 - plane_s
        outs = [list(f.result(timeout=600)) for f in futs]
    finally:
        if obs is not None:
            obs.stop()
        for e in engines:
            e.stop()
    for i, e in enumerate(engines):
        check(e._block_mgr.conserved(), f"disagg pressure: engine {i}'s pool")
    check_windows(engines, "disagg pressure", device.type == "cuda")
    busy = sum(e.slot_seconds_total for e in engines)
    return {
        "outs": outs, "wall": wall, "mon": mon, "reports": reports, "plane": plane,
        "counters": [tuple(getattr(e, k) for k in (
            "steps_run", "macro_dispatches", "prefill_dispatches", "graph_replays",
            "h2d_uploads", "blocking_syncs", "preemptions")) for e in engines],
        "w_hot": w_hot, "w_starved": w_starved, "starved_agrees": detect["starved_agrees"],
        "chip_accounting": utilization_block([collect_serving(e) for e in engines]),
        "conservation": {"charged_slot_seconds": ledger.charged_slot_seconds(),
                         "busy_slot_seconds": busy},
    }


def pressure_cell(torch, device, small):
    """bench.py's fleet_pressure in bf16 (f32 in a rehearsal): monitor off
    and on in turns, best of two trials (bench.py's default: no overhead
    gate, so no escalation). Gates: outputs and
    engine counters equal off against on; idle -> HOT and within -> STARVED
    each within one sampling window of its injection, the latter agreeing
    with the engine's QuotaPolicy; the journal bounded, every line JSON,
    FleetMonitor.replay equal to the live verdicts; the debug plane's
    answers (debug_plane); slot-seconds conserved."""
    from nos_tpu_torch import constants, init_gpt
    from nos_tpu_torch.ops import paged_attention as pa
    from nos_tpu_torch.serving import FleetMonitor

    p = PRESSURE
    dtype = "float32" if small else "bfloat16"
    cfg = bench_gpt(dtype, small)
    params = init_gpt(cfg, torch.Generator().manual_seed(0), device=device)
    walls_off, walls_on = [], []
    pa.reset_launch_counts()
    on = None

    def pair():
        nonlocal on
        off_run = pressure_run(torch, cfg, params, device, p, False)
        on = pressure_run(torch, cfg, params, device, p, True)
        check(on["outs"] == off_run["outs"], "disagg pressure: outputs differ monitor on/off")
        check(on["counters"] == off_run["counters"],
              f"disagg pressure: counters differ monitor on/off: {off_run['counters']} "
              f"against {on['counters']}")
        walls_off.append(off_run["wall"])
        walls_on.append(on["wall"])

    def overhead():
        return 100.0 * (min(walls_on) / min(walls_off) - 1.0)

    def noise():
        return 100.0 * (max(walls_off) / min(walls_off) - 1.0)

    for _ in range(1 if small else p["trials"]):
        pair()
    sync(torch, device)
    routes = {n: dict(r) for n, r in pa.ROUTE_LAUNCHES.items()}
    launches = dict(pa.LAUNCHES)
    if device.type == "cuda":
        check_routes(routes, "paged_decode_attention", "split", "disagg pressure")
        check_routes(routes, "paged_window_attention", "mma", "disagg pressure")
    mon = on["mon"]

    def first_window(pred):
        return next((r.window for r in on["reports"] if pred(r)), None)

    w_hot = first_window(lambda r: r.replicas.get("replica-0")
                         == constants.PRESSURE_REPLICA_HOT)
    w_starved = first_window(lambda r: r.tenants.get("gold")
                             == constants.PRESSURE_TENANT_STARVED)
    check(w_hot is not None and w_hot <= on["w_hot"] + 1,
          f"disagg pressure: HOT at window {w_hot}, the burst at {on['w_hot']}")
    check(w_starved is not None and w_starved <= on["w_starved"] + 1 and on["starved_agrees"],
          f"disagg pressure: STARVED at window {w_starved}, the arrivals at "
          f"{on['w_starved']}, quota agrees {on['starved_agrees']}")
    journal = mon.journal_lines()
    parsed = [json.loads(line) for line in journal]
    replayed = FleetMonitor.replay(journal)
    live = on["reports"][-len(replayed):]
    check(len(journal) <= mon.journal_windows and replayed
          and all(r["event"] == constants.FLEET_EV_WINDOW for r in parsed)
          and [(r.replicas, r.tenants) for r in replayed]
          == [(r.replicas, r.tenants) for r in live],
          "disagg pressure: the journal is unbounded, unparsable or replays otherwise")
    cons = on["conservation"]
    check(abs(cons["charged_slot_seconds"] - cons["busy_slot_seconds"])
          <= 1e-9 * max(1.0, cons["busy_slot_seconds"]),
          f"disagg pressure: slot-seconds not conserved {cons}")
    return {
        "dtype": dtype, "trials": len(walls_off), "walls_off_s": walls_off,
        "walls_on_s": walls_on, "monitor_overhead_pct": overhead(),
        "wall_noise_pct": noise(), "tok_s_monitor_off": len(on["outs"]) * p["new"]
        / min(walls_off), "tok_s_monitor_on": len(on["outs"]) * p["new"] / min(walls_on),
        "windows_sampled": mon.windows_sampled, "sample_wall_s": mon.sample_wall_s,
        "hot": {"injected_window": on["w_hot"], "detected_window": w_hot},
        "starved": {"injected_window": on["w_starved"], "detected_window": w_starved,
                    "quota_agrees": on["starved_agrees"]},
        "journal_lines": len(journal), "journal_capacity": mon.journal_windows,
        "slo_events": len(mon.slo.events), "debug_plane": on["plane"],
        "chip_accounting": on["chip_accounting"], "conservation": cons,
        "launches": launches, "routes": routes,
        "timeline": [{"window": r.window, "replicas": r.replicas, "tenants": r.tenants,
                      "headroom": r.headroom} for r in on["reports"]],
    }


def disagg_kernels(torch):
    """The two paged kernels at the disagg cells' shapes, bf16 pool: the
    window kernel at DISAGG_WINDOWS (the long prompts' single chunks, 32768
    and 4096 rows from key 0, and a 1024-row chunk whose keys end at
    32768), and the split decode kernel over the decode replica's five
    lanes, one of them at 32784 keys. Each held against its plain version
    (`held`; the window's in row slices) and timed beside it and SDPA on
    the pre-gathered cache, with its bound. `window`, the kernels line's
    entry, is the 32768-row chunk."""
    import torch.nn.functional as F

    from nos_tpu_torch.ops import paged_attention as pa
    from nos_tpu_torch.runtime.mfu import H100_BF16_PEAK_FLOPS

    NH, NKV, HD, BS = 8, 2, 64, 32
    lanes = len(DISAGG_DECODE_LIMITS)
    P = -(-max(DISAGG_DECODE_LIMITS) // BS)
    T = 1 + lanes * P
    gen = torch.Generator(device="cuda").manual_seed(3)
    k, v, _, _, dt = _pools(torch, gen, "bfloat16", T, NKV, BS, HD)
    table = (torch.randperm(T - 1, generator=gen, device="cuda")[: lanes * P] + 1) \
        .reshape(lanes, P).to(torch.int32).contiguous()
    worst = {"paged_decode_attention": 0.0, "paged_decode_attention_rel": 0.0,
             "paged_window_attention": 0.0, "paged_window_attention_rel": 0.0}

    def bound(nbytes, flops):
        b, f = nbytes / H100_BYTES_PER_S, flops / H100_BF16_PEAK_FLOPS
        return 1e3 * max(b, f), "bytes" if b >= f else "operations"

    lim = torch.tensor(DISAGG_DECODE_LIMITS, dtype=torch.int32, device="cuda")
    q = torch.randn((lanes, NH, HD), generator=gen, device="cuda").to(dt)
    held(torch, pa.paged_decode_attention(q, k, v, table, lim),
         pa._reference(q, k, v, table, lim), "bfloat16", "paged_decode_attention 32k", worst)
    kd = pa._gather_pool(k, table, None, dt).repeat_interleave(NH // NKV, dim=1)
    vd = pa._gather_pool(v, table, None, dt).repeat_interleave(NH // NKV, dim=1)
    idx = torch.arange(kd.shape[2], device="cuda")
    mask = (idx[None, :] < lim[:, None])[:, None, None, :]
    nbytes = decode_bytes(DISAGG_DECODE_LIMITS, NH, NKV, HD, BS, 2, 2)
    b_ms, b_by = bound(nbytes, 4.0 * NH * HD * sum(DISAGG_DECODE_LIMITS))
    out = {"decode": {
        "limits": DISAGG_DECODE_LIMITS,
        "ms": time_cuda(torch, lambda: pa.paged_decode_attention(q, k, v, table, lim)),
        "plain_ms": time_cuda(torch, lambda: pa._reference(q, k, v, table, lim)),
        "library_ms": time_cuda(torch, lambda: _sdpa_decode(torch, q[:, :, None, :], kd, vd,
                                                            mask)),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
        "route": "split"}}
    del kd, vd, mask
    out["windows"] = []
    for shape in DISAGG_WINDOWS:
        W, keys = shape["w"], shape["keys"]
        pos0 = keys - W
        qw = torch.randn((1, NH, W, HD), generator=gen, device="cuda").to(dt)
        tab = table[4:5, : keys // BS].contiguous()
        pos = torch.full((1,), pos0, dtype=torch.int32, device="cuda")
        lengths = torch.full((1,), W, dtype=torch.int32, device="cuda")
        active = torch.ones((1,), dtype=torch.bool, device="cuda")
        args = (qw, k, v, tab, pos, lengths, active)
        # The plain version in row slices (window_reference_rows): whole, a
        # 32768-row window's f32 scores alone would be 34 GB.
        err = {"paged_window_attention": 0.0, "paged_window_attention_rel": 0.0}
        held(torch, pa.paged_window_attention(*args), window_reference_rows(*args),
             "bfloat16", f"paged_window_attention W {W} to {keys} keys", err)
        for key, e in err.items():
            worst[key] = max(worst[key], e)
        kd = pa._gather_pool(k, tab, None, dt).repeat_interleave(NH // NKV, dim=1)
        vd = pa._gather_pool(v, tab, None, dt).repeat_interleave(NH // NKV, dim=1)
        rows = pos0 + torch.arange(W, device="cuda") + 1
        # SDPA's own causal mask where the window starts at key 0, else the
        # limits as a mask (the window's rows end at the last keys).
        causal = (None if pos0 == 0 else
                  (torch.arange(keys, device="cuda")[None, :] < rows[:, None])[None, None])
        nbytes = ((keys // BS) * NKV * BS * HD * 2 * 2 + 2 * NH * W * HD * 2
                  + 4 * (keys // BS) + 9)
        flops = 4.0 * NH * HD * float(rows.sum().item())
        b_ms, b_by = bound(nbytes, flops)
        ms = time_cuda(torch, lambda: pa.paged_window_attention(*args))
        big = W > PLAIN_WINDOW_ROWS
        out["windows"].append({
            "w": W, "keys": keys, "ms": ms,
            "plain_ms": time_cuda(torch, lambda: window_reference_rows(*args),
                                  iters=3 if big else 20, warmup=1 if big else 3),
            "plain_rows_per_call": min(W, PLAIN_WINDOW_ROWS),
            "library_ms": time_cuda(torch, lambda: F.scaled_dot_product_attention(
                qw, kd, vd, attn_mask=causal, is_causal=causal is None)),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
            "tflops": flops / ms / 1e9, "route": pa._window_route(qw, k, None),
            "max_abs_err": err["paged_window_attention"]})
        check(out["windows"][-1]["route"] == "mma",
              f"disagg window W {W} route {out['windows'][-1]['route']}")
        del kd, vd, causal, qw
    # The kernels line's entry: the shape the 32k cell's main path launches.
    out["window"] = dict(out["windows"][0])
    out["decode"]["max_abs_err"] = worst["paged_decode_attention"]
    log("disagg kernel_times " + json.dumps(out))
    return out


def phase_disagg(torch, device, small=False):
    """Phase disaggregation, the fleet monitor and the debug plane on the
    card: bench.py's interference_4k_disagg (bf16, then f32; greedy),
    disagg_long_context (bf16; greedy and temperature 0.8) and
    fleet_pressure (bf16) on the bench GPT, random weights from seed 0,
    uncut; the two paged kernels held and timed at the 32k cell's shapes.
    The launch counts are zeroed before each cell's arms and read after
    them. Gates: every future resolves; every pool and the store conserved,
    no pin left; one capture per engine, every window a replay; decode
    launches on "split", bf16 window launches on "mma"; the handoffs all
    made, and every revivable prompt block of a handed-off request not on
    the decode engine's device revived from the store (> 0 in every
    disaggregated arm); every stream against the plain programs' oracle
    (disagg_oracle); streams equal across the arms gated in f32
    (same_streams); the pressure cell's gates (pressure_cell)."""
    t0 = time.perf_counter()
    cuda = device.type == "cuda"
    card = card_line(torch, device)
    stats = {"card": card}
    c4, c32 = (DISAGG_4K_SMALL, DISAGG_32K_SMALL) if small else (DISAGG_4K, DISAGG_32K)
    for dtype in ("float32",) if small else ("bfloat16", "float32"):
        stats[f"4k_{dtype}"] = disagg_cell(torch, device, c4, dtype, (0.0,), small)
    stats["32k_" + ("float32" if small else "bfloat16")] = disagg_cell(
        torch, device, c32, "float32" if small else "bfloat16", (0.0, TEMPERATURE), small)
    t1 = time.perf_counter()
    stats["pressure"] = pressure_cell(torch, device, small)
    stats["pressure_s"] = time.perf_counter() - t1
    if cuda:
        t1 = time.perf_counter()
        stats["kernels_32k"] = disagg_kernels(torch)
        stats["kernels_s"] = time.perf_counter() - t1
    main = [stats[k] for k in ("4k_bfloat16", "32k_bfloat16", "pressure") if k in stats]
    routes = {}
    for st in main:
        for name, counts in st["routes"].items():
            agg = routes.setdefault(name, {})
            for r, n in counts.items():
                agg[r] = agg.get(r, 0) + n
    stats["main"] = {"routes": routes}
    for key, st in stats.items():
        if not key.startswith(("4k", "32k")):
            continue
        summary = {"card": card, "launches_by_route": {n: st["routes"][n] for n in (
            "paged_decode_attention", "paged_window_attention")}}
        for tkey in ("greedy", f"temp_{TEMPERATURE}"):
            if tkey not in st:
                continue
            arm = st[tkey]
            summary[tkey] = {
                "decode_interference_ratio": arm["decode_interference_ratio"],
                "outputs_identical": arm["outputs_identical"],
                "same_streams": arm["same_streams"],
                **{a: {k: arm[a].get(k) for k in (
                    "decode_tok_s_during_prefill", "prefill_window_s", "ttft_long_s",
                    "long_latency_s", "peak_mem_bytes", "mem_at_start_bytes", "handoffs",
                    "handoff_reroutes", "handoffs_errored",
                    "handoff_latency_p50_s", "handoff_latency_p95_s", "export_s",
                    "export_capture_s", "export_publish_s",
                    "export_share_of_handoff", "handoff_exports", "handoff_ingests",
                    "handoff_published_blocks", "write_through_published_blocks",
                    "handoff_revived_tokens", "store_entries", "store_bytes",
                    "chip_accounting", "tokens") if k in arm[a]}
                   for a in ("colocated", "disaggregated")}}
        log(f"disagg {key}: " + json.dumps(summary))
    pr = stats["pressure"]
    log("disagg pressure: " + json.dumps({k: v for k, v in pr.items()
                                          if k not in ("routes", "timeline")} | {
        "card": card}))
    stats["phase_s"] = time.perf_counter() - t0
    parts = {k: {p: st[p] for p in ("arms_s", "oracle_s")} for k, st in stats.items()
             if k.startswith(("4k", "32k"))}
    log(f"disagg phase_s={stats['phase_s']:.1f} ({card}) parts_s=" + json.dumps(
        parts | {"pressure": stats["pressure_s"], "kernels": stats.get("kernels_s")}))
    return stats


# -- phase: dense ------------------------------------------------------------------
def sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed_prefill(torch, device, marks):
    """Record, inside one generate call, the dense prefill's wall time and
    the moment the decode loop starts (host clock around synchronised
    work; the package has no such hook)."""
    from nos_tpu_torch.models import decode as D

    real = D.prefill

    def prefill(*args, **kw):
        sync(torch, device)
        t0 = time.perf_counter()
        out = real(*args, **kw)
        sync(torch, device)
        marks["prefill_s"] = time.perf_counter() - t0
        marks["loop_t0"] = time.perf_counter()
        return out

    D.prefill = prefill
    try:
        yield
    finally:
        D.prefill = real


def dense_teacher_forced(torch, params, cfg, prompt, tokens, max_len):
    """Logits of a teacher-forced pass of the dense programs over prompt +
    tokens: prefill, then decode_step fed the given tokens. Returns [B,
    steps, vocab] f32; row t predicts token t."""
    from nos_tpu_torch.models import decode as D

    b, t = prompt.shape
    steps = tokens.shape[1]
    logits = torch.empty((b, steps, cfg.vocab), dtype=torch.float32, device=prompt.device)
    lg, cache = D.prefill(params, prompt, cfg, max_len)
    logits[:, 0] = lg
    for i in range(1, steps):
        lg, cache = D.decode_step(params, tokens[:, i - 1].contiguous(), cfg, cache, t + i - 1)
        logits[:, i] = lg
    return logits


def dense_greedy(torch, device, dtype, small):
    """The main path: one greedy generate call over the prompts, with the
    decode_attention count zeroed just before it and read just after (every
    decode step of every layer launches the kernel once: layers x (steps -
    1)); then the teacher-forced oracle of both arms over its tokens.
    Returns (stats, (cfg, params, prompt))."""
    from nos_tpu_torch import generate, init_gpt
    from nos_tpu_torch.ops import decode_attention as da

    z = DENSE_SMALL if small else DENSE
    cfg = bench_gpt(dtype, small)
    params = init_gpt(cfg, torch.Generator().manual_seed(0), device=device)
    rng = np.random.default_rng(1)
    prompt = torch.tensor(rng.integers(1, cfg.vocab, (z["batch"], z["prompt"])),
                          dtype=torch.int32, device=device)
    cuda = device.type == "cuda"
    generate(params, prompt[:, :8], cfg, steps=4, max_len=64)  # warm-up, not counted
    sync(torch, device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    marks = {}
    da.reset_launch_counts()
    t0 = time.perf_counter()
    with timed_prefill(torch, device, marks):
        tokens = generate(params, prompt, cfg, steps=z["steps"], max_len=z["max_len"])
    sync(torch, device)
    end = time.perf_counter()
    launches = dict(da.LAUNCHES)
    routes = {n: dict(r) for n, r in da.ROUTE_LAUNCHES.items()}
    loop_s = end - marks["loop_t0"]
    stats = {
        "dtype": dtype,
        "batch": z["batch"], "prompt": z["prompt"], "steps": z["steps"],
        "max_len": z["max_len"],
        "generate_s": end - t0,
        "prefill_ms": 1e3 * marks["prefill_s"],
        "decode_loop_s": loop_s,
        "decode_tok_per_s": z["batch"] * (z["steps"] - 1) / loop_s,
        "launches": launches,
        "routes": routes,
        "peak_mem_bytes": torch.cuda.max_memory_allocated() if cuda else None,
    }
    check(tuple(tokens.shape) == (z["batch"], z["steps"]) and tokens.dtype == torch.int32
          and int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab,
          f"dense {dtype}: generate returned {tuple(tokens.shape)} {tokens.dtype}")
    if cuda:
        want = cfg.layers * (z["steps"] - 1)
        check(launches["decode_attention"] == want,
              f"dense {dtype}: {launches['decode_attention']} decode_attention launches, "
              f"want {want}")
        check_routes(routes, "decode_attention", "split", f"dense {dtype}")
    kern = dense_teacher_forced(torch, params, cfg, prompt, tokens, z["max_len"])
    with plain_attention():
        plain = dense_teacher_forced(torch, params, cfg, prompt, tokens, z["max_len"])
    stats.update(agreement(torch, kern, plain, tokens, dtype))
    return stats, (cfg, params, prompt)


def dense_ragged(torch, device, dtype, small, steps=16):
    """decode_step_ragged over a dense cache filled from a numpy seed, at
    per-row positions MAIN_DECODE_LIMITS - 1: the kernel arm's logits
    against the plain arm's, step by step from the same cache."""
    from nos_tpu_torch import init_gpt
    from nos_tpu_torch.models import decode as D
    from nos_tpu_torch.ops import decode_attention as da

    cfg = bench_gpt(dtype, small)
    params = init_gpt(cfg, torch.Generator().manual_seed(0), device=device)
    if small:
        pos0, max_len, steps = [3, 9, 20, 40], 64, 4
    else:
        pos0, max_len = [x - 1 for x in MAIN_DECODE_LIMITS], DENSE["max_len"]
    b = len(pos0)
    rng = np.random.default_rng(2)
    shape = (b, cfg.n_kv, max_len, cfg.head_dim)
    cache = {str(i): {n: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                      .to(device=device, dtype=cfg.torch_dtype) for n in ("k", "v")}
             for i in range(cfg.layers)}
    plain_cache = {l: {n: t.clone() for n, t in lc.items()} for l, lc in cache.items()}
    toks = torch.tensor(rng.integers(1, cfg.vocab, (steps, b)), dtype=torch.int32,
                        device=device)
    pos = torch.tensor(pos0, dtype=torch.int32, device=device)
    kern, plain = [], []
    da.reset_launch_counts()
    for s in range(steps):
        kern.append(D.decode_step_ragged(params, toks[s], cfg, cache, pos + s)[0])
    launches = da.LAUNCHES["decode_attention"]
    with plain_attention():
        for s in range(steps):
            plain.append(D.decode_step_ragged(params, toks[s], cfg, plain_cache, pos + s)[0])
    kern, plain = torch.stack(kern, dim=1), torch.stack(plain, dim=1)
    stats = {"dtype": dtype, "positions": pos0, "steps": steps, "launches": launches}
    stats.update(agreement(torch, kern, plain, greedy(torch, kern), dtype))
    if device.type == "cuda":
        check(launches == cfg.layers * steps,
              f"dense ragged: {launches} launches, want {cfg.layers * steps}")
    return stats


def dense_sampled(torch, device, small, cfg, params, prompt):
    """generate(temperature=0.8, rng=PRNGKey(0)): token t must equal
    categorical(split(PRNGKey(0), steps)[t], plain_logits_t / 0.8) over the
    teacher-forced plain logits. On the card the PRNG's keys, bits and
    uniforms must equal its CPU results for the same keys, exactly."""
    from nos_tpu_torch import generate, prng

    z = DENSE_SMALL if small else DENSE
    steps = z["sampled_steps"]
    key = prng.PRNGKey(0, device=device)
    t0 = time.perf_counter()
    tokens = generate(params, prompt, cfg, steps=steps, temperature=TEMPERATURE, rng=key,
                      max_len=z["max_len"])
    sync(torch, device)
    wall = time.perf_counter() - t0
    with plain_attention():
        plain = dense_teacher_forced(torch, params, cfg, prompt, tokens, z["max_len"])
    keys = prng.split(key, steps)
    want = torch.stack([prng.categorical(keys[t], plain[:, t] / TEMPERATURE)
                        for t in range(steps)], dim=1).to(torch.int32)
    stats = {"steps": steps, "generate_s": wall,
             "token_match": (want == tokens).float().mean().item(),
             "greedy_share": (greedy(torch, plain) == tokens).float().mean().item()}
    check(stats["token_match"] == 1.0,
          f"dense sampled: {stats['token_match']} of the tokens match the plain-logit draw")
    if device.type == "cuda":
        cpu_keys = prng.split(prng.PRNGKey(0), steps)
        lanes = torch.arange(1, 9)
        engine_keys = prng.fold_in(prng.fold_in(prng.PRNGKey(7), lanes), lanes + 65536)
        same = {
            "split": torch.equal(keys.cpu(), cpu_keys),
            "fold_in": torch.equal(prng.fold_in(prng.fold_in(
                prng.PRNGKey(7, device=device), lanes.to(device)), lanes.to(device) + 65536)
                .cpu(), engine_keys),
            "bits": torch.equal(prng.random_bits(keys[:8], (cfg.vocab,)).cpu(),
                                prng.random_bits(cpu_keys[:8], (cfg.vocab,))),
            "uniform": torch.equal(
                prng.uniform(keys[:8], (cfg.vocab,)).cpu().view(torch.int32),
                prng.uniform(cpu_keys[:8], (cfg.vocab,)).view(torch.int32)),
        }
        check(all(same.values()), f"the PRNG on the card differs from the CPU: {same}")
        stats["prng_card_equals_cpu"] = same
        stats["sampler_ms_per_step"] = time_cuda(
            torch, lambda: prng.categorical(keys[1], plain[:, 1] / TEMPERATURE))
    return stats


def engine_sampled(torch, device, small, cfg, params):
    """DecodeServer(temperature=0.8, seed=7): four streams submitted before
    start() (serials 1-4); each served token t of stream i must equal
    categorical(fold_in(fold_in(PRNGKey(7), i + 1), t), logits / 0.8) over
    the teacher-forced plain logits."""
    from nos_tpu_torch import DecodeServer, prng

    buckets, max_len = engine_sizes(small)
    lens, max_new = ([5, 9, 12, 20], 8) if small else ([64, 128, 192, 256], 64)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in lens]
    server = DecodeServer(params, cfg, n_slots=4, max_len=max_len, prompt_buckets=buckets,
                          steps_per_dispatch=16, temperature=TEMPERATURE, seed=7,
                          device=device)
    t0 = time.perf_counter()
    futs = [server.submit(p, max_new) for p in prompts]
    server.start()
    try:
        outs = [f.result(timeout=600) for f in futs]
    finally:
        server.stop()
    wall = time.perf_counter() - t0
    with plain_attention():
        plain = teacher_forced(torch, params, cfg, prompts, outs, buckets, 32, device)
    serials = torch.arange(1, len(prompts) + 1, device=device)[:, None].expand(-1, max_new)
    keys = prng.fold_in(prng.fold_in(prng.PRNGKey(7, device=device), serials),
                        torch.arange(max_new, device=device))
    want = prng.categorical(keys, plain / TEMPERATURE)
    served = torch.tensor(outs, device=device)
    stats = {"streams": len(prompts), "max_new": max_new, "wall_s": wall,
             "token_match": (want == served).float().mean().item(),
             "graph_captures": server.graph_captures,
             **{c: getattr(server, c) for c in BUDGET_COUNTERS}}
    check(stats["token_match"] == 1.0,
          f"engine sampled: {stats['token_match']} of the tokens match the plain-logit draw")
    if device.type == "cuda":
        check_replays(stats, "engine sampled", bursts=False)
    return stats


def profile_dense_step(torch, cfg, params, steps=16):
    """16 lockstep decode_step calls of the dense program at the dense
    phase's batch, from position DENSE["prompt"] on a max_len cache."""
    from nos_tpu_torch.models import decode as D

    cache = D.init_cache(cfg, DENSE["batch"], DENSE["max_len"], device="cuda")
    token = torch.ones((DENSE["batch"],), dtype=torch.int32, device="cuda")

    def run():
        for k in range(steps):
            D.decode_step(params, token, cfg, cache, DENSE["prompt"] + k)

    return profile_steps(torch, run, steps, "split_decode_kernel")


def phase_dense(torch, device, small=False):
    """The dense programs at the bench GPT's full width: greedy generate in
    bf16 and f32 (the bf16 call is the main path), ragged decode, sampled
    generate and the sampled engine (f32), and a profiled window."""
    t0 = time.perf_counter()
    stats, models = {}, {}
    for dtype in ("float32",) if small else ("bfloat16", "float32"):
        stats[dtype], models[dtype] = dense_greedy(torch, device, dtype, small)
        log(f"dense greedy {dtype}: " + json.dumps(stats[dtype]))
        check_logits(stats[dtype], "dense greedy")
    ragged_dtype = "float32" if small else "bfloat16"
    stats["ragged"] = dense_ragged(torch, device, ragged_dtype, small)
    log("dense ragged: " + json.dumps(stats["ragged"]))
    check_logits(stats["ragged"], "dense ragged")
    stats["sampled"] = dense_sampled(torch, device, small, *models["float32"])
    log("dense sampled: " + json.dumps(stats["sampled"]))
    stats["engine_sampled"] = engine_sampled(torch, device, small, *models["float32"][:2])
    log("dense engine sampled: " + json.dumps(stats["engine_sampled"]))
    main = stats["float32" if small else "bfloat16"]
    summary = {k: main[k] for k in ("dtype", "prefill_ms", "decode_loop_s", "decode_tok_per_s",
                                    "peak_mem_bytes", "launches")}
    if device.type == "cuda":
        stats["step_profile"] = profile_dense_step(torch, *models["bfloat16"][:2])
        summary["step_profile"] = stats["step_profile"]
        summary["sampler_ms_per_step"] = stats["sampled"]["sampler_ms_per_step"]
    summary["phase_s"] = stats["phase_s"] = time.perf_counter() - t0
    log("dense: " + json.dumps(summary))
    return stats


# -- phase: train ------------------------------------------------------------------
@contextlib.contextmanager
def plain_flash():
    """Route the model's attention through the reference's XLA-path
    formula, `_reference_attention`, with autograd (the plain arm; the
    package itself has no such switch)."""
    from nos_tpu_torch.models import gpt
    from nos_tpu_torch.ops import flash_attention as fa

    def plain(q, k, v, causal=False, scale=None):
        return fa._reference_attention(q, k, v, causal,
                                       q.shape[-1] ** -0.5 if scale is None else scale)

    saved = gpt.flash_attention
    gpt.flash_attention = plain
    try:
        yield
    finally:
        gpt.flash_attention = saved


def train_model(full, layers, dtype):
    """The training model of runtime/mfu.py::gpt_train_mfu (hidden 2048,
    vocab 32000, 8 heads of 256, MHA, batch 8 x 2048) at `layers`, or the
    CPU tests' tiny GQA model for a rehearsal. -> (GPTConfig, (batch, seq))."""
    from nos_tpu_torch import GPTConfig

    if full:
        return GPTConfig(hidden=2048, layers=layers, dtype=dtype), (8, 2048)
    return (GPTConfig(vocab=256, hidden=64, layers=layers, heads=4, kv_heads=2, max_seq=64,
                      dtype=dtype), (2, 48))


def train_timed(torch, device, full, warmup=2, steps=6):
    """The main path: init_train_state, batches through prefetch_to_device,
    `warmup` steps, then `steps` timed steps with the flash launch counts
    zeroed just before them and read just after."""
    from nos_tpu_torch import (TrainConfig, init_train_state, make_train_step,
                               prefetch_to_device, synthetic_token_stream)
    from nos_tpu_torch.ops import flash_attention as fa
    from nos_tpu_torch.runtime.mfu import H100_BF16_PEAK_FLOPS, gpt_train_flops

    model, (batch, seq) = train_model(full, 8 if full else 3, "bfloat16")
    cfg = TrainConfig(model=model)
    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    params, opt = init_train_state(cfg, torch.Generator().manual_seed(0), device=device)
    step = make_train_step(cfg)
    batches = prefetch_to_device(
        synthetic_token_stream(model.vocab, batch, seq, seed=0, steps=warmup + steps + 1),
        device=device)
    losses = []
    for _ in range(warmup):
        params, opt, metrics = step(params, opt, next(batches))
        losses.append(metrics["loss"])
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
    setup_s = time.perf_counter() - t0
    fa.reset_launch_counts()
    t1 = time.perf_counter()
    if cuda:
        start.record()
    for _ in range(steps):
        params, opt, metrics = step(params, opt, next(batches))
        losses.append(metrics["loss"])
    if cuda:
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / steps
    else:
        ms = 1e3 * (time.perf_counter() - t1) / steps
    launches = dict(fa.LAUNCHES)
    routes = {n: dict(r) for n, r in fa.ROUTE_LAUNCHES.items()}
    losses = [x.item() for x in losses]
    check(all(np.isfinite(losses)), f"train: non-finite loss {losses}")
    flops = gpt_train_flops(model, batch, seq)
    stats = {
        "config": {"hidden": model.hidden, "layers": model.layers, "heads": model.heads,
                   "head_dim": model.head_dim, "vocab": model.vocab, "dtype": model.dtype,
                   "batch": batch, "seq": seq},
        "ms_per_step": ms,
        "tokens_per_s": batch * seq / (ms / 1e3),
        "flops_per_step": flops,
        "losses": losses,
        "launches": launches,
        "routes": routes,
        "setup_and_warmup_s": setup_s,
    }
    if cuda:
        want = {n: model.layers * steps for n in FLASH_KERNELS}
        check(launches == want, f"train: flash launches {launches}, want {want}")
        for name in FLASH_KERNELS:
            check_routes(routes, name, "mma", "train")
        stats["mfu"] = flops / (ms / 1e3 * H100_BF16_PEAK_FLOPS)
        stats["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        stats["step_profile"] = profile_train_step(torch, step, params, opt, next(batches))
    stats["gpt_train_mfu"] = train_mfu(torch, device, cfg, params, opt, batch, seq,
                                       stats.get("mfu"))
    return stats


# measure_mfu's loop for the ~233 ms train step: 8 calls against 2, three
# repeats (its time budget allows one doubling at most).
TRAIN_MFU_LOOP = {"scan_length": 8, "repeats": 3}
# measure_mfu's step time against the events' ms_per_step: the same step,
# timed by loop differencing (one more step) against six steps in a row.
TRAIN_MFU_AGREE = 0.15


def train_mfu(torch, device, cfg, params, opt, batch, seq, events_mfu):
    """runtime/mfu.py::gpt_train_mfu over the phase's own model and
    state (the step updates them in place, so every timed call runs the
    whole step: forward, backward, AdamW), counted by gpt_train_flops. On
    the card: not None, its mfu inside its own mfu_range and within
    TRAIN_MFU_AGREE of the events' MFU; off the card it must decline
    (None) rather than time the CPU."""
    from nos_tpu_torch.runtime.mfu import gpt_train_mfu

    t0 = time.perf_counter()
    out = gpt_train_mfu(batch, seq, cfg=cfg, state=(params, opt), device=device,
                        generator=torch.Generator().manual_seed(1), **TRAIN_MFU_LOOP)
    if device.type != "cuda":
        check(out is None, f"train: gpt_train_mfu on {device} gave {out}")
        return None
    check(out is not None, "train: gpt_train_mfu gave None on the card")
    lo, hi = out["mfu_range"]
    check(lo <= out["mfu"] <= hi, f"train: mfu {out['mfu']} outside its range {out['mfu_range']}")
    check(abs(out["mfu"] / events_mfu - 1.0) <= TRAIN_MFU_AGREE,
          f"train: measure_mfu's mfu {out['mfu']} against the events' {events_mfu}")
    out["events_mfu"] = events_mfu
    out["seconds"] = time.perf_counter() - t0
    return out


def profile_train_step(torch, step, params, opt, tokens):
    """One train step under torch.profiler: host wall, device kernel time
    (sum of CUDA kernel intervals; one stream), the busy share, the flash
    kernels' time and share of the device time, the matrix products' time
    (cuBLAS kernels: names with nvjet, gemm, xmma or cutlass) and the eight
    kernels that took longest in sum."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt, tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_kernels, dev_us, attn_us, gemm_us = 0, 0.0, 0.0, 0.0
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n_kernels += 1
            us = e.time_range.elapsed_us()
            dev_us += us
            by_name[e.name] = by_name.get(e.name, 0.0) + us
            if "flash_" in e.name:
                attn_us += us
            elif any(w in e.name.lower() for w in ("nvjet", "gemm", "xmma", "cutlass")):
                gemm_us += us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "wall_ms": 1e3 * wall,
        "device_ms": dev_us / 1e3,
        "device_busy_share": (dev_us / 1e6) / wall if wall else None,
        "kernels": n_kernels,
        "flash_ms": attn_us / 1e3,
        "flash_share_of_device": attn_us / dev_us if dev_us else None,
        "matmul_ms": gemm_us / 1e3,
        "top_kernels_ms": {name[:80]: us / 1e3 for name, us in top},
    }


def train_vs_plain(torch, device, full, dtype, steps=3):
    """The 2-layer model, `steps` steps through the kernels and the same
    through _reference_attention, from the same params and batches: the
    per-step loss, every gradient leaf of the first batch (max|err| /
    max|want|), and the params after the last step: max|err|, and the
    difference of the two arms' updates (params minus initial params) over
    the plain arm's, as norms over every leaf. Adam's m / sqrt(v) turns
    noise on near-zero gradient entries into updates of up to lr either
    way, which max|err| sees and the norm weighs by its share."""
    from nos_tpu_torch import TrainConfig, gpt_loss, init_train_state, make_train_step
    from nos_tpu_torch import synthetic_token_stream
    from nos_tpu_torch.models.train import named_leaves

    model, (batch, seq) = train_model(full, 2, dtype)
    cfg = TrainConfig(model=model)
    batches = list(synthetic_token_stream(model.vocab, batch, seq, seed=1, steps=steps))

    def run(plain):
        params, opt = init_train_state(cfg, torch.Generator().manual_seed(0), device=device)
        step = make_train_step(cfg)
        tokens = [torch.from_numpy(b).to(device) for b in batches]
        with plain_flash() if plain else contextlib.nullcontext():
            gpt_loss(params, tokens[0], model, loss_chunk=cfg.loss_chunk).backward()
            grads = {n: p.grad.detach().clone() for n, p in named_leaves(params)}
            opt.zero_grad(set_to_none=True)
            losses = []
            for tk in tokens:
                params, opt, metrics = step(params, opt, tk)
                losses.append(metrics["loss"].item())
        return losses, grads, {n: p.detach().clone() for n, p in named_leaves(params)}

    k_loss, k_grad, k_par = run(False)
    p_loss, p_grad, p_par = run(True)
    start, _ = init_train_state(cfg, torch.Generator().manual_seed(0), device=device)
    start = dict(named_leaves(start))
    diff_sq = sum(((k_par[n].double() - p_par[n].double()) ** 2).sum().item() for n in p_par)
    upd_sq = sum(((p_par[n].double() - start[n].double()) ** 2).sum().item() for n in p_par)
    out = {
        "update_rel": (diff_sq / upd_sq) ** 0.5 if upd_sq else float("inf"),
        "losses_kernel": k_loss, "losses_plain": p_loss,
        "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(k_loss, p_loss)),
        "grad_rel": max((k_grad[n].float() - p_grad[n].float()).abs().max().item()
                        / max(p_grad[n].float().abs().max().item(), 1e-30) for n in p_grad),
        "param_abs": max((k_par[n].float() - p_par[n].float()).abs().max().item()
                         for n in p_par),
    }
    out["grad_rel_by_leaf"] = {
        n: (k_grad[n].float() - p_grad[n].float()).abs().max().item()
        / max(p_grad[n].float().abs().max().item(), 1e-30) for n in p_grad}
    tol = TRAIN_TOL[dtype]
    check(all(np.isfinite(k_loss + p_loss)), f"train plain {dtype}: non-finite loss")
    check(out["loss_rel"] <= tol["loss"] and out["grad_rel"] <= tol["grad"]
          and out["param_abs"] <= tol["param"] and out["update_rel"] <= tol["update"],
          f"train plain {dtype}: loss {out['loss_rel']}, grad {out['grad_rel']}, "
          f"param {out['param_abs']}, update {out['update_rel']} against {tol}")
    return out


def train_learns(torch, device, full, steps=20):
    """The 2-layer bf16 model, `steps` steps on one repeated batch."""
    from nos_tpu_torch import TrainConfig, init_train_state, make_train_step
    from nos_tpu_torch import synthetic_token_stream

    model, (batch, seq) = train_model(full, 2, "bfloat16")
    cfg = TrainConfig(model=model)
    params, opt = init_train_state(cfg, torch.Generator().manual_seed(0), device=device)
    step = make_train_step(cfg)
    tokens = torch.from_numpy(next(synthetic_token_stream(model.vocab, batch, seq, seed=2)))
    tokens = tokens.to(device)
    losses = []
    for _ in range(steps):
        params, opt, metrics = step(params, opt, tokens)
        losses.append(metrics["loss"])
    losses = [x.item() for x in losses]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"train learning: losses {losses}")
    return {"losses": losses}


def flash_speedup(torch, device):
    """runtime/mfu.py::flash_train_shape_speedup once: the flash pair
    against the plain materializing attention at [8, 8, 2048, 64] bf16
    causal. An `invalid` marker is reported as such; a published result
    must lie at or above the analytic floor. None off the card."""
    from nos_tpu_torch.runtime.mfu import flash_train_shape_speedup

    t0 = time.perf_counter()
    out = flash_train_shape_speedup(device=device)
    if device.type != "cuda":
        check(out is None, f"train: flash_train_shape_speedup on {device} gave {out}")
        return None
    check(out is not None, "train: flash_train_shape_speedup gave None on the card")
    if "invalid" not in out:
        check(out["flash_ms"] >= out["floor_ms"],
              f"train: flash pair {out['flash_ms']} ms under its floor {out['floor_ms']} ms")
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_train(torch, device, full=True):
    t0 = time.perf_counter()
    stats = {"timed": train_timed(torch, device, full)}
    log("train timed: " + json.dumps(stats["timed"]))
    log("train gpt_train_mfu: " + json.dumps(stats["timed"]["gpt_train_mfu"]))
    stats["flash_speedup"] = flash_speedup(torch, device)
    log("train flash_train_shape_speedup: " + json.dumps(stats["flash_speedup"]))
    # The bf16 bounds are pinned for the full width on the card; a
    # rehearsal's tiny model holds only the f32 ones.
    dtypes = ("float32", "bfloat16") if full else ("float32",)
    stats["plain"] = {dt: train_vs_plain(torch, device, full, dt) for dt in dtypes}
    log("train plain: " + json.dumps(stats["plain"]))
    stats["learning"] = train_learns(torch, device, full)
    log(f"train learning: {json.dumps(stats['learning'])} "
        f"phase_s={time.perf_counter() - t0:.1f}")
    return stats


# -- phase: vit ------------------------------------------------------------------
# bench.py's headline cell (:66-122): seven closed-loop clients, each sending
# its own image, behind one SliceServer (max_batch 7, max_wait_s 0.003,
# buckets 1/2/4/7): 3 warm-up and 30 measured requests each, 3 trials.
VIT = {"clients": 7, "warmup": 3, "requests": 30, "trials": 3, "max_wait_s": 0.003,
       "buckets": (1, 2, 4, 7), "f32_requests": 10, "flash_requests": 2}
VIT_SMALL = dict(VIT, warmup=1, requests=3, trials=1, f32_requests=2, flash_requests=1)
# A served result against the same image run alone (bucket 1) on the card:
# labels equal wherever the top-2 class gap exceeds one step of the dtype
# (vit_agreement), scores and boxes within VIT_TOL[dtype] (max|err|). First
# set at 1e-2 (bf16) and 1e-4 (f32). Measured on an NVIDIA H100 80GB HBM3
# at 700 W (PERF.md): bf16 0 and 0 (the batched and the lone runs
# agree bit for bit there), f32 1.7e-7 and 6.9e-7. f32 is pinned at about
# 2.5x its measurement; bf16, measured 0, at 2e-3: about one bf16 step of a
# logit carried through the softmax (a score of ~0.05 times 2^-7 of a logit
# of ~4) and the sigmoid (a quarter of 2^-7), so that a card whose kernels
# round a row by batch size fails only on more than one rounding.
VIT_TOL = {"bfloat16": {"score": 2e-3, "box": 2e-3},
           "float32": {"score": 4.5e-7, "box": 1.8e-6}}
# The flash arm's vit_forward through the kernel against the same with the
# kernel's plain version (bf16, 12 layers at T 1124): max|dlogit| and
# max|dbox|. First set at 0.25 and 0.05; pinned at about 2.5x the first
# measurement (NVIDIA H100 80GB HBM3, 700 W; PERF.md): 0.0342 and 0.0064.
VIT_FLASH_TOL = {"logit": 0.085, "box": 0.016}
VIT_FLASH_SHAPE = (7, 6, 1124, 64)  # batch 7, 6 heads, 1024 + 100 tokens, head_dim 64


def vit_model(dtype, small, image_size=224):
    """YOLOS-small (ViTConfig(): 224 px, patch 16, hidden 384, 12 layers, 6
    heads, 100 detection tokens, 92 classes) at `image_size`, or a one-layer
    32-wide model for a rehearsal (32 px, or 512 px to reach the flash
    route)."""
    from nos_tpu_torch import ViTConfig

    if small:
        return ViTConfig(image_size=32 if image_size == 224 else image_size, hidden=32,
                         layers=1, heads=2, dtype=dtype)
    return ViTConfig(image_size=image_size, dtype=dtype)


def vit_images(torch, cfg, n, device):
    """Client i's image: uniform [0, 1) from CPU generator seed i."""
    return [torch.rand((cfg.image_size, cfg.image_size, 3),
                       generator=torch.Generator().manual_seed(i)).to(device) for i in range(n)]


def vit_serve(torch, cfg, params, images, v, warmup, requests, trials, counted=None):
    """bench.py::_build_server and _run_trial on the port: warm every bucket,
    start, then `trials` trials of len(images) closed-loop client threads
    (`warmup` unmeasured and `requests` measured requests each). With
    `counted` (a flash_attention module), its launch counts are zeroed
    just before the traffic and read just after. -> (stats, results[i]:
    client i's measured outputs on the host)."""
    import threading

    from nos_tpu_torch import SliceServer, vit_detect

    n = len(images)
    server = SliceServer(lambda im: vit_detect(params, im, cfg), max_batch=n,
                         max_wait_s=v["max_wait_s"], buckets=v["buckets"])
    server.warmup(images[0])
    results = [[] for _ in range(n)]
    means, per_trial = [], []
    if counted is not None:
        counted.reset_launch_counts()
    server.start()
    try:
        for _ in range(trials):
            latencies = [[] for _ in range(n)]
            errors = []

            def workload(i):
                try:
                    for _ in range(warmup):
                        server.infer(images[i], timeout=120)
                    for _ in range(requests):
                        t0 = time.perf_counter()
                        out = server.infer(images[i], timeout=120)
                        latencies[i].append(time.perf_counter() - t0)
                        results[i].append(out)
                except Exception as e:  # noqa: BLE001 — raised by the check below
                    errors.append(e)

            threads = [threading.Thread(target=workload, args=(i,)) for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            check(not any(t.is_alive() for t in threads), "vit: a client thread hung")
            check(not errors, f"vit: a client failed: {errors[:1]!r}")
            lat = [x for per in latencies for x in per]
            means.append(float(np.mean(lat)))
            per_trial.append(lat)
    finally:
        server.stop()
    launches = routes = None
    if counted is not None:
        launches = dict(counted.LAUNCHES)
        routes = {k: dict(r) for k, r in counted.ROUTE_LAUNCHES.items()}
    median = int(np.argsort(means)[len(means) // 2])
    lat = per_trial[median]
    stats = {
        "trial_mean_s": means,
        "mean_s": means[median],
        "p50_s": float(np.percentile(lat, 50)),
        "p95_s": float(np.percentile(lat, 95)),
        "batches_run": server.batches_run,
        "requests_served": server.requests_served,
        "requests_per_batch": server.requests_served / max(server.batches_run, 1),
        "retries": server.retries,
        "fetch_retries": server.fetch_retries,
        "launches": launches,
        "routes": routes,
    }
    check(server.requests_served == n * (warmup + requests) * trials,
          f"vit: served {server.requests_served} requests")
    return stats, results


def vit_alone(torch, cfg, params, images):
    """Each image run alone (a batch of one) on the device: (labels,
    scores, boxes, logits) on the host."""
    from nos_tpu_torch.models.vit import vit_detect, vit_forward

    out = []
    for im in images:
        logits, _ = vit_forward(params, im[None], cfg)
        labels, scores, boxes = vit_detect(params, im[None], cfg)
        out.append((labels[0].cpu(), scores[0].cpu(), boxes[0].cpu(), logits[0].cpu()))
    return out


def label_gap_mask(torch, logits, dtype):
    """Where a label is decided by more than one step of `dtype`: the top
    object-class logit exceeds the second by more than the dtype's spacing
    at the top logit's magnitude."""
    top = logits[..., :-1].float().topk(2, dim=-1).values
    tiny = torch.finfo(torch.float32).tiny
    step = torch.finfo(getattr(torch, dtype)).eps * torch.exp2(
        torch.floor(torch.log2(top[..., 0].abs().clamp_min(tiny))))
    return (top[..., 0] - top[..., 1]) > step


def vit_agreement(torch, served, alone, dtype, tol, what):
    """Every served result against its image alone: labels equal where the
    top-2 gap exceeds one step (label_gap_mask), scores and boxes within
    `tol`."""
    out = {"positions": 0, "gated": 0, "label_mismatches": 0, "gated_mismatches": 0,
           "max_score_err": 0.0, "max_box_err": 0.0}
    for outs, (labels_1, scores_1, boxes_1, logits_1) in zip(served, alone):
        strict = label_gap_mask(torch, logits_1, dtype)
        for labels, scores, boxes in outs:
            differ = labels != labels_1
            out["positions"] += labels.numel()
            out["gated"] += int(strict.sum())
            out["label_mismatches"] += int(differ.sum())
            out["gated_mismatches"] += int((differ & strict).sum())
            out["max_score_err"] = max(out["max_score_err"],
                                       (scores - scores_1).abs().max().item())
            out["max_box_err"] = max(out["max_box_err"], (boxes - boxes_1).abs().max().item())
    check(out["positions"] > 0 and out["gated_mismatches"] == 0
          and out["max_score_err"] <= tol["score"] and out["max_box_err"] <= tol["box"],
          f"{what}: served against alone {json.dumps(out)}, bounds {tol}")
    return out


@contextlib.contextmanager
def plain_vit_flash():
    """Route the ViT's flash calls through the kernel's plain version,
    `_flash_fwd_reference` (the plain arm; the package has no such
    switch)."""
    from nos_tpu_torch.models import vit
    from nos_tpu_torch.ops import flash_attention as fa

    def plain(q, k, v, causal=False, scale=None):
        return fa._flash_fwd_reference(q, k, v, causal, q.shape[-1] ** -0.5)[0]

    saved = vit.flash_attention
    vit.flash_attention = plain
    try:
        yield
    finally:
        vit.flash_attention = saved


def vit_flash_kernel(torch):
    """The flash forward at the ViT flash arm's shape, [7, 6, 1124, 64] bf16
    non-causal (T not a tile multiple): o and lse against the plain version
    by flash_err within FLASH_TOL, then its time against the plain version
    and scaled_dot_product_attention, with its bound (flash_work)."""
    import torch.nn.functional as F

    from nos_tpu_torch.ops import flash_attention as fa
    from nos_tpu_torch.runtime.mfu import H100_BF16_PEAK_FLOPS

    b, h, t, d = VIT_FLASH_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((b, h, t, d), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    scale = d ** -0.5
    before = fa.ROUTE_LAUNCHES["flash_fwd"]["mma"]
    o, lse = fa.flash_fwd(q, k, v, False, scale)
    check(fa.ROUTE_LAUNCHES["flash_fwd"]["mma"] == before + 1,
          "vit flash kernel: the [7, 6, 1124, 64] bf16 forward did not take mma")
    want_o, want_lse = fa._flash_fwd_reference(q, k, v, False, scale)
    torch.cuda.synchronize()
    errs = {"o": fa.flash_err(o, want_o), "lse": fa.flash_err(lse, want_lse)}
    max_abs = (o.float() - want_o.float()).abs().max().item()
    check(all(np.isfinite(e) and e <= FLASH_TOL["bfloat16"][x] for x, e in errs.items()),
          f"vit flash kernel: flash_err {errs} against {FLASH_TOL['bfloat16']}")
    flops, nbytes = flash_work(b, h, t, d, False, 2)["flash_fwd"]
    by_ops = flops / H100_BF16_PEAK_FLOPS >= nbytes / H100_BYTES_PER_S
    out = {
        "shape": [b, h, t, d], "dtype": "bfloat16", "causal": False,
        "flash_err": errs, "max_abs_err": max_abs,
        "ms": time_cuda(torch, lambda: fa.flash_fwd(q, k, v, False, scale)),
        "plain_ms": time_cuda(torch, lambda: fa._flash_fwd_reference(q, k, v, False, scale),
                              iters=5, warmup=1),
        "library_ms": time_cuda(torch, lambda: F.scaled_dot_product_attention(q, k, v)),
        "bound_ms": 1e3 * max(flops / H100_BF16_PEAK_FLOPS, nbytes / H100_BYTES_PER_S),
        "bound_by": "operations" if by_ops else "bytes",
        "flops": flops, "bytes": nbytes,
    }
    out["tflops"] = flops / out["ms"] / 1e9
    return out


def vit_flash_arm(torch, device, small):
    """ViTConfig(image_size=512): 1024 patches + 100 detection tokens, so
    attention takes the flash route. Served as the headline cell is (every
    client, `flash_requests` requests), the launch counts zeroed just before
    and read just after; every served result against its image alone; the
    forward of a batch of the seven through the kernel against the same
    through its plain version; on the card the kernel at that shape."""
    from nos_tpu_torch import init_vit
    from nos_tpu_torch.models.vit import vit_forward
    from nos_tpu_torch.ops import flash_attention as fa

    v = VIT_SMALL if small else VIT
    cfg = vit_model("bfloat16", small, image_size=512)
    check(cfg.seq_len >= 1024, f"vit flash arm: {cfg.seq_len} tokens")
    params = init_vit(cfg, torch.Generator().manual_seed(0), device=device)
    images = vit_images(torch, cfg, v["clients"], device)
    stats, served = vit_serve(torch, cfg, params, images, v, 1, v["flash_requests"], 1,
                              counted=fa)
    if device.type == "cuda":
        check(stats["launches"]["flash_fwd"] > 0, "vit flash arm: no flash_fwd launch")
        check_routes(stats["routes"], "flash_fwd", "mma", "vit flash arm")
        check(stats["launches"]["flash_bwd_dq"] == stats["launches"]["flash_bwd_dkv"] == 0,
              f"vit flash arm: backward launches {stats['launches']}")
    stats["agreement"] = vit_agreement(torch, served, vit_alone(torch, cfg, params, images),
                                       "bfloat16", VIT_TOL["bfloat16"], "vit flash arm")
    batch = torch.stack(images)
    logits, boxes = vit_forward(params, batch, cfg)
    with plain_vit_flash():
        p_logits, p_boxes = vit_forward(params, batch, cfg)
    strict = label_gap_mask(torch, p_logits, "bfloat16")
    labels = logits[..., :-1].argmax(-1)
    p_labels = p_logits[..., :-1].argmax(-1)
    stats["kernel_vs_plain"] = {
        "max_dlogit": (logits - p_logits).abs().max().item(),
        "max_dbox": (boxes - p_boxes).abs().max().item(),
        "gated_label_mismatches": int(((labels != p_labels) & strict).sum()),
        "label_mismatches": int((labels != p_labels).sum()),
    }
    kv = stats["kernel_vs_plain"]
    check(kv["max_dlogit"] <= VIT_FLASH_TOL["logit"] and kv["max_dbox"] <= VIT_FLASH_TOL["box"]
          and kv["gated_label_mismatches"] == 0,
          f"vit flash arm: kernel against plain {json.dumps(kv)}, bounds {VIT_FLASH_TOL}")
    if device.type == "cuda":
        stats["kernel"] = vit_flash_kernel(torch)
    return stats


def vit_mfu(torch, device):
    """runtime/mfu.py::vit_batch_mfu(batch=7): the cell's model, counted by
    FlopCounterMode (at 224 px attention is plain matmuls), its loop from
    64 calls against 16. Not None on the card, its mfu inside its range;
    None off the card."""
    from nos_tpu_torch.runtime.mfu import vit_batch_mfu

    t0 = time.perf_counter()
    out = vit_batch_mfu(batch=7, device=device, generator=torch.Generator().manual_seed(0))
    if device.type != "cuda":
        check(out is None, f"vit: vit_batch_mfu on {device} gave {out}")
        return None
    check(out is not None, "vit: vit_batch_mfu gave None on the card")
    lo, hi = out["mfu_range"]
    check(lo <= out["mfu"] <= hi, f"vit: mfu {out['mfu']} outside its range {out['mfu_range']}")
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_vit(torch, device, small=False):
    """The headline cell on the port: bench.py's seven closed-loop clients
    behind SliceServer on YOLOS-small (bf16, random weights from seed 0),
    then an f32 arm and the flash arm (512 px)."""
    from nos_tpu_torch import init_vit, vit_detect

    t0 = time.perf_counter()
    v = VIT_SMALL if small else VIT
    out = {"card": card_line(torch, device)}
    for dtype in ("bfloat16", "float32"):
        cfg = vit_model(dtype, small)
        params = init_vit(cfg, torch.Generator().manual_seed(0), device=device)
        images = vit_images(torch, cfg, v["clients"], device)
        if dtype == "bfloat16":
            stats, served = vit_serve(torch, cfg, params, images, v, v["warmup"],
                                      v["requests"], v["trials"])
        else:
            stats, served = vit_serve(torch, cfg, params, images, v, 1, v["f32_requests"], 1)
        stats["agreement"] = vit_agreement(torch, served, vit_alone(torch, cfg, params, images),
                                           dtype, VIT_TOL[dtype], f"vit {dtype}")
        if device.type == "cuda":
            batch = torch.stack(images)
            stats["batch7_ms"] = time_cuda(torch, lambda: vit_detect(params, batch, cfg))
            stats["batch7_device_ms"] = device_ms(torch, lambda: vit_detect(params, batch, cfg))
            stats["batch1_ms"] = time_cuda(torch, lambda: vit_detect(params, batch[:1], cfg))
        if dtype == "bfloat16":
            stats["batch_mfu"] = vit_mfu(torch, device)
            log("vit vit_batch_mfu: " + json.dumps(stats["batch_mfu"]))
        out[dtype] = stats
        log(f"vit {dtype}: " + json.dumps(stats))
        del params, images, served
    out["flash"] = vit_flash_arm(torch, device, small)
    log("vit flash: " + json.dumps(out["flash"]))
    out["phase_s"] = time.perf_counter() - t0
    log(f"vit: {out['card']} phase_s={out['phase_s']:.1f}")
    return out


# -- phase: mesh -----------------------------------------------------------------
# The sharded train step (dp 2 x tp 2) and the sp steps (ring and Ulysses at
# sp 4) against the single-device step from the same params and batches:
# max relative difference of the per-step loss, max|err| / max|want| of each
# gradient leaf of the first batch (the sharded step's summed gradient),
# max|err| of the params after the last step, and the relative difference of
# the two arms' updates (as train_vs_plain). First set at 1e-3, 0.1, 1.5e-2
# and 0.5; pinned at about 2.5x the worst of the three arms in the first
# measurement (NVIDIA H100 80GB HBM3, 700 W; PERF.md): loss 2.8e-6, grads 1.9e-2, params
# 1.95e-3 (two bf16 steps of a leaf's largest entries), updates 0.107 (the
# sp arms' one step: Adam's first update is a sign, which the near-zero
# gradient entries flip).
MESH_TOL = {"loss": 7e-6, "grad": 4.8e-2, "param": 4.9e-3, "update": 0.27}
# Pipeline (pp 2) and MoE (ep 4, top-2, ample capacity) in f32 against their
# sequential and dense references: max|err| of outputs and gradients. First
# set at 1e-4; pinned at about 2.5x the worst of the first measurement
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md): the pipeline's output 9.1e-7 (its microbatches' products
# against the whole batch's), gradients 1.9e-10, MoE 0.
MESH_F32_TOL = 2.3e-6


def mesh_arm(torch, device, model, axes, batches, steps, count=False):
    """The single-device step and the step over `axes` (every shard on
    `device`) from init_train_state(seed 0) on `batches`: the first batch's
    gradients (the sharded arm's summed ones, gathered), `steps` steps with
    CUDA-event times, the final params; with `count`, the flash launch
    counts zeroed just before the sharded steps and read just after."""
    from nos_tpu_torch import TrainConfig, gpt_loss, init_train_state, make_train_step
    from nos_tpu_torch.models.train import _sum_replica_grads, named_leaves
    from nos_tpu_torch.ops import flash_attention as fa
    from nos_tpu_torch.parallel import build_mesh
    from nos_tpu_torch.parallel.sharding import tree_get, unshard_tensor

    cfg = TrainConfig(model=model)
    cuda = device.type == "cuda"
    tokens = [torch.from_numpy(b).to(device) for b in batches]

    def timed(step, params, opt):
        losses, ms = [], []
        for tk in tokens[:steps]:
            if cuda:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
            else:
                t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, tk)
            if cuda:
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
            else:
                ms.append(1e3 * (time.perf_counter() - t0))
            losses.append(metrics["loss"].item())
        return params, losses, ms

    params, opt = init_train_state(cfg, torch.Generator().manual_seed(0), device=device)
    start = {n: p.detach().clone() for n, p in named_leaves(params)}
    gpt_loss(params, tokens[0], model, loss_chunk=cfg.loss_chunk).backward()
    s_grad = {n: p.grad.detach().clone() for n, p in named_leaves(params)}
    opt.zero_grad(set_to_none=True)
    params, s_loss, s_ms = timed(make_train_step(cfg), params, opt)
    s_par = {n: p.detach().clone() for n, p in named_leaves(params)}
    del params, opt
    gc.collect()

    mesh = build_mesh(axes, devices=[device] * int(np.prod(list(axes.values()))))
    params, opt = init_train_state(cfg, torch.Generator().manual_seed(0), mesh=mesh)
    gpt_loss(params, tokens[0], model, mesh, loss_chunk=cfg.loss_chunk).backward()
    _sum_replica_grads(params)
    m_grad = {n: unshard_tensor([x.grad for x in params.leaves(n)], mesh,
                                tree_get(params.specs, n)) for n in s_grad}
    opt.zero_grad(set_to_none=True)
    if count:
        fa.reset_launch_counts()
    params, m_loss, m_ms = timed(make_train_step(cfg, mesh), params, opt)
    launches = dict(fa.LAUNCHES)
    routes = {n: dict(r) for n, r in fa.ROUTE_LAUNCHES.items()}
    m_par = {n: p for n, p in named_leaves(params.gather())}
    del params, opt
    gc.collect()
    diff_sq = sum(((m_par[n].double() - s_par[n].double()) ** 2).sum().item() for n in s_par)
    upd_sq = sum(((s_par[n].double() - start[n].double()) ** 2).sum().item() for n in s_par)
    out = {
        "axes": axes, "attention": model.attention, "steps": steps,
        "losses_single": s_loss, "losses_mesh": m_loss,
        "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(m_loss, s_loss)),
        "grad_rel": max((m_grad[n].float() - s_grad[n].float()).abs().max().item()
                        / max(s_grad[n].float().abs().max().item(), 1e-30) for n in s_grad),
        "param_abs": max((m_par[n].float() - s_par[n].float()).abs().max().item()
                         for n in s_par),
        "update_rel": (diff_sq / upd_sq) ** 0.5 if upd_sq else float("inf"),
        "ms_single": s_ms, "ms_mesh": m_ms,
        "ms_per_step_single": float(np.mean(s_ms[1:] or s_ms)),
        "ms_per_step_mesh": float(np.mean(m_ms[1:] or m_ms)),
    }
    out["mesh_over_single"] = out["ms_per_step_mesh"] / out["ms_per_step_single"]
    if count:
        out["launches"], out["routes"] = launches, routes
    what = f"mesh {axes} {model.attention}"
    check(all(np.isfinite(s_loss + m_loss)), f"{what}: non-finite loss")
    check(out["loss_rel"] <= MESH_TOL["loss"] and out["grad_rel"] <= MESH_TOL["grad"]
          and out["param_abs"] <= MESH_TOL["param"] and out["update_rel"] <= MESH_TOL["update"],
          f"{what}: loss {out['loss_rel']}, grad {out['grad_rel']}, param {out['param_abs']}, "
          f"update {out['update_rel']} against {MESH_TOL}")
    return out


def mesh_pipeline(torch, device, small):
    """pipeline_apply at pp 2 (both stages on `device`), f32: tanh(x @ w +
    b) stages, 4 microbatches, against the stages applied in turn to the
    whole batch; the output and the gradients of mean(out^2)."""
    from nos_tpu_torch.parallel import build_mesh
    from nos_tpu_torch.parallel.pipeline import pipeline_apply

    h, b = (32, 8) if small else (1024, 64)
    gen = torch.Generator().manual_seed(6)
    w = (torch.randn((2, h, h), generator=gen) * h ** -0.5).to(device)
    bias = (torch.randn((2, h), generator=gen) * 0.1).to(device)
    x = torch.randn((b, h), generator=gen).to(device)

    def stage(p, y):
        return torch.tanh(y @ p["w"] + p["b"])

    pw, pb = w.clone().requires_grad_(True), bias.clone().requires_grad_(True)
    out = pipeline_apply({"w": pw, "b": pb}, x, stage, build_mesh({"pp": 2}, [device] * 2),
                         n_microbatches=4)
    (out ** 2).mean().backward()
    sw, sb = w.clone().requires_grad_(True), bias.clone().requires_grad_(True)
    ref = x
    for s in range(2):
        ref = stage({"w": sw[s], "b": sb[s]}, ref)
    (ref ** 2).mean().backward()
    res = {"out": (out - ref).abs().max().item(), "grad_w": (pw.grad - sw.grad).abs().max().item(),
           "grad_b": (pb.grad - sb.grad).abs().max().item()}
    check(all(np.isfinite(e) and e <= MESH_F32_TOL for e in res.values()),
          f"mesh pipeline: {res} against {MESH_F32_TOL}")
    return res


def mesh_moe(torch, device, small):
    """moe_apply at ep 4 (every rank on `device`), top-2, ample capacity
    (capacity_factor 8), f32, against the dense gate-weighted sum of each
    token's two experts."""
    import torch.nn.functional as F

    from nos_tpu_torch.parallel import build_mesh
    from nos_tpu_torch.parallel.moe import _top_k, init_moe, moe_apply

    h, m, e, b, t = (16, 32, 4, 2, 8) if small else (1024, 2048, 8, 4, 256)
    params = init_moe(h, m, e, dtype=torch.float32, generator=torch.Generator().manual_seed(7),
                      device=device)
    x = torch.randn((b, t, h), generator=torch.Generator().manual_seed(8)).to(device)
    got, aux = moe_apply(params, x, build_mesh({"ep": 4}, [device] * 4), top_k=2,
                         capacity_factor=8.0, return_aux=True)
    flat = x.reshape(-1, h)
    gate, idx = _top_k(torch.softmax(flat @ params["router"], dim=-1), 2)
    gate = gate / gate.sum(-1, keepdim=True)
    mid = F.gelu(torch.einsum("th,ehm->tem", flat, params["w_in"]), approximate="tanh")
    every = torch.einsum("tem,emh->teh", mid, params["w_out"])
    rows = torch.arange(flat.shape[0], device=device)
    want = sum(every[rows, idx[:, c]] * gate[:, c, None] for c in range(2)).reshape(b, t, h)
    res = {"out": (got - want).abs().max().item(), "aux": aux.item()}
    check(np.isfinite(res["aux"]) and res["out"] <= MESH_F32_TOL,
          f"mesh moe: {res} against {MESH_F32_TOL}")
    return res


def phase_mesh(torch, device, small=False):
    """The mesh trainers with every shard on one device: the sharded train
    step (dp 2 x tp 2) on the train phase's 2048-wide GPT cut to 2 layers,
    three steps, the flash launch counts of its main path; ring and Ulysses
    at sp 4, one step each; the pipeline and MoE against their references.
    Shards on one card run one after another: the sharded step is expected
    slower than the single-device one, and that is recorded, not gated."""
    from nos_tpu_torch import synthetic_token_stream

    t0 = time.perf_counter()
    full = not small
    # MESH_TOL is pinned for bf16 at full width on the card; a rehearsal's
    # tiny model runs in f32, which holds well inside it.
    model, (batch, seq) = train_model(full, 2, "bfloat16" if full else "float32")
    batches = list(synthetic_token_stream(model.vocab, batch, seq, seed=1, steps=3))
    out = {"card": card_line(torch, device)}
    out["dp2_tp2"] = mesh_arm(torch, device, model, {"dp": 2, "tp": 2}, batches, 3, count=True)
    if device.type == "cuda":
        # One launch of each kernel a layer and a position, a step.
        want = {n: model.layers * 4 * 3 for n in FLASH_KERNELS}
        check(out["dp2_tp2"]["launches"] == want,
              f"mesh: flash launches {out['dp2_tp2']['launches']}, want {want}")
        for name in FLASH_KERNELS:
            check_routes(out["dp2_tp2"]["routes"], name, "mma", "mesh dp2_tp2")
    log("mesh dp2_tp2: " + json.dumps(out["dp2_tp2"]))
    for attention in ("ring", "ulysses"):
        arm = mesh_arm(torch, device, dataclasses.replace(model, attention=attention),
                       {"sp": 4}, batches, 1)
        out[f"sp4_{attention}"] = arm
        log(f"mesh sp4_{attention}: " + json.dumps(arm))
    out["pipeline"] = mesh_pipeline(torch, device, small)
    out["moe"] = mesh_moe(torch, device, small)
    out["phase_s"] = time.perf_counter() - t0
    log(f"mesh: pipeline {json.dumps(out['pipeline'])} moe {json.dumps(out['moe'])} "
        f"{out['card']} phase_s={out['phase_s']:.1f}")
    return out


# -- phase: control -------------------------------------------------------------
# The control plane's first layer on the card's machine: the port's API
# server emulator on loopback and its Kubernetes client against it.
CONTROL = {"tpu_nodes": 2, "chips": 4, "pods": 6, "wait_s": 10.0}


def phase_control(torch, device, small=False):
    """The port's ClusterAPIServer (loopback, an ephemeral port, the quota
    webhooks installed) driven by the port's KubeCluster: Nodes with
    google.com/tpu allocatable and one labelled with this machine's device,
    Pods, ElasticQuotas (one the webhook refuses), a watch, a merge-patch
    whose null deletes an annotation, a status patch, a stale update
    refused as a conflict; telemetry.collect over the client and its
    counts; the kubelet pod-resources client imported without loading grpc
    (a deferred import: this machine may have none). No kernel runs."""
    import importlib.util

    from nos_tpu_torch import constants, telemetry
    from nos_tpu_torch.api.objects import Container, Node, NodeStatus, ObjectMeta, Pod, PodSpec
    from nos_tpu_torch.api.quota_types import ElasticQuota, ElasticQuotaSpec
    from nos_tpu_torch.api.resources import ResourceList
    from nos_tpu_torch.api.webhooks import install_quota_webhooks
    from nos_tpu_torch.cluster.apiserver import ClusterAPIServer
    from nos_tpu_torch.cluster.client import AdmissionError, ConflictError, EventType
    from nos_tpu_torch.cluster.kube import KubeCluster, KubeConfig

    t0 = time.perf_counter()
    c = CONTROL
    had_grpc = "grpc" in sys.modules
    importlib.import_module("nos_tpu_torch.cluster.pod_resources_grpc")
    check(("grpc" in sys.modules) == had_grpc, "control: importing the kubelet client loaded grpc")
    out = {"grpc_installed": importlib.util.find_spec("grpc") is not None}
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
    server = ClusterAPIServer().start()
    install_quota_webhooks(server.cluster)
    kube = KubeCluster(KubeConfig(server=server.url))
    events = []
    try:
        kube.watch("Pod", events.append)
        for i in range(c["tpu_nodes"]):
            kube.create(Node(
                metadata=ObjectMeta(name=f"tpu-{i}", labels={
                    constants.LABEL_TPU_ACCELERATOR: "tpu-v5-lite-podslice",
                    constants.LABEL_TPU_TOPOLOGY: "2x2",
                    constants.LABEL_PARTITIONING: constants.KIND_TPU}),
                status=NodeStatus(allocatable=ResourceList.of(
                    {constants.RESOURCE_TPU: c["chips"]}))))
        kube.create(Node(metadata=ObjectMeta(name="gpu-0", labels={
            constants.LABEL_GPU_PRODUCT: kind.replace(" ", "-"),
            constants.LABEL_PARTITIONING: constants.KIND_MPS})))
        for i in range(c["pods"]):
            kube.create(Pod(
                metadata=ObjectMeta(name=f"w{i}", namespace=f"team-{'ab'[i % 2]}",
                                    annotations={"keep": "1", "drop": "2"}),
                spec=PodSpec(scheduler_name=constants.SCHEDULER_NAME, containers=[Container(
                    resources=ResourceList.of({constants.RESOURCE_TPU: 1}))])))
        kube.create(ElasticQuota(metadata=ObjectMeta(name="eq", namespace="team-a"),
                                 spec=ElasticQuotaSpec(
                                     min=ResourceList.of({constants.RESOURCE_TPU: 4}),
                                     max=ResourceList.of({constants.RESOURCE_TPU: 8}))))
        try:
            kube.create(ElasticQuota(metadata=ObjectMeta(name="eq", namespace="team-b"),
                                     spec=ElasticQuotaSpec(
                                         min=ResourceList.of({constants.RESOURCE_TPU: 8}),
                                         max=ResourceList.of({constants.RESOURCE_TPU: 4}))))
            out["refused_quota"] = None
        except AdmissionError as e:
            out["refused_quota"] = str(e)
        check(out["refused_quota"] is not None and "exceeds max" in out["refused_quota"],
              f"control: min > max quota admitted ({out['refused_quota']})")
        patched = kube.patch("Pod", "team-a", "w0", lambda x: x.metadata.annotations.pop("drop"))
        check(patched.metadata.annotations == {"keep": "1"},
              f"control: merge-patch left {patched.metadata.annotations}")
        running = kube.patch("Pod", "team-a", "w0",
                             lambda x: setattr(x.status, "phase", "Running"))
        check(running.status.phase == "Running", "control: status patch not applied")
        stale = kube.get("Pod", "team-b", "w1")
        fresh = kube.get("Pod", "team-b", "w1")
        fresh.metadata.labels["rev"] = "2"
        kube.update(fresh)
        stale.metadata.labels["rev"] = "stale"
        try:
            kube.update(stale)
            out["conflict"] = None
        except ConflictError:
            out["conflict"] = "ConflictError"
        check(out["conflict"] == "ConflictError", "control: a stale update was accepted")
        deadline = time.monotonic() + c["wait_s"]
        want = c["pods"] + 3  # ADDED each pod; MODIFIED by two patches and one update
        while len(events) < want and time.monotonic() < deadline:
            time.sleep(0.02)
        out["events"] = {k: sum(e.type == k for e in events)
                         for k in (EventType.ADDED, EventType.MODIFIED, EventType.DELETED)}
        check(out["events"] == {EventType.ADDED: c["pods"], EventType.MODIFIED: 3,
                                EventType.DELETED: 0}, f"control: watch saw {out['events']}")
        out["pods"] = len(kube.list("Pod"))
        out["report"] = dataclasses.asdict(telemetry.collect(kube))
    finally:
        kube.close()
        server.stop()
    want = {"version": "0.1.0", "node_count": c["tpu_nodes"] + 1, "tpu_nodes": c["tpu_nodes"],
            "gpu_nodes": 1, "tpu_chips": c["tpu_nodes"] * c["chips"],
            "partitioning_modes": {constants.KIND_TPU: c["tpu_nodes"], constants.KIND_MPS: 1},
            "elastic_quotas": 1, "composite_quotas": 0}
    check(out["report"] == want, f"control: telemetry {out['report']}, want {want}")
    check(out["pods"] == c["pods"], f"control: {out['pods']} pods listed")
    out["phase_s"] = time.perf_counter() - t0
    log("control: " + json.dumps(out) + f" phase_s={out['phase_s']:.1f}")
    return out


# -- phase: topology ------------------------------------------------------------
# The control plane's device layer on the card's machine: the CUDA runtime's
# enumeration, the probe and the allocator's statistics behind tpulib/local.py,
# the native tpuslice shim built from the checkout, the packer at pod size,
# the provisioning client and leader election over loopback, and the last
# link: a node's sub-slice label becomes the mesh a sharded train step runs on.
TOPOLOGY = {"probe_timeout_s": 30.0, "held_bytes": 1 << 30, "pack_geometries": 40,
            "carve": {"8x8": 1, "4x8": 2, "4x4": 3, "2x4": 4, "2x2": 6, "1x2": 4, "1x1": 8},
            "pods": (("v5e", "16x16"), ("v5p", "8x8x8")), "subslice": "2x2"}


def _placements_ok(shape, placements):
    """Placements (or carved slice handles) of whole chips, inside `shape`,
    pairwise disjoint."""
    import itertools

    seen = set()
    for pl in placements:
        if sorted(pl.dims) != sorted(pl.profile.shape.dims):
            return False
        cells = set(itertools.product(*[range(o, o + d) for o, d in zip(pl.origin, pl.dims)]))
        if seen & cells or any(not 0 <= v < m for c in cells for v, m in zip(c, shape.dims)):
            return False
        seen |= cells
    return True


def topology_native(out):
    """The port's tpuslice shim built from the checkout and loaded (never
    the JAX package's; `shim_prebuilt` says whether a library of this
    source was already there); NativeTpuClient carving, listing and deleting a
    mixed geometry on a v5e 16x16 pod; native_pack against the Python
    packer (uncached) on seeded geometries at 256 and 512 chips, timed."""
    import random
    from pathlib import Path

    from nos_tpu_torch.tpu import Profile, Topology, pack
    from nos_tpu_torch.tpu import packing
    from nos_tpu_torch.tpulib import native_client as nc

    out["shim_prebuilt"] = nc.library_path().exists()
    t0 = time.perf_counter()
    built = nc.ensure_built()
    lib = nc.load_library() if built else None
    out["shim_build_s"] = time.perf_counter() - t0
    check(lib is not None, "topology: the native tpuslice shim did not build or load")
    path = Path(lib._name).resolve()
    out["shim"] = str(path.relative_to(Path(__file__).resolve().parent))
    check(path.parent == nc.BUILD_DIR.resolve(), f"topology: shim loaded from {path}")

    topo = Topology.parse("v5e", "16x16")
    geometry = {Profile.parse(n): c for n, c in TOPOLOGY["carve"].items()}
    placements = pack(topo.shape, geometry)
    check(placements is not None and _placements_ok(topo.shape, placements),
          "topology: the carve geometry does not pack onto v5e 16x16")
    client = nc.NativeTpuClient(topo)
    handles = [client.create_slice(pl.profile, pl.origin, pl.dims) for pl in placements]
    listed = client.list_slices()
    check(sorted((h.origin, h.dims) for h in listed) == sorted((pl.origin, pl.dims)
                                                              for pl in placements),
          "topology: the shim lists other slices than it carved")
    client.set_slice_in_use(handles[0].slice_id, True)
    deleted = client.delete_all_except([])
    check(len(deleted) == len(handles) - 1
          and [h.slice_id for h in client.list_slices()] == [handles[0].slice_id],
          "topology: delete_all_except removed an in-use slice or kept a free one")
    client.set_slice_in_use(handles[0].slice_id, False)
    client.delete_slice(handles[0].slice_id)
    check(client.list_slices() == [] and client.health() is None,
          "topology: the shim holds slices after deleting them all")
    out["carved"] = {"mesh": "v5e-16x16", "slices": len(handles),
                     "chips": sum(pl.chips for pl in placements)}

    rng = random.Random(17)
    out["pack"] = {}
    for gen, mesh in TOPOLOGY["pods"]:
        shape = Topology.parse(gen, mesh).shape
        menu = list(Topology.parse(gen, mesh).allowed_profiles)
        py_s = nat_s = 0.0
        placed = 0
        for i in range(TOPOLOGY["pack_geometries"]):
            geo = {}
            for _ in range(rng.randint(1, 6)):
                q = rng.choice(menu[:-1])
                geo[q] = geo.get(q, 0) + rng.randint(1, 4)
            occupied = [] if i % 2 == 0 else [((0,) * shape.rank, menu[0].shape.dims)]
            t = time.perf_counter()
            py = packing._pack_into_uncached(shape, occupied, geo)
            py_s += time.perf_counter() - t
            t = time.perf_counter()
            nat = nc.native_pack(shape.dims, occupied, geo)
            nat_s += time.perf_counter() - t
            want = None if py is None else [(pl.origin, pl.dims) for pl in py]
            check(nat == want, f"topology: native_pack {nat} against the Python packer {want} "
                               f"on {gen} {mesh} {geo}")
            placed += py is not None
        n = TOPOLOGY["pack_geometries"]
        out["pack"][f"{gen}-{mesh}"] = {"geometries": n, "packable": placed,
                                        "python_ms": 1e3 * py_s / n, "native_ms": 1e3 * nat_s / n}


def topology_update(out):
    """TpuMesh.update_geometry_for on each pod of TOPOLOGY["pods"] for a
    pending mix of every allowed profile but the whole pod (one each: 255 of
    256 and 509 of 512 chips), cold (the placement cache cleared): every
    profile provided, placements inside the mesh and disjoint, timed."""
    from nos_tpu_torch.tpu import Topology, TpuMesh, packing

    out["update"] = {}
    for gen, mesh in TOPOLOGY["pods"]:
        topo = Topology.parse(gen, mesh)
        demand = {q: 1 for q in topo.allowed_profiles[:-1]}
        packing._PACK_CACHE.clear()
        tm = TpuMesh(topo)
        t = time.perf_counter()
        changed = tm.update_geometry_for(demand)
        ms = 1e3 * (time.perf_counter() - t)
        placements = tm.placements()
        check(changed and tm.geometry == demand,
              f"topology: update_geometry_for on {topo} gave {tm!r} for {demand}")
        check(placements is not None and _placements_ok(topo.shape, placements),
              f"topology: {topo} placements overlap or leave the mesh")
        out["update"][str(topo)] = {"profiles": len(demand), "chips": 
                                    sum(q.chips for q in demand), "ms": ms,
                                    "placements": len(placements)}


def topology_cloud_and_leader(out, kube):
    """CloudTpuClient against the port's FakeCloudTpuServer on loopback: a
    queued resource created, polled to ACTIVE, listed and deleted. Two
    LeaderElectors over `kube`: exactly one leads, the other takes over
    after a release."""
    from nos_tpu_torch.tpu import Profile, Topology
    from nos_tpu_torch.tpulib.cloud import CloudTpuClient
    from nos_tpu_torch.tpulib.cloud_server import FakeCloudTpuServer
    from nos_tpu_torch.util.leader import LeaderElector

    srv = FakeCloudTpuServer()
    url = srv.start()
    try:
        srv.provision_delay_s = 0.1
        client = CloudTpuClient(Topology.parse("v5e", "16x16"), project="proj", zone="zone",
                                base_url=url, token_provider=lambda: "token",
                                poll_interval_s=0.01, retry_backoff_s=0.01,
                                provision_timeout_s=10.0)
        h = client.create_slice(Profile.parse("2x2"), (0, 0), (2, 2))
        polls = sum(r["method"] == "GET" and r["path"].endswith(h.slice_id) for r in srv.requests)
        listed = [s.slice_id for s in client.list_slices()]
        client.delete_slice(h.slice_id)
        check(polls >= 2 and listed == [h.slice_id] and client.list_slices() == []
              and client.health() is None,
              f"topology: cloud lifecycle polls {polls}, listed {listed}")
        out["cloud"] = {"slice": h.slice_id, "polls": polls}
    finally:
        srv.stop()

    electors = [LeaderElector(kube, lease_name="nos-tpu-operator", namespace="nos-system",
                              identity=name, lease_duration_s=15) for name in ("a", "b")]
    first = [e.try_acquire() for e in electors]
    electors[0].release()
    taken = electors[1].try_acquire()
    lease = kube.get("Lease", "nos-system", "nos-tpu-operator")
    check(first == [True, False] and taken and lease.spec.holder_identity == "b"
          and lease.spec.lease_transitions == 1,
          f"topology: leader election {first}, takeover {taken}, "
          f"holder {lease.spec.holder_identity}")
    out["leader"] = {"first": first, "takeover": taken,
                     "transitions": lease.spec.lease_transitions}


def topology_label_step(torch, device, model, mesh, tokens):
    """One sharded train step on `mesh` from init_train_state(seed 0): the
    loss, the gathered params, the flash launches by kernel and route, and
    the step's seconds."""
    from nos_tpu_torch import TrainConfig, init_train_state, make_train_step
    from nos_tpu_torch.models.train import named_leaves
    from nos_tpu_torch.ops import flash_attention as fa

    cfg = TrainConfig(model=model)
    params, opt = init_train_state(cfg, torch.Generator().manual_seed(0), mesh=mesh)
    step = make_train_step(cfg, mesh)
    sync(torch, device)
    fa.reset_launch_counts()
    t = time.perf_counter()
    params, opt, metrics = step(params, opt, tokens)
    loss = metrics["loss"].item()
    step_s = time.perf_counter() - t
    launches = dict(fa.LAUNCHES)
    routes = {n: dict(r) for n, r in fa.ROUTE_LAUNCHES.items()}
    par = {n: p.detach().clone() for n, p in named_leaves(params.gather())}
    del params, opt
    gc.collect()
    return loss, par, launches, routes, step_s


def phase_topology(torch, device, small=False):
    """The control plane's device layer (nos_tpu_torch/tpu/, util/, tpulib/)
    and mesh_from_assignment on the card: see the module docstring. A
    rehearsal runs every step on the CPU over a stub record (no allocator
    statistics to read: those checks need the card)."""
    import copy

    from nos_tpu_torch import constants, synthetic_token_stream
    from nos_tpu_torch.api.objects import Node, ObjectMeta
    from nos_tpu_torch.cluster.apiserver import ClusterAPIServer
    from nos_tpu_torch.cluster.kube import KubeCluster, KubeConfig
    from nos_tpu_torch.parallel import build_mesh, mesh_from_assignment
    from nos_tpu_torch.tpulib import TpuLibError
    from nos_tpu_torch.tpulib import local

    t0 = time.perf_counter()
    cuda = device.type == "cuda"
    out = {"card": card_line(torch, device)}

    # The device seam: enumeration, discovery's typed refusal, the probe.
    records = local._local_devices()
    out["devices"] = [[r.platform, r.device_kind, r.id] for r in records]
    if cuda:
        check(len(records) == torch.cuda.device_count() and records[device.index or 0].device_kind
              == torch.cuda.get_device_name(device) and records[0].platform == "gpu",
              f"topology: enumeration {out['devices']}")
        rec = records[device.index or 0]
    else:
        check(records == [] or not torch.cuda.is_available(), "topology: CPU enumeration")
        rec = types.SimpleNamespace(platform="cpu", device_kind="cpu", id=0, coords=None,
                                    torch_device=device, memory_stats=lambda: None)
    try:
        local.discover_local_topology()
        refusal = None
    except TpuLibError as e:
        refusal = str(e)
    out["discover"] = refusal
    check(refusal is not None and (not cuda or rec.device_kind in refusal),
          f"topology: discover_local_topology() on this machine gave {refusal!r}")
    check(local.local_chips_visible() is False, "topology: local_chips_visible() on a GPU")
    t = time.perf_counter()
    probe = local._probe_chip(rec, TOPOLOGY["probe_timeout_s"])
    out["probe_ms"] = 1e3 * (time.perf_counter() - t)
    check(probe == (None, False), f"topology: probe on {device} gave {probe}")

    # The card's record relabelled as a one-chip TPU: the client's health
    # probe and its allocator statistics run on the real device.
    chip = copy.copy(rec)
    chip.platform, chip.device_kind, chip.coords = "tpu", "TPU v5 lite", (0, 0, 0)
    saved = local._local_tpu_devices
    local._local_tpu_devices = lambda: [chip]
    try:
        client = local.LocalChipClient()
    finally:
        local._local_tpu_devices = saved
    check(str(client.get_topology()) == "v5e-1x1" and client.health() is None,
          f"topology: LocalChipClient over {device}: {client.get_topology()}, {client.health()}")
    if cuda:
        before = client.device_stats()[0]
        held = torch.empty(TOPOLOGY["held_bytes"], dtype=torch.uint8, device=device)
        during = client.device_stats()[0]
        del held
        total = torch.cuda.mem_get_info(device)[1]
        out["hbm"] = {"limit": during["hbm_bytes_limit"], "in_use_before":
                      before["hbm_bytes_in_use"], "in_use_held": during["hbm_bytes_in_use"],
                      "peak": during["hbm_peak_bytes_in_use"]}
        check(during["hbm_bytes_limit"] == total
              and during["hbm_bytes_in_use"] - before["hbm_bytes_in_use"]
              >= TOPOLOGY["held_bytes"], f"topology: device_stats {out['hbm']}, total {total}")
    else:
        out["hbm"] = "not measured (no allocator on the CPU)"

    topology_native(out)
    topology_update(out)

    # The API server carries the leader lease and the node whose labels
    # become the mesh.
    server = ClusterAPIServer().start()
    kube = KubeCluster(KubeConfig(server=server.url))
    try:
        topology_cloud_and_leader(out, kube)
        kube.create(Node(metadata=ObjectMeta(name="tpu-host-0", labels={
            constants.LABEL_TPU_ACCELERATOR: "tpu-v5-lite-podslice",
            constants.LABEL_TPU_TOPOLOGY: "16x16",
            constants.LABEL_TPU_SUBSLICE_TOPOLOGY: TOPOLOGY["subslice"]})))
        labels = kube.get("Node", "", "tpu-host-0").metadata.labels
    finally:
        kube.close()
        server.stop()

    label_mesh = mesh_from_assignment(labels, devices=[device] * 4)
    axes_mesh = build_mesh({"dp": 2, "tp": 2}, devices=[device] * 4)
    check(label_mesh.shape == {"dp": 2, "tp": 2} and label_mesh.shape == axes_mesh.shape
          and label_mesh.devices == axes_mesh.devices,
          f"topology: label mesh {label_mesh} against {axes_mesh}")
    full = not small
    model, (batch, seq) = train_model(full, 2, "bfloat16" if full else "float32")
    (tokens,) = [torch.from_numpy(b).to(device)
                 for b in synthetic_token_stream(model.vocab, batch, seq, seed=1, steps=1)]
    l_loss, l_par, l_launches, l_routes, l_s = topology_label_step(torch, device, model,
                                                                   label_mesh, tokens)
    a_loss, a_par, _, _, a_s = topology_label_step(torch, device, model, axes_mesh, tokens)
    same = l_loss == a_loss and l_par.keys() == a_par.keys() and all(
        torch.equal(l_par[n], a_par[n]) for n in a_par)
    out["label_step"] = {"mesh": dict(label_mesh.shape), "loss": l_loss, "bitwise": same,
                         "step_s_label": l_s, "step_s_build_mesh": a_s,
                         "launches": l_launches}
    check(np.isfinite(l_loss) and same,
          f"topology: the label mesh's step (loss {l_loss}) differs from build_mesh's "
          f"({a_loss})")
    if cuda:
        want = {n: model.layers * 4 for n in FLASH_KERNELS}
        check(l_launches == want, f"topology: flash launches {l_launches}, want {want}")
        for name in FLASH_KERNELS:
            check_routes(l_routes, name, "mma", "topology label step")
    del l_par, a_par
    gc.collect()
    out["phase_s"] = time.perf_counter() - t0
    log("topology: " + json.dumps(out))
    return out


# -- phase: partition -----------------------------------------------------------
# test_perf_planner.py's scenario (:44-47, :116): 100 pods of profiles weighted
# 2^-i from seed 0 against 4 x v5e 8x8, one control round. `builds` fresh
# builds of it are timed. The MPS backlog asks for more than the card holds.
PARTITION = {"nodes": 4, "mesh": "8x8", "pods": 100, "seed": 0, "builds": 6,
             "profiles": ("1x1", "1x2", "2x2", "2x4", "4x4", "4x8", "8x8"),
             "mps_sizes": ("10gb", "20gb", "40gb"), "mps_pods": 12, "mps_seed": 0,
             "mig_sizes": ("1g.10gb", "3g.40gb", "7g.80gb")}


def _unschedulable_pod(name, resources, ns="ml"):
    from nos_tpu_torch import constants
    from nos_tpu_torch.api.objects import (Container, ObjectMeta, Pod, PodCondition, PodPhase,
                                           PodSpec)
    from nos_tpu_torch.api.resources import ResourceList

    pod = Pod(metadata=ObjectMeta(name=name, namespace=ns),
              spec=PodSpec(containers=[Container(resources=ResourceList.of(resources))],
                           scheduler_name=constants.SCHEDULER_NAME))
    pod.status.phase = PodPhase.PENDING
    pod.status.conditions.append(
        PodCondition(type="PodScheduled", status="False", reason="Unschedulable"))
    return pod


def _fit_greedily(taker, state, pods):
    """{pod: node} for the pods that fit the carved cluster, bound in name
    order onto a fresh snapshot (the first node by name whose free
    resources hold the pod). The same rule as
    tests/test_torch_partitioning.py::schedulable, which the CPU checks
    hold both packages to."""
    from nos_tpu_torch.partitioning.core.interface import FitSimScheduler

    snap = taker.take_snapshot(state)
    sim = FitSimScheduler()
    fits = {}
    for pod in sorted(pods, key=lambda p: p.metadata.namespaced_name):
        for name in sorted(snap.nodes):
            node = snap.get_node(name)
            if sim.filter(pod, node.node_info()):
                node.add_pod(pod)
                fits[pod.metadata.namespaced_name] = name
                break
    return fits


def partition_tpu_round(make_client):
    """One fresh build of test_perf_planner.py's scenario: PARTITION["nodes"]
    TPU-mode nodes of one v5e mesh each, a TpuAgent over
    `make_client(topology)` on each, a PartitionerController with
    FitSimScheduler, and the seeded backlog; then its one control round.
    Returns the round's seconds, each agent's apply (spec to status,
    seconds), and the outcome: the pods that fit, the annotations without
    plan ids and the carved slices."""
    import random

    from nos_tpu_torch import constants
    from nos_tpu_torch.api import annotations as ann
    from nos_tpu_torch.api.objects import Node, NodeStatus, ObjectMeta
    from nos_tpu_torch.api.resources import ResourceList
    from nos_tpu_torch.cluster import Cluster
    from nos_tpu_torch.controllers.partitioner import PartitionerController
    from nos_tpu_torch.controllers.tpu_agent import TpuAgent
    from nos_tpu_torch.partitioning.core.interface import FitSimScheduler
    from nos_tpu_torch.partitioning.state import ClusterState
    from nos_tpu_torch.partitioning.tpu_mode import TpuPartitioner, TpuSnapshotTaker
    from nos_tpu_torch.tpu import Topology

    clock = types.SimpleNamespace(t=0.0)
    cluster = Cluster()
    state = ClusterState()
    state.start_watching(cluster)
    topology = Topology.parse("v5e", PARTITION["mesh"])
    agents, applies = {}, {}
    for i in range(PARTITION["nodes"]):
        name = f"n{i}"
        cluster.create(Node(
            metadata=ObjectMeta(name=name, labels={
                constants.LABEL_PARTITIONING: constants.KIND_TPU,
                constants.LABEL_TPU_ACCELERATOR: "tpu-v5-lite-podslice",
                constants.LABEL_TPU_TOPOLOGY: PARTITION["mesh"]}),
            status=NodeStatus(allocatable=ResourceList.of(
                {"cpu": 64, "google.com/tpu": topology.chips}))))
        agent = TpuAgent(cluster, name, make_client(topology))
        agent.startup()
        agent.start_watching()
        applies[name] = []

        def timed(reconcile=agent.reconcile, name=name):
            t = time.perf_counter()
            reconcile()
            applies[name].append(time.perf_counter() - t)

        agent.reconcile = timed
        agents[name] = agent
    controller = PartitionerController(
        cluster=cluster, state=state, kind=constants.KIND_TPU,
        snapshot_taker=TpuSnapshotTaker(), partitioner=TpuPartitioner(cluster),
        sim_scheduler=FitSimScheduler(), batch_timeout_s=1, batch_idle_s=1,
        now=lambda: clock.t)
    controller.start_watching()
    rng = random.Random(PARTITION["seed"])
    weights = [2.0 ** -i for i in range(len(PARTITION["profiles"]))]
    for j in range(PARTITION["pods"]):
        prof = rng.choices(PARTITION["profiles"], weights)[0]
        cluster.create(_unschedulable_pod(f"p{j}", {f"google.com/tpu-{prof}": 1}))
    clock.t += 61
    t = time.perf_counter()
    ran = controller.process_batch_if_ready()
    round_s = time.perf_counter() - t
    check(ran, "partition: the control round did not plan")
    fits = _fit_greedily(TpuSnapshotTaker(), state, cluster.list("Pod"))
    check(fits, "partition: the round made none of the backlog schedulable")
    nodes = {}
    for node in cluster.list("Node"):
        anns = node.metadata.annotations
        check(ann.node_reported_last_plan(anns)
              and ann.spec_matches_status(ann.parse_spec(anns), ann.parse_status(anns)),
              f"partition: {node.metadata.name}'s status does not match its spec")
        nodes[node.metadata.name] = {k: v for k, v in anns.items() if k not in (
            constants.ANNOTATION_SPEC_PLAN, constants.ANNOTATION_STATUS_PLAN)}
    slices = {}
    for name, agent in agents.items():
        handles = agent.client.list_slices()
        check(_placements_ok(topology.shape, handles),
              f"partition: {name}'s slices overlap or leave the mesh")
        slices[name] = sorted((h.profile.name, h.origin, h.dims, h.in_use) for h in handles)
        agent.stop()
    controller.stop()
    return round_s, applies, {"fits": sorted(fits), "nodes": nodes, "slices": slices}


def partition_mps(torch, device):
    """One MPS-mode node labelled from the card itself, the way GPU feature
    discovery labels it (product, count, memory in MiB), a GpuAgent over
    FakeGpuDeviceClient with the card's memory as its budget, and a seeded
    backlog of 10/20/40 GB pods asking for more than the card holds; then
    the same product in MIG mode, which the port's tables (A30, A100) leave
    unplanned."""
    import random

    from nos_tpu_torch import constants
    from nos_tpu_torch.api import annotations as ann
    from nos_tpu_torch.api.objects import Node, NodeStatus, ObjectMeta
    from nos_tpu_torch.api.resources import ResourceList
    from nos_tpu_torch.cluster import Cluster
    from nos_tpu_torch.controllers.gpu_agent import FakeGpuDeviceClient, GpuAgent, mps_validator
    from nos_tpu_torch.controllers.partitioner import PartitionerController
    from nos_tpu_torch.gpu.mig import model_known
    from nos_tpu_torch.gpu.mps import MpsProfile
    from nos_tpu_torch.partitioning.core.interface import FitSimScheduler
    from nos_tpu_torch.partitioning.gpu_modes import (MigPartitioner, MigSnapshotTaker,
                                                      MpsPartitioner, MpsSnapshotTaker)
    from nos_tpu_torch.partitioning.state import ClusterState

    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        count = torch.cuda.device_count()
        mib = torch.cuda.get_device_properties(device).total_memory // 2 ** 20
    else:  # a rehearsal stands in the facts an H100 80GB HBM3 reports to torch
        name, count, mib = "NVIDIA H100 80GB HBM3", 1, 81079
    product = name.replace(" ", "-")
    card_gb = int(round(mib / 1024))
    out = {"product": product, "count": count, "memory_mib": mib, "budget_gb": card_gb}
    clock = types.SimpleNamespace(t=0.0)
    now = lambda: clock.t  # noqa: E731

    def gpu_node(cluster, node_name, kind):
        cluster.create(Node(
            metadata=ObjectMeta(name=node_name, labels={
                constants.LABEL_PARTITIONING: kind,
                constants.LABEL_GPU_PRODUCT: product,
                constants.LABEL_GPU_COUNT: str(count),
                constants.LABEL_GPU_MEMORY: str(mib)}),
            status=NodeStatus(allocatable=ResourceList.of({"cpu": 64}))))

    def controller(cluster, state, kind, taker, partitioner):
        c = PartitionerController(cluster=cluster, state=state, kind=kind,
                                  snapshot_taker=taker, partitioner=partitioner,
                                  sim_scheduler=FitSimScheduler(), now=now)
        c.start_watching()
        return c

    cluster = Cluster()
    state = ClusterState()
    state.start_watching(cluster)
    gpu_node(cluster, "mps-0", constants.KIND_MPS)
    client = FakeGpuDeviceClient(count, mps_validator(card_gb))
    agent = GpuAgent(cluster, "mps-0", client, parse_profile=MpsProfile.from_resource,
                     resource_of=lambda p: f"nvidia.com/gpu-{p}")
    agent.startup()
    agent.start_watching()
    ctrl = controller(cluster, state, constants.KIND_MPS, MpsSnapshotTaker(),
                      MpsPartitioner(cluster))
    rng = random.Random(PARTITION["mps_seed"])
    asked = 0
    for i in range(PARTITION["mps_pods"]):
        size = rng.choice(PARTITION["mps_sizes"])
        asked += MpsProfile.parse(size).memory_gb
        cluster.create(_unschedulable_pod(f"mps-{i}", {f"nvidia.com/gpu-{size}": 1}))
    check(asked > card_gb * count, f"partition: the MPS backlog ({asked} GB) fits the card")
    clock.t += 11
    t = time.perf_counter()
    check(ctrl.process_batch_if_ready(), "partition: the MPS round did not plan")
    out["round_s"] = time.perf_counter() - t
    per_gpu = {}
    for d in client.list_devices():
        per_gpu[d.gpu_index] = per_gpu.get(d.gpu_index, 0) + MpsProfile.parse(d.profile).memory_gb
    pods = cluster.list("Pod")
    fits = _fit_greedily(MpsSnapshotTaker(), state, pods)
    node = cluster.get("Node", "", "mps-0")
    out.update(asked_gb=asked, carved_gb=per_gpu, devices=len(client.list_devices()),
               pods=len(pods), schedulable=len(fits), pending=len(pods) - len(fits))
    check(per_gpu and all(gb <= card_gb for gb in per_gpu.values())
          and sum(per_gpu.values()) * 1024 <= mib * count,
          f"partition: MPS carved {per_gpu} GB against {card_gb} GB a card")
    check(ann.node_reported_last_plan(node.metadata.annotations), "partition: MPS handshake")
    fit_gb = {}
    for key, _ in fits.items():
        pod = cluster.get("Pod", *key.split("/"))
        (res,) = [r for r in pod.spec.containers[0].resources if r.startswith("nvidia.com/gpu-")]
        fit_gb[res] = fit_gb.get(res, 0) + 1
    check(all(node.status.allocatable.get(r, 0) >= n for r, n in fit_gb.items()),
          f"partition: MPS pods {fit_gb} do not fit allocatable {dict(node.status.allocatable)}")
    check(0 < len(fits) < len(pods), f"partition: MPS made {len(fits)} of {len(pods)} "
          "pods schedulable; the backlog must leave some pending")
    agent.stop()
    ctrl.stop()

    # The same product in MIG mode: no MIG table, so no spec.
    cluster = Cluster()
    state = ClusterState()
    state.start_watching(cluster)
    gpu_node(cluster, "mig-0", constants.KIND_MIG)
    ctrl = controller(cluster, state, constants.KIND_MIG, MigSnapshotTaker(),
                      MigPartitioner(cluster))
    for i, size in enumerate(PARTITION["mig_sizes"]):
        cluster.create(_unschedulable_pod(f"mig-{i}", {f"nvidia.com/mig-{size}": 1}))
    clock.t += 11
    ctrl.process_batch_if_ready()
    specs = ann.parse_spec(cluster.get("Node", "", "mig-0").metadata.annotations)
    out["mig"] = {"model_known": model_known(product), "specs": len(specs)}
    check(not model_known(product) and not specs,
          f"partition: the MIG-mode {product} node got a spec {specs}")
    ctrl.stop()
    return out


def phase_partition(torch, device):
    """The partitioning plane (nos_tpu_torch/partitioning/, controllers/,
    gpu/) on the card's machine: see the module docstring. No kernel. The
    native shim is built here when the topology phase did not run first;
    a rehearsal runs the same sizes on the CPU, over the shim where g++
    exists and the Python fake elsewhere."""
    import statistics

    from nos_tpu_torch.tpulib import FakeTpuClient
    from nos_tpu_torch.tpulib import native_client as nc

    t0 = time.perf_counter()
    cuda = device.type == "cuda"
    out = {"card": card_line(torch, device), "shim_prebuilt": nc.library_path().exists()}
    t = time.perf_counter()
    built = nc.ensure_built() and nc.load_library() is not None
    out["shim_build_s"] = time.perf_counter() - t
    check(built or not cuda, "partition: the native tpuslice shim did not build or load")
    native = nc.NativeTpuClient if built else FakeTpuClient
    out["client"] = native.__name__

    from nos_tpu_torch.tpu.packing import _PACK_CACHE

    _PACK_CACHE.clear()  # the first build plans cold; the later ones reuse its packs
    rounds, applies, outcomes = [], {}, []
    for _ in range(PARTITION["builds"]):
        round_s, build_applies, outcome = partition_tpu_round(native)
        rounds.append(round_s)
        outcomes.append(outcome)
        for name, seq in build_applies.items():
            check(len(seq) == 1, f"partition: {name} applied {len(seq)} times in one round")
            applies.setdefault(name, []).extend(seq)
    _, _, fake = partition_tpu_round(FakeTpuClient)
    for b, got in enumerate(outcomes):
        check(got == fake, f"partition: build {b} over {native.__name__} differs from "
              f"FakeTpuClient's: fits {len(got['fits'])} against {len(fake['fits'])}")
    chips = {name: sum(int(np.prod(dims)) for _, _, dims, _ in s)
             for name, s in fake["slices"].items()}
    out["tpu"] = {
        "nodes": PARTITION["nodes"], "mesh": f"v5e-{PARTITION['mesh']}",
        "chips": PARTITION["nodes"] * 64, "pods": PARTITION["pods"],
        "builds": PARTITION["builds"], "rounds_ms": [1e3 * x for x in rounds],
        "cold_round_ms": 1e3 * rounds[0],
        "warm_median_round_ms": 1e3 * statistics.median(rounds[1:]),
        "apply_ms": {name: [1e3 * x for x in seq] for name, seq in applies.items()},
        "schedulable": len(fake["fits"]),
        "pending": PARTITION["pods"] - len(fake["fits"]),
        "slices": {name: len(s) for name, s in fake["slices"].items()},
        "chips_carved": chips,
    }
    out["mps"] = partition_mps(torch, device)
    out["phase_s"] = time.perf_counter() - t0
    log("partition: " + json.dumps(out))
    return out


# -- phase: schedule ------------------------------------------------------------
# test_perf_planner.py:135's group-mode round (one 16x16 slice group of 64
# hosts of 2x2, 100 gangs of 2x2..8x8 weighted 2^-i from seed 0, both
# scheduler passes around one GroupPartitioner batch, under 3.0 s), on
# `builds` fresh ControlPlanes; the CLI's north-star simulation;
# build_tpu_agent and build_gpu_agent; the demo. The rehearsal's sizes are SCHEDULE_SMALL's.
SCHEDULE = {"builds": 5, "ceiling_s": 3.0, "group": ("16x16", "2x2", (8, 8)), "gangs": 100,
            "seed": 0, "shapes": (("2x2", 1), ("2x4", 2), ("4x4", 4), ("4x8", 8), ("8x8", 16)),
            "simulate": [], "cli_timeout_s": 300,
            "gpu_sizes": ("10gb", "20gb", "40gb"), "gpu_pods": 6, "gpu_seed": 0}
SCHEDULE_SMALL = dict(SCHEDULE, builds=2, group=("8x8", "2x2", (4, 4)), gangs=20,
                      shapes=(("2x2", 1), ("2x4", 2), ("4x4", 4), ("4x8", 8)),
                      simulate=["--jobs", "40", "--nodes", "2", "--topology", "4x4"])

# What `python -m nos_tpu.cli simulate` (the JAX package's CLI, no flags: 4 x
# v5e 8x8, 256 chips, cli_single_host_trace(200), seed 0, window 180-900 s)
# prints on the CPU, and the same with `--jobs 40 --nodes 2 --topology 4x4`
# for the rehearsal. The run is deterministic: the port's CLI must print it.
NORTH_STAR_REPORT = {
    "total_chips": 256, "jobs": 200, "completed": 200, "unfinished": 0, "utilization": 0.8988,
    "utilization_total": 0.7348, "utilization_window": 0.9728, "p50_schedule_latency_s": 4.0,
    "p95_schedule_latency_s": 476.0, "makespan_s": 1545.0, "preemptions": 65}
NORTH_STAR_REPORT_SMALL = {
    "total_chips": 32, "jobs": 40, "completed": 40, "unfinished": 0, "utilization": 0.9126,
    "utilization_total": 0.7069, "utilization_window": 0.9046, "p50_schedule_latency_s": 224.0,
    "p95_schedule_latency_s": 575.0, "makespan_s": 1378.0, "preemptions": 6}


def make_group(plane, slice_id="s0", global_topo="8x8", host_topo="2x2", grid=(4, 4)):
    """tests/test_multihost.py:34: a slice group of grid[0] x grid[1] hosts
    of host_topo chips, each with its HostAgent."""
    from nos_tpu_torch import constants
    from nos_tpu_torch.api.objects import Node, NodeStatus, ObjectMeta
    from nos_tpu_torch.api.resources import ResourceList

    names = []
    for r in range(grid[0]):
        for c in range(grid[1]):
            name = f"{slice_id}-host-{r}-{c}"
            plane.cluster.create(Node(
                metadata=ObjectMeta(name=name, labels={
                    constants.LABEL_PARTITIONING: constants.KIND_TPU_MULTIHOST,
                    constants.LABEL_TPU_SLICE: slice_id,
                    constants.LABEL_TPU_ACCELERATOR: "tpu-v5-lite-podslice",
                    constants.LABEL_TPU_TOPOLOGY: global_topo,
                    constants.LABEL_TPU_HOST_TOPOLOGY: host_topo,
                    constants.LABEL_TPU_HOST_COORD: f"{r},{c}"}),
                status=NodeStatus(allocatable=ResourceList.of(
                    {"cpu": 32, "memory": "64Gi", "google.com/tpu": 4}))))
            plane.add_host_agent(name)
            names.append(name)
    return names


def submit_gang(plane, name, ns, topology, size, priority=0):
    """tests/test_multihost.py:65: `size` pods of one gang asking for a
    sub-slice of `topology`."""
    from nos_tpu_torch import constants
    from nos_tpu_torch.api.objects import Container, ObjectMeta, Pod, PodSpec
    from nos_tpu_torch.api.resources import ResourceList

    for i in range(size):
        plane.cluster.create(Pod(
            metadata=ObjectMeta(name=f"{name}-{i}", namespace=ns, labels={
                constants.LABEL_GANG: name, constants.LABEL_GANG_SIZE: str(size)}),
            spec=PodSpec(
                containers=[Container(resources=ResourceList.of({"google.com/tpu": 4, "cpu": 1}))],
                scheduler_name=constants.SCHEDULER_NAME, priority=priority,
                node_selector={constants.LABEL_TPU_SUBSLICE_TOPOLOGY: topology})))


def schedule_group_round(s):
    """One fresh ControlPlane on a virtual clock with test_perf_planner.py:135's
    group and backlog; the round (first pass, the batch, second pass) timed
    as that test times it. Returns its seconds and the bindings."""
    import random

    from nos_tpu_torch import constants
    from nos_tpu_torch.system import ControlPlane

    clock = types.SimpleNamespace(t=0.0)
    plane = ControlPlane(now=lambda: clock.t).start()
    try:
        global_topo, host_topo, grid = s["group"]
        make_group(plane, "s0", global_topo=global_topo, host_topo=host_topo, grid=grid)
        rng = random.Random(s["seed"])
        weights = [2.0 ** -i for i in range(len(s["shapes"]))]
        for j in range(s["gangs"]):
            topo, size = rng.choices(s["shapes"], weights)[0]
            submit_gang(plane, f"g{j}", "ml", topo, size)
        t = time.perf_counter()
        plane.scheduler.schedule_pending()
        clock.t += 61
        check(plane.group_partitioner.process_batch_if_ready(),
              "schedule: the group partitioner did not plan")
        result = plane.scheduler.schedule_pending()
        round_s = time.perf_counter() - t
        pods = {p.metadata.namespaced_name: p for p in plane.cluster.list("Pod")}
        bound = {name: p.spec.node_name for name, p in pods.items() if p.spec.node_name}
        check(len(bound) == len(result["bound"]),
              f"schedule: {len(result['bound'])} binds reported, {len(bound)} pods bound")
        gangs = {}
        for p in pods.values():
            gangs.setdefault(p.metadata.labels[constants.LABEL_GANG], []).append(
                bool(p.spec.node_name))
        partial = [g for g, b in gangs.items() if any(b) and not all(b)]
        check(not partial, f"schedule: gangs bound in part {partial}")
        return round_s, {"bound": bound, "gangs_bound": sorted(g for g, b in gangs.items()
                                                               if all(b))}
    finally:
        plane.stop()


def schedule_cli(args, timeout_s):
    """`python -m nos_tpu_torch.cli <args>` from the repository root, held to
    exit 0: its standard output and wall seconds."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    t = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "nos_tpu_torch.cli"] + args, cwd=root,
                         capture_output=True, text=True, timeout=timeout_s)
    wall = time.perf_counter() - t
    check(res.returncode == 0, f"schedule: `cli {' '.join(args)}` exited {res.returncode}: "
          f"{res.stderr[-2000:]}")
    return res.stdout, wall


def schedule_tpu_agent(torch, device):
    """build_tpu_agent with the operator's explicit grant
    (NOS_TPU_LOCAL_CHIPS=1) on a node labelled as a one-chip v5e: the port's
    LocalChipClient refuses a CUDA device with a TpuLibError naming it, and
    build_tpu_agent logs that and lands on the native shim (never the fake)."""
    import logging
    import os

    from nos_tpu_torch import constants
    from nos_tpu_torch.api.objects import Node, NodeStatus, ObjectMeta
    from nos_tpu_torch.api.resources import ResourceList
    from nos_tpu_torch.cluster import Cluster
    from nos_tpu_torch.config import AgentConfig
    from nos_tpu_torch.system import build_tpu_agent
    from nos_tpu_torch.tpulib import native_client as nc

    cuda = device.type == "cuda"
    cluster = Cluster()
    cluster.create(Node(
        metadata=ObjectMeta(name="card-0", labels={
            constants.LABEL_PARTITIONING: constants.KIND_TPU,
            constants.LABEL_TPU_ACCELERATOR: "tpu-v5-lite-podslice",
            constants.LABEL_TPU_TOPOLOGY: "1x1"}),
        status=NodeStatus(allocatable=ResourceList.of({"cpu": 8, "google.com/tpu": 1}))))
    warnings = []

    class Keep(logging.Handler):
        def emit(self, record):
            warnings.append(record.getMessage())

    handler = Keep(level=logging.WARNING)
    system_log = logging.getLogger("nos_tpu_torch.system")
    system_log.addHandler(handler)
    before = os.environ.get(constants.ENV_LOCAL_CHIPS)
    os.environ[constants.ENV_LOCAL_CHIPS] = "1"
    try:
        agent = build_tpu_agent(cluster, "card-0", AgentConfig())
    finally:
        system_log.removeHandler(handler)
        if before is None:
            os.environ.pop(constants.ENV_LOCAL_CHIPS)
        else:
            os.environ[constants.ENV_LOCAL_CHIPS] = before
    kind = torch.cuda.get_device_name(device) if cuda else None
    grant = [w for w in warnings if "local-chip grant set but unusable" in w]
    out = {"client": type(agent.client).__name__, "warning": grant[0] if grant else None,
           "shim_loaded": nc.load_library() is not None}
    check(grant, f"schedule: no warning of the refused grant in {warnings}")
    if cuda:
        check(kind in grant[0], f"schedule: the warning does not name {kind}: {grant[0]}")
    if cuda or out["shim_loaded"]:
        check(type(agent.client) is nc.NativeTpuClient and out["shim_loaded"],
              f"schedule: the granted agent landed on {out['client']}, not the native shim")
    check(agent.client.get_topology().chips == 1, "schedule: the agent's topology is not 1x1")
    return out


def schedule_gpu_agent(torch, device, s):
    """build_gpu_agent in MPS mode with the card's own memory as its budget,
    on a node labelled from the card, inside a ControlPlane: a small mixed
    backlog, one scheduler pass, the batch window closed, one tick."""
    import random

    from nos_tpu_torch import constants
    from nos_tpu_torch.api.objects import Container, Node, NodeStatus, ObjectMeta, Pod, PodSpec
    from nos_tpu_torch.api.resources import ResourceList
    from nos_tpu_torch.gpu.mps import MpsProfile
    from nos_tpu_torch.system import ControlPlane, build_gpu_agent

    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        count = torch.cuda.device_count()
        mib = torch.cuda.get_device_properties(device).total_memory // 2 ** 20
    else:  # a rehearsal stands in the facts an H100 80GB HBM3 reports to torch
        name, count, mib = "NVIDIA H100 80GB HBM3", 1, 81079
    card_gb = int(round(mib / 1024))
    clock = types.SimpleNamespace(t=0.0)
    plane = ControlPlane(now=lambda: clock.t).start()
    try:
        plane.cluster.create(Node(
            metadata=ObjectMeta(name="mps-0", labels={
                constants.LABEL_PARTITIONING: constants.KIND_MPS,
                constants.LABEL_GPU_PRODUCT: name.replace(" ", "-"),
                constants.LABEL_GPU_COUNT: str(count),
                constants.LABEL_GPU_MEMORY: str(mib)}),
            status=NodeStatus(allocatable=ResourceList.of({"cpu": 64}))))
        agent = build_gpu_agent(plane.cluster, "mps-0", constants.KIND_MPS, count,
                                memory_gb=card_gb)
        agent.startup()
        agent.start_watching()
        plane.agents["mps-0"] = agent
        rng = random.Random(s["gpu_seed"])
        asked = []
        for i in range(s["gpu_pods"]):
            size = rng.choice(s["gpu_sizes"])
            asked.append(size)
            plane.cluster.create(Pod(
                metadata=ObjectMeta(name=f"mps-{i}", namespace="ml"),
                spec=PodSpec(containers=[Container(resources=ResourceList.of(
                    {f"{constants.RESOURCE_MPS_PREFIX}{size}": 1, "cpu": 1}))],
                    scheduler_name=constants.SCHEDULER_NAME)))
        plane.scheduler.schedule_pending()
        clock.t += 61
        result = plane.tick()
        devices = sorted((d.gpu_index, d.profile) for d in agent.client.list_devices())
        pods = plane.cluster.list("Pod", namespace="ml")
        bound = sorted(p.metadata.name for p in pods if p.spec.node_name)
        carved = sum(MpsProfile.parse(p).memory_gb for _, p in devices)
        out = {"product": name.replace(" ", "-"), "memory_gb": card_gb, "asked": asked,
               "devices": devices, "carved_gb": carved, "bound": bound,
               "pending": len(pods) - len(bound),
               "bound_in_tick": len(result["first_pass"]["bound"])
               + len(result["second_pass"]["bound"])}
        check(devices and carved <= card_gb * count,
              f"schedule: MPS carved {devices} against {card_gb} GB a card")
        check(bound, "schedule: no MPS pod bound after the tick")
        return out
    finally:
        plane.stop()


def phase_schedule(torch, device, small=False):
    """The scheduler and the control plane's wiring, simulator and CLI
    (nos_tpu_torch/scheduler/, system.py, sim.py, sim_oracle.py, cli.py) on
    the card's machine: see the module docstring. No kernel."""
    import statistics

    from nos_tpu_torch.tpu.packing import _PACK_CACHE

    t0 = time.perf_counter()
    s = SCHEDULE_SMALL if small else SCHEDULE
    out = {"card": card_line(torch, device)}
    _PACK_CACHE.clear()  # the first build plans cold; the later ones reuse its packs
    rounds, outcomes = [], []
    for _ in range(s["builds"]):
        round_s, outcome = schedule_group_round(s)
        rounds.append(round_s)
        outcomes.append(outcome)
    for b, got in enumerate(outcomes):
        check(got == outcomes[0], f"schedule: build {b}'s bindings differ from build 0's")
    gangs_bound = len(outcomes[0]["gangs_bound"])
    check(gangs_bound > 0, "schedule: the group round bound no gang")
    check(max(rounds) < s["ceiling_s"],
          f"schedule: a group round took {max(rounds):.3f} s (ceiling {s['ceiling_s']} s)")
    global_topo, host_topo, grid = s["group"]
    out["group_round"] = {
        "group": f"v5e {global_topo} as {grid[0] * grid[1]} hosts of {host_topo}",
        "gangs": s["gangs"], "builds": s["builds"], "rounds_ms": [1e3 * x for x in rounds],
        "cold_ms": 1e3 * rounds[0], "warm_median_ms": 1e3 * statistics.median(rounds[1:]),
        "ceiling_s": s["ceiling_s"], "ceiling_held": max(rounds) < s["ceiling_s"],
        "gangs_bound": gangs_bound, "pods_bound": len(outcomes[0]["bound"])}

    stdout, wall = schedule_cli(["simulate"] + s["simulate"], s["cli_timeout_s"])
    report = json.loads(stdout.strip().splitlines()[-1])
    want = NORTH_STAR_REPORT_SMALL if small else NORTH_STAR_REPORT
    check(report == want, f"schedule: the CLI's north-star report {report} is not the "
          f"reference's {want}")
    check(report["completed"] == report["jobs"] and report["unfinished"] == 0,
          f"schedule: {report['completed']} of {report['jobs']} jobs completed")
    check(report["utilization"] >= 0.85, f"schedule: utilization {report['utilization']}")
    out["north_star"] = {"args": s["simulate"], "report": report, "wall_s": wall,
                         "equals_reference": report == want}

    out["tpu_agent"] = schedule_tpu_agent(torch, device)
    out["gpu_agent"] = schedule_gpu_agent(torch, device, s)
    stdout, wall = schedule_cli(["demo"], s["cli_timeout_s"])
    check("pod bound to: tpu-node-0" in stdout, f"schedule: demo printed {stdout[-500:]}")
    out["demo"] = {"exit": 0, "wall_s": wall}
    out["phase_s"] = time.perf_counter() - t0
    log("schedule: " + json.dumps(out))
    return out


# -- phase: lint -------------------------------------------------------------------
# The port's analyzer from the repository root, as a user runs it; a planted
# engine file whose `_tick` blocks on the host (`.item()`) and uploads past
# the staging funnel (`torch.tensor(..., device=)`) at PLANTED's lines.
LINT = {"timeout_s": 300}
PLANTED = {
    "runtime/engine.py": (
        "import torch\n"
        "\n"
        "class Engine:\n"
        "    def _tick(self):\n"
        "        n = self.lens[0].item()\n"
        "        ids = torch.tensor(self.queue, device=self.device)\n"
        "        return n, ids\n"
    ),
}
PLANTED_FINDINGS = [("runtime/engine.py", 5, "NOS010"), ("runtime/engine.py", 6, "NOS015")]


def lint_cli(args, timeout_s):
    """`python -m nos_tpu_torch.cli lint <args> --format json` from the
    repository root: (exit code, its JSON report, wall seconds)."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    t = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "nos_tpu_torch.cli", "lint"] + args
                         + ["--format", "json"], cwd=root, capture_output=True, text=True,
                         timeout=timeout_s)
    wall = time.perf_counter() - t
    try:
        report = json.loads(res.stdout)
    except ValueError:
        raise PhaseError(f"lint: `cli lint {' '.join(args)}` exited {res.returncode} "
                         f"without a JSON report: {res.stdout[-1000:]} {res.stderr[-2000:]}")
    return res.returncode, report, wall


def phase_lint(torch, device):
    """The port's static-analysis suite on the card's machine: see the
    module docstring. No kernel."""
    import os
    import re
    import tempfile

    from nos_tpu_torch import analysis

    t0 = time.perf_counter()
    s = LINT
    root = os.path.dirname(os.path.abspath(__file__))
    entries = analysis.load_baseline(os.path.join(root, "lint-baseline-torch.txt"))
    cache = os.path.join(root, analysis.CACHE_BASENAME)
    out = {"card": card_line(torch, device), "baseline_entries": len(entries)}

    def stats(report):
        m = re.match(r"(\d+) files \((\d+) parsed, (\d+) reused from cache\), "
                     r"cross-file (\w+), ([\d.]+)s", report["stats"])
        check(m, f"lint: unreadable stats {report['stats']!r}")
        return {"files": int(m[1]), "parsed": int(m[2]), "reused": int(m[3]),
                "crossfile": m[4], "engine_s": float(m[5])}

    def clean(what, rc, report):
        check(rc == 0, f"lint: the {what} run exited {rc}: {report['findings'][:5]}")
        check(report["findings"] == [], f"lint: {what} findings {report['findings'][:5]}")
        check(report["suppressed"] == len(entries),
              f"lint: {what} suppressed {report['suppressed']}, baseline {len(entries)}")
        check(report["stale_baseline_entries"] == [],
              f"lint: {what} stale {report['stale_baseline_entries']}")

    rc, cold, cold_s = lint_cli(["nos_tpu_torch", "--no-cache"], s["timeout_s"])
    clean("cold", rc, cold)
    if os.path.exists(cache):
        os.remove(cache)
    try:
        rc, filled, filled_s = lint_cli(["nos_tpu_torch"], s["timeout_s"])
        clean("cache-filling", rc, filled)
        rc, warm, warm_s = lint_cli(["nos_tpu_torch"], s["timeout_s"])
        clean("warm", rc, warm)
    finally:
        if os.path.exists(cache):
            os.remove(cache)
    cold_st, filled_st, warm_st = stats(cold), stats(filled), stats(warm)
    dump = json.dumps(cold["findings"], sort_keys=True)
    for what, report in (("cache-filling", filled), ("warm", warm)):
        check(json.dumps(report["findings"], sort_keys=True) == dump,
              f"lint: the {what} findings differ from the cold run's")
    check(cold_st["parsed"] == cold_st["files"] == filled_st["parsed"],
          f"lint: cold runs parsed {cold_st['parsed']} and {filled_st['parsed']} of "
          f"{cold_st['files']} files")
    check(warm_st["parsed"] == 0 and warm_st["reused"] == warm_st["files"]
          and warm_st["crossfile"] == "reused", f"lint: the warm run did not reuse: {warm_st}")
    out.update(files=cold_st["files"], findings=len(cold["findings"]),
               suppressed=cold["suppressed"], stale=len(cold["stale_baseline_entries"]),
               cold_s=cold_s, cold_engine_s=cold_st["engine_s"], filled_s=filled_s,
               warm_s=warm_s, warm_engine_s=warm_st["engine_s"], warm_parsed=warm_st["parsed"])

    with tempfile.TemporaryDirectory() as tmp:
        for rel, source in PLANTED.items():
            os.makedirs(os.path.join(tmp, os.path.dirname(rel)), exist_ok=True)
            with open(os.path.join(tmp, rel), "w") as fh:
                fh.write(source)
        rc, planted, planted_s = lint_cli(
            [tmp, "--root", tmp, "--no-cache", "--no-baseline"], s["timeout_s"])
    found = sorted((f["path"], f["line"], f["code"]) for f in planted["findings"])
    check(rc == 1 and found == PLANTED_FINDINGS,
          f"lint: the planted engine gave exit {rc} and {found}, not {PLANTED_FINDINGS}")
    out["planted"] = {"exit": rc, "findings": [list(f) for f in found], "wall_s": planted_s}
    out["phase_s"] = time.perf_counter() - t0
    log("lint: " + json.dumps(out))
    return out


# -- phase: examples ------------------------------------------------------------
# The repo's entry points outside the package, on the port:
# examples/end_to_end_torch.py (carve, mesh, train, serve) and
# examples/sharing-comparison/run_local_torch.py (the 1/3/5/7 sweep).
EXAMPLES_WORKLOADS = (1, 3, 5, 7)
# The end-to-end example's five dp 2 x tp 4 bf16 steps through the flash
# kernels against the same steps with the kernel's plain formula
# (`plain_flash`): the max relative difference of the per-step loss. First
# set at 2e-3, about half a bf16 step; measured 2.51e-4 on an NVIDIA H100
# 80GB HBM3 at 700 W (PERF.md).
EXAMPLES_LOSS_RTOL = 2e-3
# The flash kernels timed at head_dim 16: the end-to-end example's shape at
# a mesh position (batch 8 / dp 2, 4 heads / tp 4, T 32), and the training
# batch's 8 x 8 x 2048.
FLASH_D16 = ((4, 1, 32, 16, "bfloat16", True), (8, 8, 2048, 16, "bfloat16", True))


def load_script(rel, name):
    """A script of the repository (`rel` from its root) as module `name`."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), rel)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def examples_end_to_end(torch, device):
    """examples/end_to_end_torch.py's three acts through its functions: the
    carve and bind, five dp 2 x tp 4 steps on `["cuda:0"] * 8` (the flash
    launch counts zeroed just before and read just after; then the same
    steps through the plain formula), and the gathered params served (the
    paged kernels' counts zeroed just before and read just after; the
    served tokens held by the teacher-forced oracle)."""
    from nos_tpu_torch.models.train import TrainConfig
    from nos_tpu_torch.ops import flash_attention as fa
    from nos_tpu_torch.ops import paged_attention as pa

    ex = load_script("examples/end_to_end_torch.py", "end_to_end_torch")
    cuda = device.type == "cuda"
    model = ex.MODEL
    out = {}

    def say(line):
        log(f"examples e2e: {line}")

    bound = ex.carve_and_bind(say=say)
    check(bound["node"] == "tpu-node-0" and bound["carved"] == {"google.com/tpu-2x4": 1},
          f"examples e2e: bind and carve {bound}")
    mesh = ex.carve_mesh(device)
    check(mesh.shape == {"dp": 2, "tp": 4} and len(mesh.devices) == 8
          and len(set(mesh.devices)) == 1 and mesh.devices[0].type == device.type,
          f"examples e2e: mesh {mesh}")
    out.update(bound=bound, mesh={"shape": mesh.shape, "devices": [str(d) for d in mesh.devices]},
               head_dim=model.head_dim, dtype=model.dtype)
    cfg = TrainConfig(model=model)
    fa.reset_launch_counts()
    t = time.perf_counter()
    params, losses = ex.train_on_mesh(cfg, mesh, say=say)
    out["train_s"] = time.perf_counter() - t
    out["flash_launches"] = dict(fa.LAUNCHES)
    out["flash_routes"] = {n: dict(r) for n, r in fa.ROUTE_LAUNCHES.items()}
    check(len(losses) == ex.STEPS and all(np.isfinite(losses)),
          f"examples e2e: losses {losses}")
    if cuda:
        # One launch of each kernel a layer, a mesh position and a step.
        want = {n: model.layers * len(mesh.devices) * ex.STEPS for n in FLASH_KERNELS}
        check(out["flash_launches"] == want,
              f"examples e2e: flash launches {out['flash_launches']}, want {want}")
        for name in FLASH_KERNELS:
            check_routes(out["flash_routes"], name, "mma", "examples e2e")
    with plain_flash():
        _, plain = ex.train_on_mesh(cfg, ex.carve_mesh(device), say=lambda _: None)
    out["losses"], out["plain_losses"] = losses, plain
    out["loss_rel"] = max(abs(a - b) / abs(b) for a, b in zip(losses, plain))
    check(out["loss_rel"] <= EXAMPLES_LOSS_RTOL,
          f"examples e2e: kernel losses {losses} against plain {plain}: "
          f"{out['loss_rel']} > {EXAMPLES_LOSS_RTOL}")
    pa.reset_launch_counts()
    t = time.perf_counter()
    tokens = ex.serve_trained(params, model, device, say=say)
    out["serve_s"] = time.perf_counter() - t
    out["paged_launches"] = dict(pa.LAUNCHES)
    out["paged_routes"] = {n: dict(r) for n, r in pa.ROUTE_LAUNCHES.items()}
    check(len(tokens) == ex.MAX_NEW and all(0 <= x < model.vocab for x in tokens),
          f"examples e2e: served {tokens}")
    if cuda:
        check_routes(out["paged_routes"], "paged_decode_attention", "split", "examples e2e")
        check(out["paged_launches"]["paged_window_attention"] > 0,
              f"examples e2e: window launches {out['paged_launches']}")
    out["tokens"] = tokens
    out["oracle"] = TeacherForced(torch, params.gather(), model, (8, 16, 32), device)(
        [ex.PROMPT], [tokens], model.dtype)
    check_logits(out["oracle"], "examples e2e")
    return out


def examples_sharing(torch, device, small):
    """run_local_torch's `run_point` at 1/3/5/7 clients in both modes on
    YOLOS-small at its defaults (bf16, seed-0 weights; a one-layer 32 px
    model for a rehearsal): every served result held against its image
    alone (vit_agreement within VIT_TOL), the shared mode's SliceServer
    batching (requests per batch above 1 from 3 clients on), the means
    printed beside upstream nos's A100 table, recorded, not gated."""
    from nos_tpu_torch.models.vit import init_vit

    rl = load_script("examples/sharing-comparison/run_local_torch.py", "run_local_torch")
    cfg = vit_model("bfloat16", small)
    params = init_vit(cfg, torch.Generator().manual_seed(0), device=device)
    rows = {}
    for mode in ("shared", "sequential"):
        for n in EXAMPLES_WORKLOADS:
            t = time.perf_counter()
            point = rl.run_point(cfg, params, n, mode, device)
            what = f"examples sharing {mode} N={n}"
            agree = vit_agreement(torch, point["results"],
                                  vit_alone(torch, cfg, params, point["images"]), cfg.dtype,
                                  VIT_TOL[cfg.dtype], what)
            if mode == "shared" and n >= 3:
                check(point["requests_per_batch"] > 1,
                      f"{what}: {point['requests_per_batch']} requests a batch")
            rows.setdefault(n, {})[mode] = {
                "mean_s": point["mean_s"], "batches_run": point["batches_run"],
                "requests_served": point["requests_served"],
                "requests_per_batch": point["requests_per_batch"],
                "max_score_err": agree["max_score_err"], "max_box_err": agree["max_box_err"],
                "label_mismatches": agree["label_mismatches"],
                "point_s": time.perf_counter() - t}
    log(f"examples sharing: {card_line(torch, device)}; mean s a request, this port beside "
        "upstream nos's published A100 table (BASELINE.md)")
    log(f"{'N':>3} {'shared':>10} {'sequential':>10} {'A100 MPS':>9} {'A100 MIG':>9} "
        f"{'A100 t-slice':>12}")
    for n, r in rows.items():
        log(f"{n:>3} {r['shared']['mean_s']:>10.4f} {r['sequential']['mean_s']:>10.4f} "
            + " ".join(f"{rl.REFERENCE[k][n]:>{w}.4f}"
                       for k, w in (("mps", 9), ("mig", 9), ("time-slicing", 12))))
    return {"model": dataclasses.asdict(cfg), "rows": rows, "reference_a100": rl.REFERENCE}


def phase_examples(torch, device, small=False):
    """The end-to-end example and the sharing sweep (see the module
    docstring), then, on the card, the flash kernels timed at head_dim 16
    (FLASH_D16)."""
    t0 = time.perf_counter()
    out = {"card": card_line(torch, device)}
    out["e2e"] = examples_end_to_end(torch, device)
    out["sharing"] = examples_sharing(torch, device, small)
    if device.type == "cuda":
        out["flash_d16"] = {"x".join(map(str, shape[:4])): time_flash(torch, shape)
                            for shape in FLASH_D16}
    out["phase_s"] = time.perf_counter() - t0
    log("examples: " + json.dumps(out))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="build,card,kernels,experts,engine,graph,tp,radix,spec,quant,faults,"
                            "quota,trace,fleet,disagg,dense,train,vit,mesh,control,topology,"
                            "partition,schedule,lint,examples")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny model on the CPU through the plain versions; no result line")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    try:
        import nos_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the repository root (nos_tpu_torch not found)",
              file=sys.stderr)
        return 2
    if args.rehearse:
        phase_experts(torch, torch.device("cpu"), small=True)
        check_logits(phase_engine(torch, torch.device("cpu"), "float32", small=True), "engine")
        phase_graph(torch, torch.device("cpu"), small=True)
        phase_tp(torch, torch.device("cpu"), small=True)
        phase_radix(torch, torch.device("cpu"), small=True)
        phase_spec(torch, torch.device("cpu"), small=True)
        phase_quant(torch, torch.device("cpu"), small=True)
        phase_faults(torch, torch.device("cpu"), small=True)
        phase_quota(torch, torch.device("cpu"), small=True)
        phase_trace(torch, torch.device("cpu"), small=True)
        phase_fleet(torch, torch.device("cpu"), small=True)
        phase_disagg(torch, torch.device("cpu"), small=True)
        phase_dense(torch, torch.device("cpu"), small=True)
        phase_train(torch, torch.device("cpu"), full=False)
        phase_vit(torch, torch.device("cpu"), small=True)
        phase_mesh(torch, torch.device("cpu"), small=True)
        phase_control(torch, torch.device("cpu"), small=True)
        phase_topology(torch, torch.device("cpu"), small=True)
        phase_partition(torch, torch.device("cpu"))
        phase_schedule(torch, torch.device("cpu"), small=True)
        phase_lint(torch, torch.device("cpu"))
        phase_examples(torch, torch.device("cpu"), small=True)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    phases = args.phases.split(",")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    if "build" in phases:
        phase_build()
    if "card" in phases:
        phase_card(torch)
    worst, timings = None, None
    if "kernels" in phases:
        worst, timings = phase_kernels(torch)
    if "experts" in phases:
        phase_experts(torch, torch.device("cuda"))
    engine = None
    if "engine" in phases:
        engine = phase_engine(torch, torch.device("cuda"), "bfloat16")
        engine_f32 = phase_engine(torch, torch.device("cuda"), "float32")
        check_logits(engine, "engine")
        check_logits(engine_f32, "engine")
    graph = None
    if "graph" in phases:
        graph = phase_graph(torch, torch.device("cuda"))
    tp = None
    if "tp" in phases:
        tp = phase_tp(torch, torch.device("cuda"))
    radix = spec = None
    if "radix" in phases:
        radix = phase_radix(torch, torch.device("cuda"))
    if "spec" in phases:
        spec = phase_spec(torch, torch.device("cuda"))
    quant = None
    if "quant" in phases:
        quant = phase_quant(torch, torch.device("cuda"))
    faults = None
    if "faults" in phases:
        faults = phase_faults(torch, torch.device("cuda"))
    quota = trace = None
    if "quota" in phases:
        quota = phase_quota(torch, torch.device("cuda"))
    if "trace" in phases:
        trace = phase_trace(torch, torch.device("cuda"))
    fleet = None
    if "fleet" in phases:
        fleet = phase_fleet(torch, torch.device("cuda"))
    disagg = None
    if "disagg" in phases:
        disagg = phase_disagg(torch, torch.device("cuda"))
    dense = None
    if "dense" in phases:
        dense = phase_dense(torch, torch.device("cuda"))
    train = None
    if "train" in phases:
        train = phase_train(torch, torch.device("cuda"))
    vit = mesh = None
    if "vit" in phases:
        vit = phase_vit(torch, torch.device("cuda"))
    if "mesh" in phases:
        mesh = phase_mesh(torch, torch.device("cuda"))
    control = None
    if "control" in phases:
        control = phase_control(torch, torch.device("cuda"))
    topology = None
    if "topology" in phases:
        topology = phase_topology(torch, torch.device("cuda"))
    partition = None
    if "partition" in phases:
        partition = phase_partition(torch, torch.device("cuda"))
    schedule = None
    if "schedule" in phases:
        schedule = phase_schedule(torch, torch.device("cuda"))
    lint = None
    if "lint" in phases:
        lint = phase_lint(torch, torch.device("cuda"))
    examples = None
    if "examples" in phases:
        examples = phase_examples(torch, torch.device("cuda"))
    log(f"total_s={time.perf_counter() - t0:.1f}")
    if None in (worst, engine, graph, tp, radix, spec, quant, faults, quota, trace, fleet,
                disagg, dense, train, vit, mesh, control, topology, partition, schedule,
                lint, examples):
        return 0
    launches = dict(engine["launches"], **dense["bfloat16"]["launches"],
                    **train["timed"]["launches"])
    launches.update({n: tp["bfloat16"]["tp2"]["launches"][n] for n in SHARDED})
    for name in ("paged_decode_attention", "paged_window_attention", "decode_attention") \
            + FLASH_KERNELS + SHARDED:
        check(launches.get(name, 0) > 0, f"{name} never launched on the main path")
    # The route each kernel's main-path launches took; check_routes held the
    # decode kernels to "split" and the bf16 windows and flash kernels to
    # "mma" in their phases.
    by_route = dict(engine["routes"], **train["timed"]["routes"],
                    **dense["bfloat16"]["routes"])
    by_route.update({n: tp["bfloat16"]["tp2"]["routes"][n] for n in SHARDED})
    kernel_route = {}
    for name, counts in by_route.items():
        used = [r for r, n in counts.items() if n > 0]
        check(len(used) <= 1, f"{name}: main-path launches on more than one route {counts}")
        kernel_route[name] = used[0] if used else None
    main_key = {"paged_decode_attention": "decode_main",
                "paged_window_attention": "window_main"}
    replaces = {"paged_decode_attention": "nos_tpu/ops/paged_attention.py:62",
                "paged_window_attention": "nos_tpu/ops/paged_attention.py:288"}
    kernels = []
    for name in ("paged_decode_attention", "paged_window_attention"):
        t = timings[main_key[name]]
        kernels.append({
            "name": name, "route": "cuda", "kernel_route": kernel_route[name],
            "source": "nos_tpu_torch/ops/csrc/paged_attention.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": worst[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            # The quota phase's own main path (its traced bf16 arm), by route.
            "quota_launches": quota["main"]["routes"][name],
            # The fleet phase's bf16 serving arms (every replica), by route.
            "fleet_launches": fleet["main"]["routes"][name],
            # The disagg phase's bf16 cells (every engine), by route, and the
            # kernel held and timed at the 32k cell's shape.
            "disagg_launches": disagg["main"]["routes"][name],
            "disagg_32k": disagg["kernels_32k"][
                "decode" if name == "paged_decode_attention" else "window"],
            # The end-to-end example's serving act (head_dim 16), by route.
            "examples_launches": examples["e2e"]["paged_routes"][name],
        })
    flash_replaces = {"flash_fwd": "nos_tpu/ops/flash_attention.py:77",
                      "flash_bwd_dq": "nos_tpu/ops/flash_attention.py:234",
                      "flash_bwd_dkv": "nos_tpu/ops/flash_attention.py:287"}
    for name in FLASH_KERNELS:
        t = timings[name]
        entry = {
            "name": name, "route": "cuda", "kernel_route": kernel_route[name],
            "source": "nos_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": flash_replaces[name], "launches": launches[name],
            "max_abs_err": worst[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            # The vit phase's flash arm (served at 512 px) and the mesh
            # phase's sharded train step (dp 2 x tp 2), by route.
            "vit_launches": vit["flash"]["routes"][name],
            "mesh_launches": mesh["dp2_tp2"]["routes"][name],
            # The end-to-end example's training act (dp 2 x tp 4, head_dim 16
            # padded to 64), by route, and the kernel timed at head_dim 16.
            "examples_launches": examples["e2e"]["flash_routes"][name],
            "d16": {key: {k: t16[name][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "tflops")}
                for key, t16 in examples["flash_d16"].items()},
        }
        if name == "flash_fwd":
            entry["vit_1124"] = {k: vit["flash"]["kernel"][k] for k in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err", "tflops")}
        kernels.append(entry)
    t = timings["dense_main"]
    kernels.append({
        "name": "decode_attention", "route": "cuda",
        "kernel_route": kernel_route["decode_attention"],
        "source": "nos_tpu_torch/ops/csrc/decode_attention.cu",
        "replaces": "nos_tpu/ops/decode_attention.py:46",
        "launches": launches["decode_attention"],
        "max_abs_err": worst["decode_attention"], "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
    })
    for name, key in zip(SHARDED, ("decode", "window")):
        t = tp["times"][key]
        kernels.append({
            "name": name, "route": "cuda", "kernel_route": kernel_route[name],
            "source": "nos_tpu_torch/ops/csrc/paged_attention.cu",
            "replaces": SHARDED_REPLACES[name], "launches": launches[name],
            "max_abs_err": tp["kernels"][name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    # The int8 routes: launches from the int8 engine's bf16 serving run (the
    # tp=2 int8 run in f32 for the sharded entry points), the route each
    # took, and the int8 kernels' checks and times at the same shapes, with
    # a bf16 q (`timed_route`: the sharded window's timed launches take
    # "mma", its f32 engine launches "simt").
    q_launches = dict(quant["bfloat16"]["serving"]["launches"])
    q_routes = dict(quant["bfloat16"]["serving"]["routes"])
    q_launches.update({n: quant["float32"]["tp2"]["launches"][n] for n in SHARDED})
    q_routes.update({n: quant["float32"]["tp2"]["routes"][n] for n in SHARDED})
    for name, key in zip(QUANT_NAMES, ("decode_main", "window_main", "decode_sharded",
                                       "window_sharded")):
        t = quant["times"][key]
        used = [r for r, n in q_routes[name].items() if n > 0]
        check(q_launches[name] > 0 and len(used) == 1,
              f"{name} int8: launches {q_launches[name]} by route {q_routes[name]}")
        entry = {
            "name": name, "pool": "int8", "route": "cuda", "kernel_route": used[0],
            "source": "nos_tpu_torch/ops/csrc/paged_attention.cu",
            "replaces": dict(replaces, **SHARDED_REPLACES)[name],
            "launches": q_launches[name], "max_abs_err": quant["kernels"][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "timed_route": t.get("route", "split"),
        }
        if name == "paged_window_attention":
            entry["verify_w9"] = {k: quant["times"]["window_verify"][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        kernels.append(entry)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
