"""Port of `nos_tpu/sim_oracle.py:1` (:1-153): `OracleJob` (:34),
`OracleReport` (:43), `from_sim_jobs` (:65), `oracle_schedule` (:83). Copied
verbatim; only the imports point at the port, which imports nothing of the
JAX package.

Fungible-chip oracle: the queueing-theoretic floor for a trace's latency.

The north-star traces are heavily oversubscribed by design (the single-host
library trace offers ~4x the cluster's chip-seconds, the multihost true
shape ~9x), so schedule-to-running latency is dominated by queue depth, not
scheduler quality. This oracle separates the two: it replays a trace against
an idealized cluster with NO geometry (chips are fungible), NO control plane
(binds are instantaneous), NO carve latency, and perfect packing — every
loss a real scheduler could ever eliminate is eliminated. Whatever latency
remains is the work-conservation floor of the trace itself.

Uses (tests/test_simulation.py, docs/dynamic-partitioning.md):
  - Infeasibility proofs: the round-2 "single-host p95 < 120s" target is
    shown unreachable for ANY scheduler on this trace — the oracle's own
    p95 is ~748s (measured; asserted > 120 in CI).
  - Overhead bounds: the full control plane's p95 is CI-bounded as a
    multiple of the oracle's, so geometry/control-plane overhead is a
    tracked number (single-host: 979s vs 748s = 1.31x), not a vibe.

The reference has no analog — its demo harness publishes only relative
sharing numbers (demos/gpu-sharing-comparison/README.md:60-72); the oracle
is the TPU-native absolute yardstick for the *scheduling* half, as
runtime/mfu.py is for the *compute* half.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple


@dataclass(frozen=True)
class OracleJob:
    name: str
    arrival_s: float
    duration_s: float
    chips: int
    priority: int = 0


@dataclass
class OracleReport:
    policy: str
    total_chips: int
    latencies: Dict[str, float]
    makespan_s: float

    def percentile(self, q: float) -> float:
        values = sorted(self.latencies.values())
        if not values:
            return 0.0
        idx = min(len(values) - 1, int(round(q * (len(values) - 1))))
        return values[idx]

    @property
    def p50_latency_s(self) -> float:
        return self.percentile(0.50)

    @property
    def p95_latency_s(self) -> float:
        return self.percentile(0.95)


def from_sim_jobs(jobs: Sequence) -> List[OracleJob]:
    """Adapt sim.SimJob (profile-resource requests) or sim.GangJob
    (topology strings) to oracle jobs."""
    from nos_tpu_torch.tpu import Profile
    from nos_tpu_torch.tpu.profile import chips_of_resources

    out = []
    for j in jobs:
        if hasattr(j, "request"):
            chips = int(chips_of_resources(j.request))
        else:
            chips = Profile.parse(j.topology).chips
        out.append(
            OracleJob(j.name, j.arrival_s, j.duration_s, chips, j.priority)
        )
    return out


def oracle_schedule(
    jobs: Sequence[OracleJob], total_chips: int, policy: str = "fifo"
) -> OracleReport:
    """Event-driven replay: at every arrival/completion instant, bind every
    queued job that fits, scanning the queue in policy order with full
    backfill (a blocked job never blocks a fitting one behind it — matching
    the real scheduler's pass semantics, minus all of its constraints).

    policy: "fifo" orders by (-priority, arrival); "sjf" by (-priority,
    chip-seconds, arrival) — the latter is the latency-optimal-ish ordering
    the aged-swf queue policy approximates.
    """
    if policy not in ("fifo", "sjf"):
        raise ValueError(f"unknown oracle policy {policy!r}")
    oversized = [j.name for j in jobs if j.chips > total_chips]
    if oversized:
        # Silently dropping these would return percentiles over a partial
        # set — a floor computed from the wrong population.
        raise ValueError(
            f"jobs can never fit {total_chips} chips: {oversized[:5]}"
        )

    def key(j: OracleJob) -> Tuple:
        if policy == "sjf":
            return (-j.priority, j.chips * j.duration_s, j.arrival_s, j.name)
        return (-j.priority, j.arrival_s, j.name)

    arrivals = sorted(jobs, key=lambda j: (j.arrival_s, j.name))
    ai = 0
    queue: List[Tuple[Tuple, OracleJob]] = []
    completions: List[Tuple[float, int]] = []  # (time, chips freed)
    free = total_chips
    now = 0.0
    latencies: Dict[str, float] = {}

    while ai < len(arrivals) or queue or completions:
        # Advance to the next event instant.
        instants = []
        if ai < len(arrivals):
            instants.append(arrivals[ai].arrival_s)
        if completions:
            instants.append(completions[0][0])
        if not instants:
            break  # queued jobs can never fit (chips > total) — undefined
        now = max(now, min(instants))
        while ai < len(arrivals) and arrivals[ai].arrival_s <= now:
            job = arrivals[ai]
            ai += 1
            heapq.heappush(queue, (key(job), job))
        while completions and completions[0][0] <= now:
            _, chips = heapq.heappop(completions)
            free += chips
        # Bind everything that fits, policy order with backfill.
        unbindable = []
        while queue:
            k, job = heapq.heappop(queue)
            if job.chips <= free:
                free -= job.chips
                latencies[job.name] = now - job.arrival_s
                heapq.heappush(completions, (now + job.duration_s, job.chips))
            else:
                unbindable.append((k, job))
        for item in unbindable:
            heapq.heappush(queue, item)

    return OracleReport(
        policy=policy,
        total_chips=total_chips,
        latencies=latencies,
        makespan_s=now,
    )
