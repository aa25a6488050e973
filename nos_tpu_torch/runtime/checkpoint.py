"""Port of `nos_tpu/runtime/checkpoint.py` (:1-129), copied verbatim apart
from references to the reference's change history in the comments (pure
Python; the port keeps its own copy). Within the port a
checkpoint's replay runs through the engine's prefill programs on the
card: on CUDA the restored slot's KV is re-derived by the window kernel,
and the dict layout is the reference's, so a checkpoint crosses packages.

SlotCheckpoint: the host-recoverable state of one serving slot.

A decode slot's device state (its KV pages) is a pure function of its
host state: prefilling `prompt + generated` through the engine's budgeted
chunked-prefill path recomputes every page the slot had written, and the
next sampled token is the same argmax the fault-free run would have taken
(bit-identical for greedy on a deterministic backend — the replay runs
through the SAME compiled chunk/window programs a cold prompt of that
length uses, which is exactly the equality the prefix-cache exactness
oracles already pin; see docs/robustness.md for the full argument). So a
checkpoint needs only:

  - the request identity: original prompt, requested ``max_new``, the
    client's Future, submit timestamp, and the slot's sampling ``serial``
    (restores preserve the per-request PRNG stream, so temperature>0
    streams also continue exactly — serial unchanged, step offset by the
    replayed tokens);
  - the tokens generated SO FAR that are still materializable (a
    device-lost fault can strand the newest dispatches; those tokens are
    simply recomputed by the replay);
  - the speculative controller's snapshot (models/speculative.py
    AdaptiveSpec) so a restored slot re-enters with its learned
    acceptance state instead of fresh optimism;
  - the prefill cursor at capture time (observability: how much prefill
    work the fault destroyed).

Checkpoints are also TENSOR-PARALLEL-AGNOSTIC (docs/sharded-decode.md):
they hold tokens, never device state, and the
replay path re-derives KV through whatever mesh the restoring engine
runs — so a stream checkpointed on a tp=2 replica restores
bit-identically on a tp=1 replica and vice versa (the cross-tp
drain/migrate test pins the round trip).

Everything here is plain host data — `to_dict`/`from_dict` round-trip all
of it except the Future (process-local by nature), so checkpoints could
be shipped to another engine/replica; within one engine the Future rides
along and the restored request resolves the ORIGINAL client future with
``generated + replayed-continuation``.
"""

from __future__ import annotations

from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, List, Optional

#: Serialized-checkpoint schema version. Bumped whenever the dict layout
#: changes meaning (v2 added `tenant` for quota-preserving restores and
#: the version field itself — v1 is retroactively the first, unversioned
#: layout). `from_dict` REJECTS any other version up front with a clear
#: error: a stale or foreign dict used to fail deep inside restore as a
#: KeyError/TypeError long after the bad input was accepted.
CHECKPOINT_VERSION = 2


@dataclass
class SlotCheckpoint:
    """Host-recoverable state of one slot. `generated` never contains a
    token past the request's eos or budget — the engine resolves such
    requests at capture time instead of checkpointing them. `tenant`
    rides along so a preempted/restored request keeps its quota identity
    (runtime/quota.py) across the replay."""

    prompt: List[int]
    generated: List[int]
    max_new: int
    serial: int
    t_submit: float = 0.0
    prefill_cursor: int = 0
    spec: Optional[Dict[str, float]] = None
    tenant: Optional[str] = None
    # Request-lifecycle trace id (nos_tpu/tracing.py): rides the
    # checkpoint so a restored / preempted / drain-migrated stream keeps
    # ONE coherent trace across recoveries and replicas. Optional
    # observability metadata — absent (None) in pre-tracing dicts, which
    # is why it does NOT bump CHECKPOINT_VERSION: readers tolerate the
    # missing key and no existing field changed meaning.
    trace_id: Optional[str] = None
    future: Optional[Future] = field(default=None, repr=False, compare=False)

    @property
    def remaining_new(self) -> int:
        """Tokens the restored request must still produce."""
        return self.max_new - len(self.generated)

    def replay_prompt(self) -> List[int]:
        """The token sequence the restored admission prefills: the original
        prompt plus every already-generated token. Chunk boundaries and the
        first-token sample position are then exactly those of a cold prompt
        of this length."""
        return list(self.prompt) + list(self.generated)

    def to_dict(self) -> dict:
        return {
            "version": CHECKPOINT_VERSION,
            "prompt": list(self.prompt),
            "generated": list(self.generated),
            "max_new": self.max_new,
            "serial": self.serial,
            "t_submit": self.t_submit,
            "prefill_cursor": self.prefill_cursor,
            "spec": dict(self.spec) if self.spec is not None else None,
            "tenant": self.tenant,
            "trace_id": self.trace_id,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SlotCheckpoint":
        version = d.get("version")
        if version != CHECKPOINT_VERSION:
            # Fail at the boundary, not deep inside restore: an engine
            # replaying a half-understood checkpoint would corrupt the
            # very request the checkpoint exists to save.
            raise ValueError(
                f"unsupported SlotCheckpoint version {version!r} (this "
                f"engine reads version {CHECKPOINT_VERSION}); refusing a "
                "stale or foreign checkpoint dict"
            )
        return cls(
            prompt=list(d["prompt"]),
            generated=list(d["generated"]),
            max_new=int(d["max_new"]),
            serial=int(d["serial"]),
            t_submit=float(d.get("t_submit", 0.0)),
            prefill_cursor=int(d.get("prefill_cursor", 0)),
            spec=dict(d["spec"]) if d.get("spec") is not None else None,
            tenant=d.get("tenant"),
            trace_id=d.get("trace_id"),
        )
