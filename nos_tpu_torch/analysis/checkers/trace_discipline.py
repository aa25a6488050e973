"""Port of `nos_tpu/analysis/checkers/trace_discipline.py:1` (:1-215). Copied
near verbatim; the imports point at the port, which imports nothing of the
JAX package.

NOS014 — tracing event names and recorder state outside their APIs.

The serving plane has a tracing layer (nos_tpu_torch/tracing.py,
docs/tracing.md): request-lifecycle span events, a per-engine
flight-recorder ring, and postmortem dumps, all keyed by the event-name
vocabulary in `constants.py` (TRACE_EVENTS / FLIGHT_EVENTS). Two drift
classes threaten it, and this checker applies the two disciplines the
suite already enforces elsewhere to the new surface:

  1. **Event-name literals outside constants.py** (the NOS001 argument):
     `/debug/*` consumers, the bench `trace_timeline` artifact, and
     postmortem tooling all match on these strings — a name spelled
     inline (`tracer.event(tid, "req.finish")`) drifts exactly like a
     mistyped annotation, and the trace silently grows an event nothing
     downstream recognizes. Any string literal equal to a registered
     span/flight event name outside `constants.py` is flagged
     (docstrings exempt — prose may quote the taxonomy).

  2. **Recorder/trace-store writes outside the owning class** (the
     NOS011/NOS013 argument): the Tracer's bounded trace store
     (`_traces`) and the FlightRecorder's ring and postmortem deques
     (`_ring`, `_postmortems`) keep their capacity bounds and
     count/sequence invariants only if every mutation funnels through
     the class. A stray `recorder._ring.append(...)` in engine code
     bypasses the sequence numbering and the capacity cap — the
     unbounded-growth bug the ring exists to prevent. Any WRITE
     (assignment, deletion, augmented assignment, or mutating call) to
     these attributes outside the `Tracer`/`FlightRecorder` class bodies
     is flagged, on ANY receiver; reads stay legal everywhere (the
     /debug endpoints and tests may inspect).

Scope: the whole walked tree — the tracing surface spans runtime/,
serving/, observability.py, and tracing.py itself.

The fleet pressure plane (serving/monitor.py, docs/fleet-monitor.md)
extends the vocabulary twice over:

  3. **Fleet/SLO event names** (`constants.FLEET_EVENTS`: the journal's
     `fleet.window`/`fleet.freeze` lines and the SLO tracker's
     `slo.breach`/`slo.recover` flips) join the event-name discipline
     everywhere — journal replay and /debug/pressure consumers match on
     them exactly like span names.

  4. **Pressure-state literals** (`constants.PRESSURE_*`: the
     `hot/ok/idle/draining` replica verdicts and the
     `starved/borrowing/within` tenant verdicts) are flagged in the
     SERVING-PLANE surface only — any `serving/` directory plus
     observability.py and telemetry.py. These are ordinary English
     words with legitimate unrelated uses elsewhere (leader-election
     status strings, the slot phase machine's "idle"), so the
     discipline is scoped to where the pressure protocol actually
     lives rather than banning the words tree-wide.
"""

from __future__ import annotations

import ast

from nos_tpu_torch import constants
from nos_tpu_torch.analysis.core import Checker, FileContext, Report

#: The registered span + flight-recorder + fleet/SLO event vocabulary.
#: Sourced from constants at import time, so adding an event name there
#: automatically extends the discipline to it.
_EVENT_NAMES = (
    frozenset(constants.TRACE_EVENTS)
    | frozenset(constants.FLIGHT_EVENTS)
    | frozenset(constants.FLEET_EVENTS)
)

#: Pressure verdict vocabulary (replica + tenant states), flagged only
#: inside the serving-plane scope below.
_STATE_NAMES = frozenset(constants.PRESSURE_REPLICA_STATES) | frozenset(
    constants.PRESSURE_TENANT_STATES
)

#: Where the pressure-state vocabulary is enforced: any path with a
#: `serving` directory segment, plus the exposition/aggregation modules
#: that serialize the verdicts.
_STATE_SCOPE_BASENAMES = frozenset({"observability.py", "telemetry.py"})

_PROTECTED = frozenset({"_traces", "_ring", "_postmortems"})

_MUTATORS = frozenset(
    {
        "append",
        "appendleft",
        "extend",
        "insert",
        "remove",
        "pop",
        "popleft",
        "popitem",
        "clear",
        "update",
        "setdefault",
        "move_to_end",
        "add",
        "discard",
        "sort",
        "reverse",
    }
)

_OWNERS = frozenset({"Tracer", "FlightRecorder"})


def _protected_attr(node: ast.AST):
    """The protected attribute name a write target resolves to, if any —
    unwrapping subscript chains so `rec._ring[0]` and
    `tracer._traces[tid]` both resolve to their backing attribute."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and node.attr in _PROTECTED:
        return node.attr
    return None


class TraceDisciplineChecker(Checker):
    name = "trace-discipline"
    codes = ("NOS014",)
    description = (
        "tracing event-name literals outside constants.py / recorder state "
        "mutated outside the Tracer|FlightRecorder API"
    )

    def __init__(self) -> None:
        self._active = False
        self._state_scope = False

    def begin_file(self, ctx: FileContext) -> None:
        self._active = ctx.basename != "constants.py"
        self._state_scope = self._active and (
            "serving" in ctx.segments[:-1]
            or ctx.basename in _STATE_SCOPE_BASENAMES
        )

    def _flag_write(
        self, ctx: FileContext, node: ast.AST, attr: str, how: str, report: Report
    ) -> None:
        report.add(
            ctx.rel,
            node.lineno,
            "NOS014",
            f"tracing state `{attr}` {how} outside the Tracer/FlightRecorder "
            "API; route the mutation through an event()/record()/dump() "
            "method so the ring's capacity bound and sequence numbering "
            "stay enforceable in one place",
        )

    def visit(self, ctx: FileContext, node: ast.AST, report: Report) -> None:
        if not self._active:
            return
        # 1) Event-name literals (span/flight/fleet/SLO vocabulary).
        if (
            isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and node.value in _EVENT_NAMES
            and not ctx.is_docstring(node)
        ):
            report.add(
                ctx.rel,
                node.lineno,
                "NOS014",
                f"tracing event name {node.value!r} spelled inline outside "
                "constants.py; derive it from nos_tpu_torch.constants "
                "(TRACE_EV_*/FLIGHT_EV_*/FLEET_EV_*/SLO_EV_*) so /debug "
                "consumers and the timeline/journal artifacts cannot drift",
            )
            return
        # 1b) Pressure-state literals, serving-plane scope only.
        if (
            self._state_scope
            and isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and node.value in _STATE_NAMES
            and not ctx.is_docstring(node)
        ):
            report.add(
                ctx.rel,
                node.lineno,
                "NOS014",
                f"pressure state {node.value!r} spelled inline in the serving "
                "plane; derive it from nos_tpu_torch.constants (PRESSURE_REPLICA_*/"
                "PRESSURE_TENANT_*) so PressureReport consumers and the "
                "metrics journal cannot drift",
            )
            return
        # 2) Recorder/trace-store writes outside the owning classes.
        cls = ctx.enclosing(ast.ClassDef)
        if cls is not None and cls.name in _OWNERS:
            return
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for target in targets:
                # Tuple/list unpacking targets hide writes one level down.
                parts = (
                    target.elts if isinstance(target, (ast.Tuple, ast.List)) else [target]
                )
                for part in parts:
                    attr = _protected_attr(part)
                    if attr is not None:
                        self._flag_write(ctx, node, attr, "assigned", report)
        elif isinstance(node, ast.Delete):
            for target in node.targets:
                attr = _protected_attr(target)
                if attr is not None:
                    self._flag_write(ctx, node, attr, "deleted", report)
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in _MUTATORS:
                attr = _protected_attr(node.func.value)
                if attr is not None:
                    self._flag_write(
                        ctx, node, attr, f"mutated via .{node.func.attr}()", report
                    )
