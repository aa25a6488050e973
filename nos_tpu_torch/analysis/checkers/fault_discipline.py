"""Port of `nos_tpu/analysis/checkers/fault_discipline.py:1` (:1-128). Copied
near verbatim; the imports point at the port, which imports nothing of the
JAX package.

NOS012 — unclassified broad except on the serving tick/recovery path.

The serving engine's failure model (runtime/faults.py, docs/robustness.md)
only works if every tick-path exception actually REACHES the classifier:
poison faults must fail exactly one slot, transients must retry instead of
tearing down, device-lost must checkpoint-and-restore. A broad
`except Exception:` in the engine loop that logs-and-continues (or fails
futures directly) silently reinstates the old all-or-nothing behavior —
it *looks* handled, NOS003 is satisfied by the log call, and the taxonomy
never sees the error. That drift is invisible in tests that don't inject
faults, which is exactly why it gets its own checker.

Scope, two tiers:

  - files under `runtime/` containing an engine-loop class (a class
    defining `_tick` or `_run`): everything in the file reachable from
    the `_tick`/`_run` roots over the shared call graph
    (analysis/callgraph.py `tick_scope` — the same scope NOS010 uses,
    minus its helper-class blanket);
  - EVERY function in `nos_tpu_torch/serving/` (the fleet plane): the fleet
    loops — monitor sampling, supervisor probe sweeps, drain/failover
    re-homing, router scoring — are all cross-replica interaction
    paths, and a swallowed error there hides a replica death instead of
    reporting it (the monitor.py:738 lesson: the thread-level backstop
    masked every probe failure as a log line).

In scope, a handler for Exception/BaseException must show the error is
ROUTED, not just observed: a `raise` (re-raise or escalation), or a call
into the taxonomy/recovery/supervision machinery (`classify_fault`,
`poison_slot_of`, `self._recover(...)`, `supervised_call`). Narrow
handlers (`except RuntimeError:` around a checkpoint materialization,
`except ReplicaUnreachableError:` in a failover loop)
remain deliberate control flow; bare `except:` stays NOS004's.
Deliberately-unclassified last-resort backstops carry an inline
`# nos-lint: ignore[NOS012]` with a rationale.
"""

from __future__ import annotations

import ast
from typing import Optional, Set

from nos_tpu_torch.analysis.callgraph import CallGraph, tick_scope
from nos_tpu_torch.analysis.core import Checker, FileContext, Report
from nos_tpu_torch.analysis.checkers.exception_hygiene import _is_broad

_ROUTERS = {
    "classify_fault",
    "poison_slot_of",
    "_recover",
    "recover",
    "supervised_call",
}


def _routes_through_taxonomy(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(ast.Module(body=handler.body, type_ignores=[])):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Name) and fn.id in _ROUTERS:
                return True
            if isinstance(fn, ast.Attribute) and fn.attr in _ROUTERS:
                return True
    return False


class FaultDisciplineChecker(Checker):
    name = "fault-discipline"
    codes = ("NOS012",)
    description = "tick/recovery-path broad excepts must route through the fault taxonomy"

    def __init__(self) -> None:
        self._graph: Optional[CallGraph] = None
        self._active = False
        self._scope_funcs: Set[ast.AST] = set()

    def begin_run(self, graph: CallGraph) -> None:
        self._graph = graph

    def begin_file(self, ctx: FileContext) -> None:
        segments = ctx.segments[:-1]
        self._scope_funcs = set()
        if "serving" in segments:
            # Fleet-plane tier: the whole package is cross-replica
            # interaction surface — every function is in scope.
            self._active = True
            for node in ast.walk(ctx.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._scope_funcs.add(node)
            return
        self._active = "runtime" in segments
        if not self._active or self._graph is None:
            return
        # Same reachability NOS010 uses (shared call graph, `_tick`/`_run`
        # roots), but engine classes here include `_run`-only loop classes
        # and helper classes get no blanket: a helper's broad except is
        # only in scope when the tick actually reaches it.
        self._scope_funcs = tick_scope(
            self._graph,
            ctx.rel,
            engine_markers=("_tick", "_run"),
            include_helpers=False,
        )
        if not self._scope_funcs:
            self._active = False

    def visit(self, ctx: FileContext, node: ast.AST, report: Report) -> None:
        if not self._active or not isinstance(node, ast.ExceptHandler):
            return
        if not any(
            f in self._scope_funcs
            for f in ctx.enclosing_all(ast.FunctionDef, ast.AsyncFunctionDef)
        ):
            return
        if node.type is None:
            return  # bare except is NOS004's finding, tick path or not
        if _is_broad(node.type) and not _routes_through_taxonomy(node):
            report.add(
                ctx.rel,
                node.lineno,
                "NOS012",
                "broad except on the engine tick/recovery path bypasses fault "
                "classification; route it through the taxonomy "
                "(classify_fault/_recover) or re-raise so recovery stays "
                "surgical",
            )
