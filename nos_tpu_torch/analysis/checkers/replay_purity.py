"""Port of `nos_tpu/analysis/checkers/replay_purity.py:1` (:1-167). Copied near
verbatim; the imports point at the port, which imports nothing of the JAX
package. `_impurity` (:135) also counts torch's global generator as a global
RNG, as the port's NOS009 does.

NOS021 — the replay/classification plane must stay deterministic.

The fleet plane's post-hoc surfaces — `FleetMonitor.replay` (reconstructing
a window from recorded reports) and the `classify_*` family (labeling a
replica/tenant state from a snapshot) — exist so an incident can be
re-analyzed offline and produce the SAME verdict the live run produced.
That guarantee dies quietly the moment anything in their call closure reads
a clock, draws from a global RNG, or pokes a live replica: the replay
stops being a function of its recorded inputs and becomes a function of
"when you ran it", which is exactly the class of bug that makes incident
forensics unreproducible (docs/robustness.md: classify from the snapshot,
not the wall clock).

This is the first checker that NEEDS the whole-tree call graph: the
closure crosses module boundaries (`replay` -> utilization helpers ->
accounting), so a per-file walk cannot see the violation. Mechanics:

  - roots: every function/method in `nos_tpu_torch/serving/` named ``replay`` or
    ``classify_*``;
  - closure: `CallGraph.reachable_from(roots)` over the WHOLE tree;
  - banned inside the closure, flagged at the call site:
      * wall clocks — ``time.time/monotonic/perf_counter/time_ns/
        monotonic_ns/process_time`` and ``time.sleep``, ``datetime.*.now/
        utcnow/today`` (replay must consume recorded timestamps);
      * global RNG draws — ``random.*`` and ``numpy.random.*`` module-level
        calls, and torch's global generator (``torch.rand*``/``randn*``/
        ``randint*``/``randperm``/``multinomial``/``bernoulli``/``normal``
        without ``generator=``, ``torch.manual_seed``); an explicit
        ``torch.Generator`` is keyed and explicit, so it stays legal;
      * live-surface calls — probing replicas or mutating shared telemetry
        (``probe``, ``tenant_probe``, ``supervised_call``,
        ``collect_serving``, ``set_gauge``, ``remove_gauge``, ``inc``,
        ``observe``): replay must never touch the live fleet it is
        replaying.

Findings land on the offending call line in whatever module it lives in —
the message names the root that pulls it onto the replay path.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from nos_tpu_torch.analysis.callgraph import CallGraph, FuncInfo, _dotted_name
from nos_tpu_torch.analysis.checkers.trace_safety import _TORCH_DRAWS, _TORCH_RESEEDS
from nos_tpu_torch.analysis.core import Checker, FileContext, Report

#: Fully-resolved dotted calls that read the wall clock (or block on it).
_CLOCK_CALLS = {
    "time.time",
    "time.time_ns",
    "time.monotonic",
    "time.monotonic_ns",
    "time.perf_counter",
    "time.perf_counter_ns",
    "time.process_time",
    "time.sleep",
}

#: datetime constructors that capture "now" rather than a recorded instant.
_DATETIME_NOW = {"now", "utcnow", "today"}

#: Module prefixes whose call draws from a process-global RNG stream.
_GLOBAL_RNG_PREFIXES = ("random.", "numpy.random.")

#: Method/function names that touch the live fleet surface: replica probes,
#: supervised dispatch, and shared-registry telemetry mutation.
_LIVE_SURFACE = {
    "probe",
    "tenant_probe",
    "supervised_call",
    "collect_serving",
    "set_gauge",
    "remove_gauge",
    "inc",
    "observe",
}

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _is_replay_root(info: FuncInfo) -> bool:
    if "serving" not in info.rel.split("/")[:-1]:
        return False
    return info.name == "replay" or info.name.startswith("classify_")


class ReplayPurityChecker(Checker):
    name = "replay-purity"
    codes = ("NOS021",)
    description = "replay/classify closure must not read clocks, global RNG, or live state"
    cross_file = True  # closure crosses module boundaries by design

    def __init__(self) -> None:
        self._graph: Optional[CallGraph] = None

    def begin_run(self, graph: CallGraph) -> None:
        self._graph = graph

    def finish(self, report: Report) -> None:
        graph = self._graph
        if graph is None:
            return
        roots = [info.qname for info in graph.functions() if _is_replay_root(info)]
        if not roots:
            return
        root_names = sorted({graph.nodes[q].name for q in roots})
        via = "/".join(root_names)
        for qname in sorted(graph.reachable_from(roots)):
            info = graph.nodes[qname]
            aliases = graph.modules[info.rel].aliases
            self._scan_function(info, aliases, via, report)

    # -- one closure member --------------------------------------------------
    def _scan_function(
        self,
        info: FuncInfo,
        aliases: Dict[str, str],
        via: str,
        report: Report,
    ) -> None:
        label = f"{info.cls}.{info.name}" if info.cls else info.name
        for node in ast.walk(info.node):
            if not isinstance(node, ast.Call):
                continue
            reason = self._impurity(node, aliases)
            if reason is None:
                continue
            report.add(
                info.rel,
                node.lineno,
                "NOS021",
                f"replay purity: '{label}' is reachable from the replay/"
                f"classification roots ({via}) but {reason}; replay must be "
                "a pure function of the recorded reports",
            )

    def _impurity(self, call: ast.Call, aliases: Dict[str, str]) -> Optional[str]:
        fn = call.func
        dotted = _dotted_name(fn)
        resolved = self._resolve(dotted, aliases)
        if resolved is not None:
            if resolved in _CLOCK_CALLS:
                return f"reads the wall clock via {resolved}()"
            head, _, last = resolved.rpartition(".")
            if resolved.startswith(_GLOBAL_RNG_PREFIXES):
                return f"draws from the global RNG via {resolved}()"
            torch_fn = resolved[len("torch."):] if resolved.startswith("torch.") else None
            if torch_fn in _TORCH_RESEEDS or (
                torch_fn in _TORCH_DRAWS
                and not any(kw.arg == "generator" for kw in call.keywords)
            ):
                return f"draws from the global RNG via {resolved}()"
            if (
                last in _DATETIME_NOW
                and (head == "datetime" or head.startswith("datetime."))
            ):
                return f"captures the current time via {resolved}()"
        if isinstance(fn, ast.Attribute) and fn.attr in _LIVE_SURFACE:
            # Receiver-typed live surfaces: self._engines[r].probe(),
            # metrics.inc(...), supervisor.supervised_call(...).
            return f"touches the live fleet surface via .{fn.attr}()"
        if isinstance(fn, ast.Name) and fn.id in _LIVE_SURFACE:
            return f"touches the live fleet surface via {fn.id}()"
        return None

    def _resolve(
        self, dotted: Optional[str], aliases: Dict[str, str]
    ) -> Optional[str]:
        """Expand the leading alias of an `a.b.c` call through the module's
        import table ('np.random.rand' -> 'numpy.random.rand')."""
        if dotted is None:
            return None
        head, _, rest = dotted.partition(".")
        base = aliases.get(head, head)
        return f"{base}.{rest}" if rest else base
