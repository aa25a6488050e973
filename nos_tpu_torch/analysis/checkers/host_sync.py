"""Port of `nos_tpu/analysis/checkers/host_sync.py:1` (:1-103), its rule
rewritten for PyTorch: `_BLOCKING` (:35) and `_blocking_reason` (:90)
name torch's blocking reads in place of `jax.device_get`, `np.asarray`
and `.block_until_ready()`. The scope, the tick-path region and the
message are the reference's.

NOS010 — blocking host sync on the serving engine's tick path.

The DecodeServer's whole design is that the tick NEVER waits on the device:
tokens ride device-resident (`_TokRef`, copied to pinned host memory behind
an event), verify reads pipeline behind macro dispatches, and prefill
scatters its first token on device. One stray `.item()`, `.tolist()`,
`.cpu()`, `.numpy()`, `np.asarray(tensor)`/`np.array(tensor)`,
`torch.cuda.synchronize()`, or an event's or a stream's `.synchronize()`
inside a tick-path method re-introduces the synchronous device->host round
trip the engine is built to avoid: each such call drains the stream
before the host can queue the next window.

Scope: files under `runtime/` that contain an ENGINE class (a class
defining `_tick`). Flagged regions come from the shared call graph
(analysis/callgraph.py `tick_scope`): everything in the file reachable
from the engine classes' `_tick`/`_run` roots — `self.method()` calls,
module-level helpers and same-file cross-class calls — plus every method
of helper classes in the same file (helpers like `_TokRef` exist to be
called from the tick, so they are tick-path by construction).
Client-side methods like `submit`/`generate` are off the tick path and
stay legal; move genuinely client-side helpers to another module or
suppress inline. Sanctioned sites (the ONE deliberate materialization
point; `np.asarray` over a host-side list) carry
`# nos-lint: ignore[NOS010]` with a rationale.
"""

from __future__ import annotations

import ast
from typing import Dict, Optional, Set

from nos_tpu_torch.analysis.callgraph import CallGraph, tick_scope
from nos_tpu_torch.analysis.core import Checker, FileContext, Report
from nos_tpu_torch.analysis.checkers.trace_safety import _dotted

_BLOCKING = {
    "numpy.asarray": "np.asarray() on a device value (synchronous "
    "device->host transfer)",
    "numpy.array": "np.array() on a device value (synchronous "
    "device->host transfer)",
    "torch.cuda.synchronize": "torch.cuda.synchronize() (waits out the "
    "whole device queue)",
}

#: Argument-free tensor methods that copy a device tensor to the host and
#: wait for it.
_BLOCKING_METHODS = {
    "item": ".item() (synchronous device->host scalar read)",
    "tolist": ".tolist() (synchronous device->host copy)",
    "cpu": ".cpu() (synchronous device->host copy)",
    "numpy": ".numpy() (a host view: a device tensor is copied to the "
    "host first)",
}


class HostSyncChecker(Checker):
    name = "host-sync"
    codes = ("NOS010",)
    description = "blocking host syncs on the serving engine's tick path"

    def __init__(self) -> None:
        self._graph: Optional[CallGraph] = None
        self._active = False
        self._aliases: Dict[str, str] = {}
        self._scope_funcs: Set[ast.AST] = set()

    def begin_run(self, graph: CallGraph) -> None:
        self._graph = graph

    # -- per-file prescan ----------------------------------------------------
    def begin_file(self, ctx: FileContext) -> None:
        self._active = "runtime" in ctx.segments[:-1]
        self._aliases = {}
        self._scope_funcs = set()
        if not self._active or self._graph is None:
            return
        self._scope_funcs = tick_scope(
            self._graph, ctx.rel, engine_markers=("_tick",), include_helpers=True
        )
        if not self._scope_funcs:
            self._active = False
            return
        self._aliases = self._graph.modules[ctx.rel].aliases

    # -- visit ---------------------------------------------------------------
    def visit(self, ctx: FileContext, node: ast.AST, report: Report) -> None:
        if not self._active or not isinstance(node, ast.Call):
            return
        if not any(
            f in self._scope_funcs
            for f in ctx.enclosing_all(ast.FunctionDef, ast.AsyncFunctionDef)
        ):
            return
        reason = self._blocking_reason(node)
        if reason is not None:
            report.add(
                ctx.rel,
                node.lineno,
                "NOS010",
                f"blocking host sync on the engine tick path: {reason}; keep "
                "the read pipelined (_TokRef) or move it off the tick path",
            )

    def _blocking_reason(self, node: ast.Call):
        fn = node.func
        dotted = _dotted(fn)
        if dotted is not None:
            head, _, rest = dotted.partition(".")
            module = self._aliases.get(head, head)
            full = f"{module}.{rest}" if rest else module
            if full in _BLOCKING:
                return _BLOCKING[full]
        if isinstance(fn, ast.Attribute):
            if fn.attr in _BLOCKING_METHODS and not node.args and not node.keywords:
                return _BLOCKING_METHODS[fn.attr]
            if fn.attr == "synchronize" and not node.args:
                return ".synchronize() (blocks the host until the event or " \
                    "stream completes)"
        return None
