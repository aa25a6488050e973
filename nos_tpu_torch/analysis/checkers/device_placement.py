"""Port of `nos_tpu/analysis/checkers/device_placement.py:1` (:1-115), its
rule rewritten for PyTorch: `_is_device_list` (:101) and `_placed_put`
(:107) become torch's explicit-device spellings in place of
`jax.devices()[i]` and `jax.device_put(x, dev)`. The scope, the tick-path
region and the message are the reference's.

NOS016 — per-device placement on the serving engine's tick path.

Tensor-parallel decode made device placement a FIRST-CLASS property of
the engine: params and the paged KV pool are placed ONCE at construction
(`parallel/sharding.py` `shard_params`, one tree per shard of the mesh),
the engine keeps its device as `self.device` and each shard's pool on
its mesh device, and every tick-path upload goes through the counted
`HostStage` funnel. Code that reaches for a SPECIFIC device on the tick
path hard-wires a single-device topology into the engine: under a tp
mesh it silently pins data to one shard's card (wrong results or a
cross-device copy storm), and it bypasses both the mesh and the h2d
budget. The explicit-device spellings:

  - a literal `"cuda:N"` (or `f"cuda:{i}"`) handed to a call — `.to`,
    `torch.device`, a factory's `device=` — and `torch.device("cuda", N)`;
  - `torch.cuda.set_device(...)`, and `torch.cuda.device(N)` or `.cuda(N)`
    with a literal index;
  - indexing or iterating over `torch.cuda.device_count()`
    (`range(torch.cuda.device_count())`).

The engine's own `self.device` and a shard's device read off its tensors
stay legal, as does `torch.cuda.device(device)` around the capture;
`torch.cuda.device_count()` alone is topology INSPECTION and stays legal.

Scope: identical to NOS010/NOS015 — files under `runtime/` containing
an ENGINE class (a class defining `_tick`); flagged regions come from
the shared call graph's `tick_scope` (everything in the file reachable
from the `_tick`/`_run` roots, plus every method of helper classes in the
same file). Genuinely sanctioned sites carry `# nos-lint: ignore[NOS016]`
with a rationale.
"""

from __future__ import annotations

import ast
from typing import Dict, Optional, Set

from nos_tpu_torch.analysis.callgraph import CallGraph, tick_scope
from nos_tpu_torch.analysis.core import Checker, FileContext, Report
from nos_tpu_torch.analysis.checkers.trace_safety import _dotted

_DEVICE_COUNT = "torch.cuda.device_count"
_SET_DEVICE = "torch.cuda.set_device"
_DEVICE_CTX = "torch.cuda.device"
_DEVICE = "torch.device"


def _indexed_cuda(node: ast.AST) -> bool:
    """A literal "cuda:N", or an f-string that starts "cuda:"."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.startswith("cuda:")
    if isinstance(node, ast.JoinedStr) and node.values:
        head = node.values[0]
        return (isinstance(head, ast.Constant) and isinstance(head.value, str)
                and head.value.startswith("cuda:"))
    return False


class DevicePlacementChecker(Checker):
    name = "device-placement"
    codes = ("NOS016",)
    description = "per-device placement on the engine tick path"

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
        if not self._active:
            return
        reason: Optional[str] = None
        if isinstance(node, ast.Subscript) and self._counts_devices(node.slice):
            reason = "indexing by torch.cuda.device_count() pins one physical device"
        elif isinstance(node, ast.Call):
            reason = self._placed_call(node)
        if reason is None:
            return
        enclosing = ctx.enclosing_all(ast.FunctionDef, ast.AsyncFunctionDef)
        if not any(f in self._scope_funcs for f in enclosing):
            return
        report.add(
            ctx.rel,
            node.lineno,
            "NOS016",
            f"per-device placement on the engine tick path: {reason}; "
            "place via mesh shardings (parallel/sharding.py) at "
            "construction or route uploads through HostStage.to_device "
            "(runtime/staging.py)",
        )

    def _resolve(self, func) -> Optional[str]:
        dotted = _dotted(func)
        if dotted is None:
            return None
        head, _, rest = dotted.partition(".")
        module = self._aliases.get(head, head)
        return f"{module}.{rest}" if rest else module

    def _counts_devices(self, node: ast.AST) -> bool:
        return any(
            isinstance(n, ast.Call) and self._resolve(n.func) == _DEVICE_COUNT
            for n in ast.walk(node)
        )

    def _placed_call(self, node: ast.Call) -> Optional[str]:
        full = self._resolve(node.func)
        if full == _SET_DEVICE:
            return "torch.cuda.set_device() pins the thread to one physical device"
        if full == "range" and any(self._counts_devices(a) for a in node.args):
            return ("iterating range(torch.cuda.device_count()) pins each "
                    "physical device by index")
        if full == _DEVICE and (
            (len(node.args) >= 2)
            or any(kw.arg == "index" for kw in node.keywords)
        ):
            return "torch.device('cuda', N) targets one physical device"
        if full == _DEVICE_CTX or (
            isinstance(node.func, ast.Attribute) and node.func.attr == "cuda"
        ):
            index = node.args[0] if node.args else None
            if isinstance(index, ast.Constant) and isinstance(index.value, int):
                what = "torch.cuda.device(N)" if full == _DEVICE_CTX else ".cuda(N)"
                return f"{what} targets one physical device"
        targets = list(node.args) + [kw.value for kw in node.keywords
                                     if kw.arg == "device"]
        if any(_indexed_cuda(a) for a in targets):
            return "a literal 'cuda:N' targets one physical device"
        return None
