"""Port of `nos_tpu/analysis/checkers/staging_discipline.py:1` (:1-101), its
rule rewritten for PyTorch: `_staging_reason` (:94) names torch's uploads
in place of `jnp.asarray`, `jnp.array` and `jax.device_put`. The scope,
the tick-path region and the message are the reference's.

NOS015 — host->device staging outside the staging API on the tick path.

NOS010 polices the device->host direction (blocking reads); this checker
polices the OTHER half of the dispatch floor: host->device uploads. The
serving engine's tick metadata is device-resident (runtime/staging.py
TickState, advanced by the dispatched programs themselves), and every
upload the tick path still needs — prompt chunks, verify windows, the
packed state sync, a spilled block's payload — funnels through the
counted `HostStage.to_device`, so the host-sync budget (`h2d_uploads`) is
exact. A stray upload in a tick-path method re-introduces an uncounted
per-dispatch transfer:

  - `torch.tensor(x, device=d)` / `torch.as_tensor(x, device=d)` with a
    device other than a "cpu" literal;
  - a host tensor made by `torch.tensor`, `torch.as_tensor` or
    `torch.from_numpy` (or an `np.*` array) moved by `.to(<device>)` or
    `.cuda()`, on the spot or through a local name the same function
    bound to it;
  - `.to(<device>)`/`.cuda()` of a value the function copied to the host
    (`.cpu()`, `.numpy()`).

`.to(<dtype>)` is a cast, not a transfer, and `.to("cpu")` is NOS010's
direction. A tensor already on the device moved by `.to(...)` is not an
upload and is not tracked.

Scope: identical to NOS010 — files under `runtime/` containing an ENGINE
class (a class defining `_tick`); flagged regions come from the shared
call graph's `tick_scope` (everything in the file reachable from the
`_tick`/`_run` roots, plus every method of helper classes in the same
file). The staging module itself (runtime/staging.py) defines no engine
class and is therefore out of scope by construction — it is the ONE
sanctioned home of the raw transfer. Genuinely sanctioned engine-side
sites carry `# nos-lint: ignore[NOS015]` with a rationale.
"""

from __future__ import annotations

import ast
from typing import Dict, Optional, Set

from nos_tpu_torch.analysis.callgraph import CallGraph, tick_scope
from nos_tpu_torch.analysis.core import Checker, FileContext, Report
from nos_tpu_torch.analysis.checkers.trace_safety import _dotted

#: torch's constructors of a host tensor from host data; with a device
#: argument they upload.
_HOST_CTORS = {"torch.tensor", "torch.as_tensor", "torch.from_numpy"}
_DEVICE_CTORS = {"torch.tensor", "torch.as_tensor"}
#: Tensor methods whose result lies on the host.
_TO_HOST = {"cpu", "numpy"}
_DTYPE_NAMES = {
    "float", "float16", "float32", "float64", "half", "double", "bfloat16",
    "int", "int8", "int16", "int32", "int64", "long", "short", "uint8",
    "bool", "complex64", "complex128",
}


def _is_cpu(node: ast.AST) -> bool:
    """A literal "cpu" device: the string or torch.device("cpu")."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.split(":")[0] == "cpu"
    if isinstance(node, ast.Call) and node.args:
        dotted = _dotted(node.func)
        return bool(dotted and dotted.endswith("device")) and _is_cpu(node.args[0])
    return False


def _is_dtype(node: ast.AST) -> bool:
    """torch.int32, x.dtype, a name spelled like a dtype."""
    if isinstance(node, ast.Attribute):
        return node.attr == "dtype" or node.attr in _DTYPE_NAMES
    if isinstance(node, ast.Name):
        return "dtype" in node.id
    return False


def _moves_to_device(call: ast.Call) -> bool:
    """`.cuda(...)`, or `.to(...)` with a device (or a tensor whose device
    it takes) that is not a "cpu" literal."""
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return False
    if fn.attr == "cuda":
        return True
    if fn.attr != "to":
        return False
    for kw in call.keywords:
        if kw.arg == "device":
            return not _is_cpu(kw.value)
    if not call.args:
        return False
    first = call.args[0]
    return not (_is_dtype(first) or _is_cpu(first))


class StagingDisciplineChecker(Checker):
    name = "staging-discipline"
    codes = ("NOS015",)
    description = "host->device staging outside the staging API on the tick path"

    def __init__(self) -> None:
        self._graph: Optional[CallGraph] = None
        self._active = False
        self._aliases: Dict[str, str] = {}
        self._scope_funcs: Set[ast.AST] = set()
        #: Per function: the local names it binds to a host value.
        self._host_names: Dict[ast.AST, Set[str]] = {}

    def begin_run(self, graph: CallGraph) -> None:
        self._graph = graph

    # -- per-file prescan ----------------------------------------------------
    def begin_file(self, ctx: FileContext) -> None:
        self._active = "runtime" in ctx.segments[:-1]
        self._aliases = {}
        self._scope_funcs = set()
        self._host_names = {}
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
        enclosing = ctx.enclosing_all(ast.FunctionDef, ast.AsyncFunctionDef)
        if not any(f in self._scope_funcs for f in enclosing):
            return
        reason = self._staging_reason(node, enclosing[0])
        if reason is not None:
            report.add(
                ctx.rel,
                node.lineno,
                "NOS015",
                f"host->device staging outside the staging API on the engine "
                f"tick path: {reason}; route it through HostStage.to_device "
                "(runtime/staging.py) so the h2d budget stays exact",
            )

    def _resolve(self, func: ast.AST) -> Optional[str]:
        dotted = _dotted(func)
        if dotted is None:
            return None
        head, _, rest = dotted.partition(".")
        module = self._aliases.get(head, head)
        return f"{module}.{rest}" if rest else module

    def _host_value(self, node: ast.AST) -> Optional[str]:
        """How `node` makes a host value, if it visibly does: a host
        constructor without a device, an np.* array, a copy to the host."""
        if not isinstance(node, ast.Call):
            return None
        full = self._resolve(node.func)
        if full in _HOST_CTORS:
            device = [kw.value for kw in node.keywords if kw.arg == "device"]
            return f"{full}()" if not device or _is_cpu(device[0]) else None
        if full is not None and full.startswith("numpy."):
            return "an np.* array"
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in _TO_HOST:
            return f"a .{fn.attr}() copy"
        return None

    def _host_locals(self, func: ast.AST) -> Set[str]:
        """The names `func` binds to a host value (flow-insensitive)."""
        names = self._host_names.get(func)
        if names is None:
            names = set()
            for node in ast.walk(func):
                if (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and self._host_value(node.value) is not None
                ):
                    names.add(node.targets[0].id)
            self._host_names[func] = names
        return names

    def _staging_reason(self, node: ast.Call, func: ast.AST):
        full = self._resolve(node.func)
        if full in _DEVICE_CTORS:
            for kw in node.keywords:
                if kw.arg == "device" and not _is_cpu(kw.value):
                    return f"{full}(..., device=) (uncounted host->device staging)"
            return None
        if not _moves_to_device(node):
            return None
        move = f".{node.func.attr}()"
        receiver = node.func.value
        made = self._host_value(receiver)
        if made is not None:
            return f"{made}{move} (uncounted host->device staging)"
        if isinstance(receiver, ast.Name) and receiver.id in self._host_locals(func):
            return (f"{move} of '{receiver.id}', a host value "
                    "(uncounted host->device staging)")
        return None
