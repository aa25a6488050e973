"""Port of `nos_tpu/analysis/checkers/trace_safety.py:1` (:1-225), its rules
rewritten for PyTorch: `_JIT_WRAPPERS` (:41) names torch's replayed
callables, `_in_traced_function` (:115) also counts the body of a
`torch.cuda.graph` capture block, and NOS009 (`_check_sim_rng`, :203)
counts torch's global generator. The codes, scopes and messages are the
reference's.

NOS007/NOS008/NOS009 — trace/capture safety and simulation determinism.

NOS007 — impure call inside a function whose Python body runs once and is
then replayed. A CUDA graph captured by `with torch.cuda.graph(g):`
replays the kernels its body launched, not the body; a callable handed to
`torch.cuda.make_graphed_callables` or `torch.compile` (or decorated by
either), an `@triton.jit` kernel, and the callable the engine's own
capture wrapper takes (`_WindowGraph(self._macro, ...)`,
runtime/decode_server.py) are the same: a `time.time()`, unseeded
`random`/`np.random` draw, `print`, or `global` mutation inside them bakes
a single stale value into the replayed program (or silently does nothing
per step). Detected for functions decorated with such a wrapper, handed
to one anywhere in the module (a bare name, a `self.method`, or a lambda),
and for every call inside a `torch.cuda.graph(...)` block. `.debug.`
calls stay legal, as `jax.debug.print` does in the reference. Scope: ops/,
models/, parallel/, runtime/.

NOS008 — float `==`/`!=` against a float literal in numeric code
(ops/, models/, parallel/, runtime/, tpulib/): accumulated rounding makes
exact equality a latent heisenbug; compare with a tolerance (or suppress
inline where the arithmetic is provably exact).

NOS009 — unseeded global-RNG draw on simulation/planner paths (sim.py,
sim_oracle.py, partitioning/, scheduler/, tpu/): the CI-pinned simulation
points are bit-for-bit reproductions; one `random.random()` on the module
RNG (instead of an injected `random.Random(seed)`) destabilizes every pinned
number. Seeded constructors (`random.Random(...)`, `np.random.default_rng`,
`np.random.RandomState`) are fine; draws on the global RNG are not. Torch's
global generator counts the same: `torch.rand*`/`randn*`/`randint*`,
`randperm`, `multinomial`, `bernoulli` and `normal` without `generator=`,
and `torch.manual_seed` (which reseeds it); an explicit `torch.Generator`
stays legal.
"""

from __future__ import annotations

import ast
from typing import Dict, Optional, Set

from nos_tpu_torch.analysis.core import Checker, FileContext, Report

_JIT_SCOPE = {"ops", "models", "parallel", "runtime"}
_FLOAT_EQ_SCOPE = _JIT_SCOPE | {"tpulib"}
_SIM_SCOPE_DIRS = {"partitioning", "scheduler", "tpu"}
_SIM_SCOPE_FILES = {"sim.py", "sim_oracle.py"}

_TIME_FUNCS = {"time", "time_ns", "perf_counter", "perf_counter_ns", "monotonic"}
_SEEDED_RANDOM_CTORS = {"Random", "SystemRandom", "getstate", "setstate"}
_SEEDED_NP_CTORS = {"default_rng", "RandomState", "Generator", "SeedSequence"}
#: Callables whose wrapped function runs its Python body once and is then
#: replayed, by their last dotted segment: `triton.jit`,
#: `torch.cuda.make_graphed_callables` and the engine's capture wrapper
#: (`_WindowGraph`, runtime/decode_server.py). `torch.compile` is matched
#: in full (`_COMPILE`): a bare `compile` is the builtin.
_JIT_WRAPPERS = {"jit", "make_graphed_callables", "_WindowGraph"}
_COMPILE = "torch.compile"
#: The capture context manager: every call in its body is recorded once.
_CAPTURE_BLOCKS = {"torch.cuda.graph", "torch.cuda.graphs.graph"}
#: torch functions that draw from the global generator unless handed
#: `generator=`, and the calls that reseed it.
_TORCH_DRAWS = {
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "multinomial", "bernoulli", "normal",
}
_TORCH_RESEEDS = {
    "manual_seed", "seed", "random.manual_seed", "random.seed",
    "cuda.manual_seed", "cuda.manual_seed_all", "cuda.seed", "cuda.seed_all",
}


def _dotted(node: ast.expr) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _resolved(node: ast.expr, aliases: Dict[str, str]) -> Optional[str]:
    """The dotted name of a Name/Attribute chain with its head expanded
    through the module's imports ('tc.compile' -> 'torch.compile')."""
    dotted = _dotted(node)
    if dotted is None:
        return None
    head, _, rest = dotted.partition(".")
    module = aliases.get(head, head)
    return f"{module}.{rest}" if rest else module


def _is_jit_wrapper(node: ast.expr, aliases: Dict[str, str]) -> bool:
    """triton.jit / torch.compile / torch.cuda.make_graphed_callables /
    _WindowGraph, a call of one used as a decorator factory
    (`torch.compile(mode=...)`), or functools.partial(torch.compile, ...)."""
    full = _resolved(node, aliases)
    if full and (full.split(".")[-1] in _JIT_WRAPPERS or full == _COMPILE):
        return True
    if isinstance(node, ast.Call):
        if _is_jit_wrapper(node.func, aliases):
            return True  # torch.compile(mode=...) used as decorator factory
        fn_dotted = _dotted(node.func)
        if fn_dotted and fn_dotted.split(".")[-1] == "partial":
            return any(_is_jit_wrapper(a, aliases) for a in node.args[:1])
    return False


class TraceSafetyChecker(Checker):
    name = "trace-safety"
    codes = ("NOS007", "NOS008", "NOS009")
    description = "purity inside traced functions; deterministic sim/planner paths"

    def __init__(self) -> None:
        self._jitted_names: Set[str] = set()
        self._jitted_lambdas: Set[ast.Lambda] = set()
        self._aliases: Dict[str, str] = {}
        self._in_jit_scope = False
        self._in_float_scope = False
        self._in_sim_scope = False

    # -- per-file prescan ----------------------------------------------------
    def begin_file(self, ctx: FileContext) -> None:
        segs = set(ctx.segments[:-1])
        self._in_jit_scope = bool(segs & _JIT_SCOPE)
        self._in_float_scope = bool(segs & _FLOAT_EQ_SCOPE)
        self._in_sim_scope = bool(segs & _SIM_SCOPE_DIRS) or ctx.basename in _SIM_SCOPE_FILES
        self._jitted_names = set()
        self._jitted_lambdas = set()
        self._aliases = {}
        if not (self._in_jit_scope or self._in_sim_scope):
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self._aliases[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self._aliases[a.asname or a.name] = f"{node.module}.{a.name}"
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if any(_is_jit_wrapper(d, self._aliases) for d in node.decorator_list):
                    self._jitted_names.add(node.name)
            elif isinstance(node, ast.Call) and _is_jit_wrapper(node.func, self._aliases):
                for arg in node.args[:1]:
                    for fn in arg.elts if isinstance(arg, (ast.Tuple, ast.List)) else [arg]:
                        if isinstance(fn, ast.Name):
                            self._jitted_names.add(fn.id)
                        elif (isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name)
                              and fn.value.id == "self"):
                            self._jitted_names.add(fn.attr)  # _WindowGraph(self._macro)
                        elif isinstance(fn, ast.Lambda):
                            self._jitted_lambdas.add(fn)

    # -- helpers -------------------------------------------------------------
    def _module_of(self, name: str) -> str:
        return self._aliases.get(name, name)

    def _in_traced_function(self, ctx: FileContext, node: ast.AST) -> bool:
        for i, anc in enumerate(ctx.stack):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if anc.name in self._jitted_names:
                    return True
            elif isinstance(anc, ast.Lambda) and anc in self._jitted_lambdas:
                return True
            elif isinstance(anc, (ast.With, ast.AsyncWith)) and self._captures(anc):
                # The block's body, not its `torch.cuda.graph(...)` item.
                inner = ctx.stack[i + 1] if i + 1 < len(ctx.stack) else node
                if not isinstance(inner, ast.withitem):
                    return True
        return False

    def _captures(self, block) -> bool:
        return any(
            isinstance(item.context_expr, ast.Call)
            and _resolved(item.context_expr.func, self._aliases) in _CAPTURE_BLOCKS
            for item in block.items
        )

    def _impurity(self, node: ast.Call) -> Optional[str]:
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id == "print":
            return "print() (capture/trace-time only; it never runs on replay)"
        dotted = _dotted(fn)
        if dotted is None:
            return None
        head, _, rest = dotted.partition(".")
        module = self._module_of(head)
        if module == "time" and rest in _TIME_FUNCS:
            return f"time.{rest}() (baked in at trace time)"
        if module == "random" and rest and rest.split(".")[0] not in _SEEDED_RANDOM_CTORS:
            return f"random.{rest}() (global RNG at trace time)"
        if module in ("numpy", "np") or module.endswith(".numpy"):
            sub = rest.split(".")
            if len(sub) >= 2 and sub[0] == "random" and sub[1] not in _SEEDED_NP_CTORS:
                return f"np.random.{sub[1]}() (global RNG at trace time)"
        if module == "os" and rest == "urandom":
            return "os.urandom() (host entropy at trace time)"
        if module == "uuid" and rest.startswith("uuid"):
            return f"uuid.{rest}() (host entropy at trace time)"
        return None

    # -- visit ---------------------------------------------------------------
    def visit(self, ctx: FileContext, node: ast.AST, report: Report) -> None:
        if self._in_jit_scope:
            self._check_traced(ctx, node, report)
        if self._in_float_scope and isinstance(node, ast.Compare):
            self._check_float_eq(ctx, node, report)
        if self._in_sim_scope and isinstance(node, ast.Call):
            self._check_sim_rng(ctx, node, report)

    def _check_traced(self, ctx: FileContext, node: ast.AST, report: Report) -> None:
        if isinstance(node, ast.Global):
            if self._in_traced_function(ctx, node):
                report.add(
                    ctx.rel,
                    node.lineno,
                    "NOS007",
                    "global mutation inside a traced function (runs once at "
                    "trace time, not per step)",
                )
            return
        if not isinstance(node, ast.Call):
            return
        # `.debug.` calls stay legal, as jax.debug.print does in the reference.
        dotted = _dotted(node.func)
        if dotted and ".debug." in f".{dotted}.":
            return
        reason = self._impurity(node)
        if reason and self._in_traced_function(ctx, node):
            report.add(
                ctx.rel,
                node.lineno,
                "NOS007",
                f"impure call in captured/compiled function: {reason}",
            )

    @staticmethod
    def _check_float_eq(ctx: FileContext, node: ast.Compare, report: Report) -> None:
        if not any(isinstance(op, (ast.Eq, ast.NotEq)) for op in node.ops):
            return
        operands = [node.left, *node.comparators]
        for operand in operands:
            if isinstance(operand, ast.UnaryOp):
                operand = operand.operand
            if (
                isinstance(operand, ast.Constant)
                and isinstance(operand.value, float)
            ):
                report.add(
                    ctx.rel,
                    node.lineno,
                    "NOS008",
                    f"float equality against {operand.value!r} in numeric code; "
                    "compare with a tolerance",
                )
                return

    def _check_sim_rng(self, ctx: FileContext, node: ast.Call, report: Report) -> None:
        dotted = _dotted(node.func)
        if dotted is None:
            return
        head, _, rest = dotted.partition(".")
        module = self._module_of(head)
        first = rest.split(".")[0] if rest else ""
        if module == "random" and first and first not in _SEEDED_RANDOM_CTORS:
            draw = f"random.{first}()"
        elif module in ("numpy", "np") or module.endswith(".numpy"):
            sub = rest.split(".")
            if not (len(sub) >= 2 and sub[0] == "random" and sub[1] not in _SEEDED_NP_CTORS):
                return
            draw = f"np.random.{sub[1]}()"
        elif module == "torch":
            if rest in _TORCH_RESEEDS:
                draw = f"torch.{rest}() (reseeds the global generator)"
            elif rest in _TORCH_DRAWS and not any(
                kw.arg == "generator" for kw in node.keywords
            ):
                draw = f"torch.{rest}()"
            else:
                return
            report.add(
                ctx.rel,
                node.lineno,
                "NOS009",
                f"unseeded global-RNG draw {draw} on a simulation/planner path; "
                "inject a seeded torch.Generator (generator=) instead",
            )
            return
        else:
            return
        report.add(
            ctx.rel,
            node.lineno,
            "NOS009",
            f"unseeded global-RNG draw {draw} on a simulation/planner path; "
            "inject a seeded random.Random / np.random.default_rng instead",
        )
