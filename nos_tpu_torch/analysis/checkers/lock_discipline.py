"""Port of `nos_tpu/analysis/checkers/lock_discipline.py:1` (:1-277). Copied
near verbatim; the imports point at the port, which imports nothing of the
JAX package.

NOS005/NOS006 — lock discipline in the threaded modules.

Ten modules (controllers, batcher, leader election, cluster bus, decode/slice
servers, device shims) coordinate via hand-rolled `threading` locks that only
soak tests exercise. Two static guards:

NOS005 — unlocked shared mutation. Within a class that owns a lock
(`self._lock = threading.Lock()/RLock()/Condition()`), the checker infers the
set of SHARED attributes: those mutated at least once inside a
`with self._lock:` block (outside __init__). Any mutation of a shared
attribute outside the lock, in any non-constructor method, is flagged —
the author already decided the attribute needs the lock; the unlocked site
is the bug. Mutations counted: attribute assignment/augassign, subscript
store/del rooted at the attribute, and mutating method calls
(`self._pods.pop(...)`, `.append`, `.update`, ...). Methods whose name ends
in `_locked` follow the caller-holds-the-lock convention and are treated as
locked.

NOS006 — lock-order inversion. The checker builds a static lock-acquisition
graph: an edge A -> B for every `with` that acquires B while A is held —
directly nested in one function, or via a method call made while holding A
to a method (resolved by unambiguous name across the analyzed tree) that
acquires B. A cycle in that graph is a potential cross-module deadlock and
is reported once per cycle.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from nos_tpu_torch.analysis.core import Checker, FileContext, Report

_LOCK_TYPES = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
_MUTATORS = {
    "append",
    "appendleft",
    "add",
    "update",
    "clear",
    "pop",
    "popleft",
    "popitem",
    "setdefault",
    "remove",
    "discard",
    "extend",
    "insert",
}
_CTORS = {"__init__", "__post_init__", "__new__"}


def _lock_ctor(node: ast.expr) -> bool:
    """True for `threading.Lock()` / `Lock()` / `threading.Condition(...)`."""
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    if isinstance(fn, ast.Attribute) and fn.attr in _LOCK_TYPES:
        return True
    return isinstance(fn, ast.Name) and fn.id in _LOCK_TYPES


def _self_attr(node: ast.expr) -> Optional[str]:
    """'X' for `self.X`, else None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _mutation_root(target: ast.expr) -> Optional[str]:
    """Attribute name mutated by an assignment target rooted at `self`:
    `self.X`, `self.X[k]`, `self.X[k][j]` -> 'X'."""
    while isinstance(target, ast.Subscript):
        target = target.value
    return _self_attr(target)


class _Mutation:
    __slots__ = ("attr", "line", "locked", "method")

    def __init__(self, attr: str, line: int, locked: bool, method: str):
        self.attr = attr
        self.line = line
        self.locked = locked
        self.method = method


class _ClassInfo:
    def __init__(self, rel: str, name: str):
        self.rel = rel
        self.name = name
        self.locks: Set[str] = set()
        self.mutations: List[_Mutation] = []
        # (held lock id, callee method name, line) observed while locked
        self.locked_calls: List[Tuple[str, str, int]] = []
        # direct nested acquisitions: (held id, acquired id, line)
        self.nested: List[Tuple[str, str, int]] = []
        # method name -> lock ids it acquires
        self.method_acquires: Dict[str, Set[str]] = {}

    def lock_id(self, attr: str) -> str:
        return f"{self.name}.{attr}"


class LockDisciplineChecker(Checker):
    name = "lock-discipline"
    codes = ("NOS005", "NOS006")
    cross_file = True  # finish() correlates sites across the whole tree
    description = "shared attributes stay behind their lock; no lock-order cycles"

    def __init__(self) -> None:
        self.classes: List[_ClassInfo] = []

    def visit(self, ctx: FileContext, node: ast.AST, report: Report) -> None:
        # Analyze whole classes in one shot when the traversal reaches them;
        # child visits are ignored (the class walk below covers them).
        if not isinstance(node, ast.ClassDef) or ctx.enclosing(ast.ClassDef) is not None:
            return
        info = _ClassInfo(ctx.rel, node.name)
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Assign):
                        for t in sub.targets:
                            attr = _self_attr(t)
                            if attr and _lock_ctor(sub.value):
                                info.locks.add(attr)
        if not info.locks:
            return
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                held0: Set[str] = set(info.locks) if stmt.name.endswith("_locked") else set()
                self._walk_method(info, stmt.name, stmt.body, held0)
        self.classes.append(info)
        self._report_unlocked(info, report)

    # -- per-method walk tracking held locks ---------------------------------
    def _walk_method(
        self, info: _ClassInfo, method: str, body: List[ast.stmt], held: Set[str]
    ) -> None:
        for stmt in body:
            self._walk_stmt(info, method, stmt, held)

    def _walk_stmt(self, info: _ClassInfo, method: str, node: ast.AST, held: Set[str]) -> None:
        if isinstance(node, ast.With):
            acquired: Set[str] = set()
            for item in node.items:
                expr = item.context_expr
                # `with self._lock:` and `with self._cond:` both acquire.
                attr = _self_attr(expr)
                if attr is None and isinstance(expr, ast.Call):
                    attr = _self_attr(expr.func)  # with self._lock.acquire_timeout(...)
                if attr in info.locks:
                    acquired.add(attr)
                    for h in held:
                        info.nested.append((info.lock_id(h), info.lock_id(attr), node.lineno))
            if acquired:
                info.method_acquires.setdefault(method, set()).update(
                    info.lock_id(a) for a in acquired
                )
            self._walk_method(info, method, node.body, held | acquired)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            # Nested function: runs later on an unknown thread; analyze its
            # body with no locks held under a scoped method name.
            inner = getattr(node, "body", [])
            if isinstance(inner, ast.expr):
                inner = [ast.Expr(value=inner)]
            self._walk_method(info, f"{method}.<nested>", inner, set())
            return
        self._record(info, method, node, held)
        for child in ast.iter_child_nodes(node):
            self._walk_stmt(info, method, child, held)

    def _record(self, info: _ClassInfo, method: str, node: ast.AST, held: Set[str]) -> None:
        locked = bool(held)
        if isinstance(node, ast.Assign):
            for t in node.targets:
                self._note_mutation(info, method, t, node.lineno, locked)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            self._note_mutation(info, method, node.target, node.lineno, locked)
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                self._note_mutation(info, method, t, node.lineno, locked)
        elif isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute):
                base = _self_attr(fn.value)
                if fn.attr in _MUTATORS and base is not None and base not in info.locks:
                    info.mutations.append(_Mutation(base, node.lineno, locked, method))
                elif held:
                    # method call while holding a lock: candidate graph edge
                    for h in held:
                        info.locked_calls.append((info.lock_id(h), fn.attr, node.lineno))

    def _note_mutation(
        self, info: _ClassInfo, method: str, target: ast.expr, line: int, locked: bool
    ) -> None:
        attr = _mutation_root(target)
        if attr is not None and attr not in info.locks:
            info.mutations.append(_Mutation(attr, line, locked, method))

    # -- NOS005 --------------------------------------------------------------
    @staticmethod
    def _report_unlocked(info: _ClassInfo, report: Report) -> None:
        shared = {
            m.attr for m in info.mutations if m.locked and m.method not in _CTORS
        }
        for m in info.mutations:
            if m.attr in shared and not m.locked and m.method not in _CTORS:
                lock = sorted(info.locks)[0]
                report.add(
                    info.rel,
                    m.line,
                    "NOS005",
                    f"{info.name}.{m.attr} is mutated under {info.name}.{lock} "
                    f"elsewhere but written here without holding it",
                )

    # -- NOS006 --------------------------------------------------------------
    def finish(self, report: Report) -> None:
        # Resolve method names to lock acquisitions when unambiguous.
        owner: Dict[str, Optional[_ClassInfo]] = {}
        for info in self.classes:
            for meth in info.method_acquires:
                owner[meth] = None if meth in owner else info
        edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
        for info in self.classes:
            for held, acquired, line in info.nested:
                if held != acquired:
                    edges.setdefault((held, acquired), (info.rel, line))
            for held, callee, line in info.locked_calls:
                target = owner.get(callee)
                if target is None:
                    continue
                for acquired in target.method_acquires[callee]:
                    if acquired != held:
                        edges.setdefault((held, acquired), (info.rel, line))
        graph: Dict[str, Set[str]] = {}
        for a, b in edges:
            graph.setdefault(a, set()).add(b)
        for cycle in self._cycles(graph):
            first = (cycle[0], cycle[1])
            rel, line = edges[first]
            path = " -> ".join(cycle)
            report.add(
                rel,
                line,
                "NOS006",
                f"potential lock-order inversion: {path} (acquisition-graph cycle)",
            )

    @staticmethod
    def _cycles(graph: Dict[str, Set[str]]) -> List[List[str]]:
        """Elementary cycles, canonicalized so each is reported once."""
        seen: Set[Tuple[str, ...]] = set()
        out: List[List[str]] = []

        def dfs(start: str, node: str, path: List[str], visited: Set[str]) -> None:
            for nxt in sorted(graph.get(node, ())):
                if nxt == start:
                    cycle = path + [start]
                    i = cycle.index(min(cycle[:-1]))
                    canon = tuple(cycle[:-1][i:] + cycle[:-1][:i])
                    if canon not in seen:
                        seen.add(canon)
                        out.append(list(canon) + [canon[0]])
                elif nxt not in visited and nxt > start:
                    dfs(start, nxt, path + [nxt], visited | {nxt})

        for start in sorted(graph):
            dfs(start, start, [start], {start})
        return out
