"""Port of `nos_tpu/analysis/callgraph.py:1` (:1-340). Copied near verbatim;
the imports point at the port, which imports nothing of the JAX package.

Shared interprocedural layer: whole-tree symbols + a conservative call graph.

Before this module, four checkers (NOS010/NOS012/NOS015/NOS016) each hand-rolled
their own "reachable from `_tick`" walk over `self.method()` calls — four
divergent approximations of the same question. The new checkers (NOS020
use-after-donate, NOS021 replay purity) need strictly more: donated callables
built in `__init__` and consumed in `_tick`, and purity closure that crosses
module boundaries (`FleetMonitor.replay` -> `fleet_utilization` ->
`accounting.duty_cycle`). So the engine now computes ONE graph per lint run and
every reachability question goes through it.

Resolution is deliberately conservative — edges only where the callee is
statically unambiguous:

  - ``self.m()`` / ``cls.m()`` inside a class body -> that class's own method;
  - bare ``f()`` -> a module-level function of the same module, or the target
    of an unambiguous ``from X import f``;
  - ``alias.f()`` / dotted module calls -> the imported module's function when
    that module is part of the analyzed tree;
  - ``C()`` (a known class) -> ``C.__init__``;
  - ``obj.m()`` on an unknown receiver -> the unique class in the TREE that
    defines ``m`` (the NOS006 lock-graph rule generalized), or — when several
    candidates exist but all live in the caller's own file — every same-file
    candidate (the "same-file helper class" idiom the tick checkers rely on).
    Method names that collide with builtin container/str methods (``get``,
    ``items``, ``append``, ...) are never resolved this way: a ``row.get()``
    must not fabricate an edge into some class that happens to define ``get``.

Calls inside nested functions/lambdas are attributed to the enclosing
top-level function or method (a closure built inside `_tick` runs, at the
latest, on the tick path — the same over-approximation the old walks made).

Inheritance is NOT resolved (neither were the old walks): an edge to an
inherited method requires the subclass to restate it. Over-approximation is
acceptable — the graph feeds checkers whose findings are reviewed by humans —
but silent UNDER-approximation relative to the old per-checker walks is not:
tests/test_static_analysis.py pins that the graph's tick scope is a superset
of the legacy walk on the real tree.
"""

from __future__ import annotations

import ast
import hashlib
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

#: Attribute names that belong to builtin containers/strings: never resolve a
#: ``obj.m()`` call through the unique-method-name rule for these — ``d.get``,
#: ``s.split`` and friends would otherwise fabricate edges into any class that
#: happens to define a method with the same name.
_BUILTIN_METHODS: Set[str] = set()
for _t in (dict, list, set, frozenset, str, bytes, tuple, int, float):
    _BUILTIN_METHODS.update(n for n in dir(_t) if not n.startswith("__"))
_BUILTIN_METHODS.update({"popleft", "appendleft", "extendleft"})  # deque


def _dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclass
class FuncInfo:
    """One top-level function or method in the analyzed tree."""

    qname: str  # "<rel>::<func>" or "<rel>::<Class>.<method>"
    rel: str
    name: str  # bare function/method name
    cls: Optional[str]  # owning class name, None for module-level
    node: ast.AST  # the FunctionDef/AsyncFunctionDef


@dataclass
class ModuleInfo:
    """Per-module symbol table."""

    rel: str
    dotted: str  # "nos_tpu_torch.serving.monitor" (best-effort from the rel path)
    aliases: Dict[str, str] = field(default_factory=dict)  # local name -> dotted
    functions: Dict[str, FuncInfo] = field(default_factory=dict)
    classes: Dict[str, Dict[str, FuncInfo]] = field(default_factory=dict)


class CallGraph:
    """Whole-tree symbol table + conservative call graph with a reusable
    `reachable_from` query. Built once per lint run from every parsed file."""

    def __init__(self, trees: Iterable[Tuple[str, ast.Module]]):
        self.modules: Dict[str, ModuleInfo] = {}
        self.nodes: Dict[str, FuncInfo] = {}
        self.edges: Dict[str, Set[str]] = {}
        #: method name -> [FuncInfo] across the tree (unique-name resolution)
        self._methods_by_name: Dict[str, List[FuncInfo]] = {}
        #: dotted module path -> ModuleInfo (cross-module call resolution)
        self._by_dotted: Dict[str, ModuleInfo] = {}
        pairs = list(trees)
        for rel, tree in pairs:
            self._index_module(rel, tree)
        for rel, tree in pairs:
            self._collect_edges(self.modules[rel])

    # -- construction --------------------------------------------------------
    def _index_module(self, rel: str, tree: ast.Module) -> None:
        dotted = rel[:-3].replace("/", ".") if rel.endswith(".py") else rel
        if dotted.endswith(".__init__"):
            dotted = dotted[: -len(".__init__")]
        mod = ModuleInfo(rel=rel, dotted=dotted)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    mod.aliases[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                base = node.module
                if node.level:  # relative import: resolve against this package
                    pkg = dotted.split(".")
                    base = ".".join(pkg[: len(pkg) - node.level] + [node.module])
                for a in node.names:
                    mod.aliases[a.asname or a.name] = f"{base}.{a.name}"
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                info = FuncInfo(f"{rel}::{node.name}", rel, node.name, None, node)
                mod.functions[node.name] = info
                self.nodes[info.qname] = info
            elif isinstance(node, ast.ClassDef):
                methods: Dict[str, FuncInfo] = {}
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        info = FuncInfo(
                            f"{rel}::{node.name}.{item.name}",
                            rel,
                            item.name,
                            node.name,
                            item,
                        )
                        methods[item.name] = info
                        self.nodes[info.qname] = info
                        self._methods_by_name.setdefault(item.name, []).append(info)
                mod.classes[node.name] = methods
        self.modules[rel] = mod
        self._by_dotted[mod.dotted] = mod

    def _collect_edges(self, mod: ModuleInfo) -> None:
        for info in mod.functions.values():
            self.edges[info.qname] = self._edges_of(mod, None, info.node)
        for cls, methods in mod.classes.items():
            for info in methods.values():
                self.edges[info.qname] = self._edges_of(mod, cls, info.node)

    def _edges_of(self, mod: ModuleInfo, cls: Optional[str], func: ast.AST) -> Set[str]:
        out: Set[str] = set()
        for node in ast.walk(func):
            if isinstance(node, ast.Call):
                out.update(self.resolve_call(mod.rel, cls, node))
        return out

    # -- call resolution -----------------------------------------------------
    def resolve_call(
        self, rel: str, cls: Optional[str], call: ast.Call
    ) -> Set[str]:
        """Conservatively resolve one call site to callee qnames (possibly
        empty). `cls` is the enclosing class name, if any."""
        mod = self.modules.get(rel)
        if mod is None:
            return set()
        fn = call.func
        # self.m() / cls.m() -> own class method
        if (
            isinstance(fn, ast.Attribute)
            and isinstance(fn.value, ast.Name)
            and fn.value.id in ("self", "cls")
            and cls is not None
        ):
            target = mod.classes.get(cls, {}).get(fn.attr)
            return {target.qname} if target else set()
        # bare f() -> module function / imported symbol / class constructor
        if isinstance(fn, ast.Name):
            return self._resolve_symbol(mod, fn.id)
        if isinstance(fn, ast.Attribute):
            dotted = _dotted_name(fn)
            if dotted is not None:
                resolved = self._resolve_dotted(mod, dotted)
                if resolved is not None:
                    return resolved
            # obj.m() on an unknown receiver: unique method name in the tree,
            # or the same-file helper-class candidates.
            if fn.attr in _BUILTIN_METHODS:
                return set()
            candidates = self._methods_by_name.get(fn.attr, [])
            if len(candidates) == 1:
                return {candidates[0].qname}
            local = [c for c in candidates if c.rel == rel]
            if candidates and len(local) == len(candidates):
                return {c.qname for c in local}
        return set()

    def _resolve_symbol(self, mod: ModuleInfo, name: str) -> Set[str]:
        if name in mod.functions:
            return {mod.functions[name].qname}
        if name in mod.classes:
            ctor = mod.classes[name].get("__init__")
            return {ctor.qname} if ctor else set()
        target = mod.aliases.get(name)
        if target is not None:
            head, _, sym = target.rpartition(".")
            owner = self._by_dotted.get(head)
            if owner is not None:
                if sym in owner.functions:
                    return {owner.functions[sym].qname}
                if sym in owner.classes:
                    ctor = owner.classes[sym].get("__init__")
                    return {ctor.qname} if ctor else set()
        return set()

    def _resolve_dotted(self, mod: ModuleInfo, dotted: str) -> Optional[Set[str]]:
        """Resolve 'alias.f' / 'alias.sub.f' through the import table. Returns
        None when the chain is not module-rooted (so the caller can fall back
        to receiver-free method resolution)."""
        head, _, rest = dotted.partition(".")
        if not rest or head in ("self", "cls"):
            return None
        base = mod.aliases.get(head)
        if base is None:
            return None
        full = f"{base}.{rest}"
        owner_path, _, sym = full.rpartition(".")
        owner = self._by_dotted.get(owner_path)
        if owner is None:
            # alias resolved but the target module is outside the analyzed
            # tree (jax.jit, time.time, ...): definitively external.
            return set()
        if sym in owner.functions:
            return {owner.functions[sym].qname}
        if sym in owner.classes:
            ctor = owner.classes[sym].get("__init__")
            return {ctor.qname} if ctor else set()
        # Class attribute chain (X.method) inside a known module.
        mod_sym, _, meth = sym.partition(".")
        return set()

    # -- queries -------------------------------------------------------------
    def reachable_from(
        self,
        roots: Iterable[str],
        within: Optional[Set[str]] = None,
    ) -> Set[str]:
        """Transitive closure over the call graph from `roots` (qnames).
        `within` restricts traversal to nodes of the given rel paths — the
        per-file scope the ported tick checkers use. Roots outside `within`
        are dropped; unknown roots are ignored."""
        seen: Set[str] = set()
        queue: List[str] = []
        for r in roots:
            if r in self.nodes and (within is None or self.nodes[r].rel in within):
                if r not in seen:
                    seen.add(r)
                    queue.append(r)
        while queue:
            cur = queue.pop()
            for nxt in self.edges.get(cur, ()):
                if nxt in seen or nxt not in self.nodes:
                    continue
                if within is not None and self.nodes[nxt].rel not in within:
                    continue
                seen.add(nxt)
                queue.append(nxt)
        return seen

    def ast_nodes(self, qnames: Iterable[str]) -> Set[ast.AST]:
        return {self.nodes[q].node for q in qnames if q in self.nodes}

    def functions(self) -> Iterable[FuncInfo]:
        return self.nodes.values()

    def module(self, rel: str) -> Optional[ModuleInfo]:
        return self.modules.get(rel)

    def digest(self) -> str:
        """Stable content digest of the graph (nodes + sorted edges) — a
        cross-file invalidation key for cached interprocedural verdicts."""
        h = hashlib.sha256()
        for q in sorted(self.nodes):
            h.update(q.encode())
            for e in sorted(self.edges.get(q, ())):
                h.update(b"->")
                h.update(e.encode())
            h.update(b"\n")
        return h.hexdigest()


# ---------------------------------------------------------------------------
# Shared scope constructions for the tick-path checkers
# ---------------------------------------------------------------------------
def tick_scope(
    graph: CallGraph,
    rel: str,
    *,
    engine_markers: Sequence[str] = ("_tick",),
    roots: Sequence[str] = ("_tick", "_run"),
    include_helpers: bool = True,
) -> Set[ast.AST]:
    """The flagged region of one `runtime/` engine file, shared by
    NOS010/NOS012/NOS015/NOS016: every function of the file reachable from the
    engine classes' tick roots (same-file closure over the call graph — a
    superset of the old `self.method()`-only walks, since module-level helpers
    called from the tick now count too), plus, when `include_helpers`, every
    method of the file's non-engine classes (helpers like `_TokRef` exist to
    be called from the tick, so they are tick-path by construction).

    Engine classes are those defining any of `engine_markers`; returns the
    empty set when the file has none."""
    mod = graph.module(rel)
    if mod is None:
        return set()
    engine_classes = {
        name: methods
        for name, methods in mod.classes.items()
        if any(m in methods for m in engine_markers)
    }
    if not engine_classes:
        return set()
    root_qnames = [
        methods[r].qname
        for methods in engine_classes.values()
        for r in roots
        if r in methods
    ]
    scope = graph.ast_nodes(graph.reachable_from(root_qnames, within={rel}))
    if include_helpers:
        for name, methods in mod.classes.items():
            if name not in engine_classes:
                scope.update(info.node for info in methods.values())
    return scope
