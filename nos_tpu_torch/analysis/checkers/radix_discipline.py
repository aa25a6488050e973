"""Port of `nos_tpu/analysis/checkers/radix_discipline.py:1` (:1-121). Copied
near verbatim; the imports point at the port, which imports nothing of the
JAX package.

NOS017 — radix-tree node structure mutated outside the tree classes.

The prefix cache's flat chain-key index became a radix
tree over token-block edges (`runtime/radix_tree.py` RadixTree /
RadixNode): child edges, per-node refcounts (page tables mapping the
node's indexed block + resident children), and the key -> node map. The
tree's invariants — node_ref equals tables + child refs, every node
reachable from the root exactly once, pruning never orphans a resident
descendant — only hold if every structural mutation funnels through the
tree's methods, exactly the NOS011/NOS013 single-mutator argument one
structure up: a stray `node._edges[tokens] = child` in the engine or
the router shadow silently desynchronizes `_nodes` from the edge
structure, and the drift surfaces later as a hit walk serving a pruned
path (stale KV routed into a page table) or a refcount leak that wedges
subtree eviction — not as a test failure.

Scope: files under `runtime/` or `serving/` (the router shadow walks
and prunes the same class). Any WRITE to the protected tree-structure
attributes (`_edges`, `_node_ref`, `_nodes`) — attribute/subscript
assignment or deletion, augmented assignment, or a mutating method call
like `.pop`/`.update`/`.clear` — outside the `RadixTree`/`RadixNode`
class bodies is flagged, on ANY receiver (reaching through the manager
or a handle is caught the same as `self._nodes`), with no constructor
exemption (tree structure EXISTING outside the tree classes is the
drift). Reads stay legal everywhere: the walk consumers, gauges,
invariant tests, and eviction predicates inspect freely.
"""

from __future__ import annotations

import ast

from nos_tpu_torch.analysis.core import Checker, FileContext, Report

_PROTECTED = frozenset({"_edges", "_node_ref", "_nodes"})

_MUTATORS = frozenset(
    {
        "append",
        "extend",
        "insert",
        "remove",
        "pop",
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

_OWNERS = frozenset({"RadixTree", "RadixNode"})


def _protected_attr(node: ast.AST):
    """The protected attribute name a write target resolves to, if any —
    unwrapping subscript chains so `tree._nodes[key]` and
    `node._edges[tokens]` both resolve to their backing attribute."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and node.attr in _PROTECTED:
        return node.attr
    return None


class RadixDisciplineChecker(Checker):
    name = "radix-discipline"
    codes = ("NOS017",)
    description = "radix-tree node structure mutated outside the tree classes"

    def __init__(self) -> None:
        self._active = False

    def begin_file(self, ctx: FileContext) -> None:
        dirs = ctx.segments[:-1]
        self._active = "runtime" in dirs or "serving" in dirs

    def _flag(self, ctx: FileContext, node: ast.AST, attr: str, how: str, report: Report) -> None:
        report.add(
            ctx.rel,
            node.lineno,
            "NOS017",
            f"radix-tree structure `{attr}` {how} outside RadixTree/"
            "RadixNode; route the mutation through a RadixTree method so "
            "the node-refcount/edge/key-map invariants stay enforceable "
            "in one place",
        )

    def visit(self, ctx: FileContext, node: ast.AST, report: Report) -> None:
        if not self._active:
            return
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
                        self._flag(ctx, node, attr, "assigned", report)
        elif isinstance(node, ast.Delete):
            for target in node.targets:
                attr = _protected_attr(target)
                if attr is not None:
                    self._flag(ctx, node, attr, "deleted", report)
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in _MUTATORS:
                attr = _protected_attr(node.func.value)
                if attr is not None:
                    self._flag(
                        ctx, node, attr, f"mutated via .{node.func.attr}()", report
                    )
