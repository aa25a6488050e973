"""Port of `nos_tpu/analysis/checkers/spill_discipline.py:1` (:1-114). Copied
near verbatim; the imports point at the port, which imports nothing of the
JAX package.

NOS013 — spill-tier state mutated outside the SpillTier.

The host-RAM tier of the paged KV cache
(`runtime/spill.py` SpillTier) holds host payload buffers keyed by chain key
plus a running byte gauge, with a capacity bound enforced at `put`. The
tier's invariants — the byte gauge equals the sum of resident payload
sizes, residency never exceeds capacity, a key resolves to exactly one
payload — only hold if every mutation funnels through the class, exactly
the NOS011 argument for the BlockManager's pool state. One stray
`tier._spill_store[key] = payload` in engine code silently unbalances
the byte accounting; the drift shows up later as a host-memory leak or a
revive serving a half-replaced payload, not as a test failure.

Scope: files under `runtime/`. Any WRITE to the protected tier-state
attributes (`_spill_store`, `_spill_bytes`) — attribute/subscript
assignment or deletion, augmented assignment, or a mutating method call
like `.pop`/`.update`/`.popitem` — outside the `SpillTier` class body is
flagged, on ANY receiver (reaching through the engine or the
BlockManager is caught the same as `self._spill_store`). Reads stay
legal everywhere: gauges, conservation predicates, and tests may
inspect; only the SpillTier may mutate.
"""

from __future__ import annotations

import ast

from nos_tpu_torch.analysis.core import Checker, FileContext, Report

_PROTECTED = frozenset({"_spill_store", "_spill_bytes"})

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

_OWNER = "SpillTier"


def _protected_attr(node: ast.AST):
    """The protected attribute name a write target resolves to, if any —
    unwrapping subscript chains so `tier._spill_store[key]` resolves to
    its backing attribute."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and node.attr in _PROTECTED:
        return node.attr
    return None


class SpillDisciplineChecker(Checker):
    name = "spill-discipline"
    codes = ("NOS013",)
    description = "spill-tier state mutated outside the SpillTier"

    def __init__(self) -> None:
        self._active = False

    def begin_file(self, ctx: FileContext) -> None:
        self._active = "runtime" in ctx.segments[:-1]

    def _flag(self, ctx: FileContext, node: ast.AST, attr: str, how: str, report: Report) -> None:
        report.add(
            ctx.rel,
            node.lineno,
            "NOS013",
            f"spill-tier state `{attr}` {how} outside SpillTier; route the "
            "mutation through a SpillTier method so the host-byte/"
            "capacity/index invariants stay enforceable in one place",
        )

    def visit(self, ctx: FileContext, node: ast.AST, report: Report) -> None:
        if not self._active:
            return
        cls = ctx.enclosing(ast.ClassDef)
        if cls is not None and cls.name == _OWNER:
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
