"""Port of `nos_tpu/analysis/checkers/store_discipline.py:1` (:1-126). Copied
near verbatim; the imports point at the port, which imports nothing of the
JAX package.

NOS019 — fleet KV store state mutated outside the FleetKVStore body.

The fleet-scope KV cold tier (nos_tpu_torch/serving/kv_store.py,
docs/kv-store.md) is the suite's first piece of state SHARED BY EVERY
REPLICA: N engine threads, the supervisor's failover thread, and the
control plane's prewarm calls all interleave against one store. Its
invariants — the byte gauge equals the sum of resident payload sizes,
pin counts cover only resident entries, pinned entries survive LRU
retirement, capacity is exceeded only by pins — hold because every
mutation of the backing state (`_store`, `_store_bytes`, `_pins`)
happens inside FleetKVStore methods, under the store lock. That is the
NOS011 (pool) / NOS013 (spill tier) / NOS018 (cost ledger)
single-mutator argument, promoted to fleet scope, where it matters
MORE: a stray ``store._store[key] = payload`` in engine code is not
just a broken gauge, it is an unlocked write racing every replica in
the fleet.

Any WRITE to the protected attributes — assignment/deletion, augmented
assignment, or a mutating method call (`pop`, `clear`,
`move_to_end`, ...) — outside the `FleetKVStore` class body is flagged,
on ANY receiver, across `runtime/` and `serving/`. Reads stay legal
everywhere: the conservation predicate, telemetry gauges, /debug
payloads, and tests may inspect freely (peeking takes the lock inside
the accessor; only mutation must funnel)."""

from __future__ import annotations

import ast

from nos_tpu_torch.analysis.core import Checker, FileContext, Report

_PROTECTED = frozenset({"_store", "_store_bytes", "_pins"})

_MUTATORS = frozenset(
    {
        "append",
        "appendleft",
        "extend",
        "insert",
        "remove",
        "pop",
        "popleft",
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

_OWNER = "FleetKVStore"


def _protected_attr(node: ast.AST):
    """The protected attribute name a write target resolves to, if any —
    unwrapping subscript chains so ``store._store[key]`` and
    ``tier._fleet._pins[key]`` resolve to their backing attribute."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and node.attr in _PROTECTED:
        return node.attr
    return None


class StoreDisciplineChecker(Checker):
    name = "store-discipline"
    codes = ("NOS019",)
    description = (
        "fleet KV store state (_store/_store_bytes/_pins) mutated outside "
        "the FleetKVStore API"
    )

    def __init__(self) -> None:
        self._write_scope = False

    def begin_file(self, ctx: FileContext) -> None:
        dirs = ctx.segments[:-1]
        self._write_scope = "runtime" in dirs or "serving" in dirs

    def _flag(
        self, ctx: FileContext, node: ast.AST, attr: str, how: str, report: Report
    ) -> None:
        report.add(
            ctx.rel,
            node.lineno,
            "NOS019",
            f"fleet KV store state `{attr}` {how} outside FleetKVStore; "
            "route the mutation through put()/take_pinned()/unpin()/"
            "discard()/reset() so the byte-conservation and pin laws stay "
            "lock-guarded in one place — this state is shared by every "
            "replica in the fleet",
        )

    def visit(self, ctx: FileContext, node: ast.AST, report: Report) -> None:
        if not self._write_scope:
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
