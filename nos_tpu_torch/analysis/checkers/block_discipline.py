"""Port of `nos_tpu/analysis/checkers/block_discipline.py:1` (:1-127). Copied
near verbatim; the imports point at the port, which imports nothing of the
JAX package.

NOS011 — paged-pool bookkeeping mutated outside the BlockManager.

The DecodeServer's pool state — free lists, per-slot block
lists, per-block refcounts, the cached-free LRU, and the content-addressed
prefix index — lives in `runtime/block_manager.py` BlockManager, because the
shared-prefix invariants (a block's refcount equals the number of page
tables mapping it; a block is in exactly one of in-use / free /
cached-free; the index and its inverse agree) only hold if every mutation
funnels through that class. One stray `self._free_blocks.append(...)` or
`mgr._refcount[b] -= 1` in engine code silently double-frees or leaks a
block — the kind of drift that shows up five PRs later as cross-request
KV corruption under load, not as a test failure.

Scope: files under `runtime/`. Any WRITE to the protected pool-state
attributes (attribute/subscript assignment or deletion, augmented
assignment, or a mutating method call like `.append`/`.pop`/`.update`/
`.move_to_end`) outside the `BlockManager` class body is flagged — on
ANY receiver, so reaching through the engine (`self._block_mgr._refcount`)
is caught the same as `self._free_blocks`. Reads stay legal everywhere:
gauges and tests may inspect, only the BlockManager may mutate.
"""

from __future__ import annotations

import ast

from nos_tpu_torch.analysis.core import Checker, FileContext, Report

_PROTECTED = frozenset(
    {
        "_free_blocks",
        "_slot_blocks",
        "_refcount",
        "_refcounts",
        "_cached_free",
        "_prefix_index",
        "_block_key",
        # The spilled device-block state (host-backed, reusable)
        # is pool state like the rest. The HOST tier's own attributes
        # are NOS013's (spill_discipline.py).
        "_spilled",
    }
)

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

_OWNER = "BlockManager"


def _protected_attr(node: ast.AST):
    """The protected attribute name a write target resolves to, if any —
    unwrapping subscript chains so `x._refcount[b]` and
    `self._slot_blocks[i][j]` both resolve to their backing attribute."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and node.attr in _PROTECTED:
        return node.attr
    return None


class BlockDisciplineChecker(Checker):
    name = "block-discipline"
    codes = ("NOS011",)
    description = "paged-pool bookkeeping mutated outside the BlockManager"

    def __init__(self) -> None:
        self._active = False

    def begin_file(self, ctx: FileContext) -> None:
        self._active = "runtime" in ctx.segments[:-1]

    def _flag(self, ctx: FileContext, node: ast.AST, attr: str, how: str, report: Report) -> None:
        report.add(
            ctx.rel,
            node.lineno,
            "NOS011",
            f"pool state `{attr}` {how} outside BlockManager; route the "
            "mutation through a BlockManager method so the refcount/"
            "free-list/index invariants stay enforceable in one place",
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
