"""Port of `nos_tpu/analysis/checkers/cost_discipline.py:1` (:1-194). Copied
near verbatim; the imports point at the port, which imports nothing of the
JAX package.

NOS018 — cost-ledger state mutated outside the CostLedger /
accounting field-name literals outside constants.py.

The fleet utilization & cost-attribution plane
(nos_tpu_torch/serving/accounting.py, docs/telemetry.md "Utilization & cost
accounting") hinges on two disciplines the suite already enforces
elsewhere, applied to the new surface:

  1. **Single-mutator ledger state** (the NOS011/NOS013/NOS017
     argument): the CostLedger's invariants — every charge lands in
     exactly one tenant total and at most one receipt, receipts stay
     inside the bounded ring, the charge vocabulary stays closed over
     `constants.COST_FIELDS` — only hold if every mutation funnels
     through the class. One stray
     ``ledger._cost_tenants[t][f] += x`` in engine code silently
     breaks the conservation law (per-tenant charged slot-seconds ==
     fleet busy slot-seconds) the billing tests pin. Any WRITE to the
     protected attributes (`_cost_tenants`, `_cost_open`,
     `_cost_receipts`) — assignment/deletion, augmented assignment, or
     a mutating method call — outside the `CostLedger` class body is
     flagged, on ANY receiver, across `runtime/` and `serving/`.
     Reads stay legal everywhere (conservation predicates, /debug
     payloads, and tests may inspect).

  2. **Accounting field-name literals outside constants.py** (the
     NOS001/NOS014 argument): the duty-cycle row keys
     (`constants.ACCT_KEY_*`), the waste taxonomy
     (`constants.WASTE_*`), and the CostLedger charge fields
     (`constants.COST_*`) ARE the accounting protocol — journal
     replay, the `/debug/accounting` payload, the
     ``nos_tpu_tenant_cost_*`` gauge names, and the bench
     `chip_accounting` block all key off them. A field spelled inline
     drifts exactly like a mistyped annotation. Scope: the serving
     plane where the protocol lives — any `serving/` directory plus
     `observability.py` (docstrings exempt; `telemetry.py` is out of
     scope because several values deliberately mirror ServingReport
     attribute names there).
"""

from __future__ import annotations

import ast

from nos_tpu_torch import constants
from nos_tpu_torch.analysis.core import Checker, FileContext, Report

#: The accounting wire vocabulary, sourced from constants at import so
#: adding a field there automatically extends the discipline to it.
_FIELD_NAMES = (
    frozenset(constants.COST_FIELDS)
    | frozenset(constants.WASTE_CAUSES)
    | frozenset(
        {
            constants.ACCT_KEY_DISPATCH_S,
            constants.ACCT_KEY_HOST_S,
            constants.ACCT_KEY_TICK_WALL_S,
            constants.ACCT_KEY_IDLE_S,
            constants.ACCT_KEY_REVIVE_S,
            constants.ACCT_KEY_RESTORE_S,
            constants.ACCT_KEY_DUTY,
            constants.ACCT_KEY_WALL_CHIP_S,
            constants.ACCT_KEY_BUSY_CHIP_S,
            constants.ACCT_KEY_OVERHEAD_CHIP_S,
            constants.ACCT_KEY_WASTE_CHIP_S,
            constants.ACCT_KEY_WASTE,
            constants.ACCT_KEY_CHIP_SECONDS,
            constants.ACCT_KEY_CHIP_HOURS,
            constants.ACCT_KEY_TOK_S_PER_CHIP_HOUR,
            constants.ACCT_KEY_WASTE_FRACTION,
        }
    )
)

_PROTECTED = frozenset({"_cost_tenants", "_cost_open", "_cost_receipts"})

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

_OWNER = "CostLedger"

#: Where the field-name literal rule applies beyond serving/ dirs.
_LITERAL_SCOPE_BASENAMES = frozenset({"observability.py"})


def _protected_attr(node: ast.AST):
    """The protected attribute name a write target resolves to, if any —
    unwrapping subscript chains so ``ledger._cost_tenants[t][f]``
    resolves to its backing attribute."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and node.attr in _PROTECTED:
        return node.attr
    return None


class CostDisciplineChecker(Checker):
    name = "cost-discipline"
    codes = ("NOS018",)
    description = (
        "cost-ledger state mutated outside the CostLedger API / accounting "
        "field-name literals outside constants.py"
    )

    def __init__(self) -> None:
        self._write_scope = False
        self._literal_scope = False

    def begin_file(self, ctx: FileContext) -> None:
        dirs = ctx.segments[:-1]
        self._write_scope = "runtime" in dirs or "serving" in dirs
        self._literal_scope = ctx.basename != "constants.py" and (
            "serving" in dirs or ctx.basename in _LITERAL_SCOPE_BASENAMES
        )

    def _flag_write(
        self, ctx: FileContext, node: ast.AST, attr: str, how: str, report: Report
    ) -> None:
        report.add(
            ctx.rel,
            node.lineno,
            "NOS018",
            f"cost-ledger state `{attr}` {how} outside CostLedger; route the "
            "mutation through charge()/open_request()/close_request() so the "
            "conservation law and the receipt bound stay enforceable in one "
            "place",
        )

    def visit(self, ctx: FileContext, node: ast.AST, report: Report) -> None:
        # 1) Accounting field-name literals (serving-plane scope).
        if (
            self._literal_scope
            and isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and node.value in _FIELD_NAMES
            and not ctx.is_docstring(node)
        ):
            report.add(
                ctx.rel,
                node.lineno,
                "NOS018",
                f"accounting field name {node.value!r} spelled inline in the "
                "serving plane; derive it from nos_tpu_torch.constants "
                "(ACCT_KEY_*/WASTE_*/COST_*) so journal replay, "
                "/debug/accounting consumers, and the cost gauge names "
                "cannot drift",
            )
            return
        # 2) Ledger-state writes outside the owning class.
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
                        self._flag_write(ctx, node, attr, "assigned", report)
        elif isinstance(node, ast.Delete):
            for target in node.targets:
                attr = _protected_attr(target)
                if attr is not None:
                    self._flag_write(ctx, node, attr, "deleted", report)
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in _MUTATORS:
                attr = _protected_attr(node.func.value)
                if attr is not None:
                    self._flag_write(
                        ctx, node, attr, f"mutated via .{node.func.attr}()", report
                    )
