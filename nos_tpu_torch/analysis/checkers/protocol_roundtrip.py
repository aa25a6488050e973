"""Port of `nos_tpu/analysis/checkers/protocol_roundtrip.py:1` (:1-241). Copied
near verbatim; the imports point at the port, which imports nothing of the
JAX package.

NOS002 — every domain-owned protocol constant needs a writer AND a reader.

The `ANNOTATION_*`/`LABEL_*` names in constants.py are the RPC schema between
planner and node agents. A key that is only ever written is dead weight on
every object; a key that is only ever read is a protocol hole — the reader
waits forever on an annotation nobody stamps (the exact shape of the seed's
orientation drift). This checker cross-references the whole analyzed tree:

  definition  — `NAME = "literal"` / f-string in a `constants.py` module that
                defines `DOMAIN`; only constants whose VALUE starts with the
                domain prefix are checked (GKE/GFD discovery labels such as
                `cloud.google.com/...` are written by external systems, so
                the round-trip requirement does not apply to them);
  writer      — dict-literal key, subscript store/del, `.setdefault(...)`,
                `.pop(...)`, f-string key construction;
  reader      — `.get(...)`, `.pop(...)`, subscript load, `in`/`==`
                comparison, `.startswith/match/...`, plus uses of derived
                constants (e.g. a `*_REGEX` compiled from a prefix constant
                reads on behalf of that prefix);
  unknown     — an argument to an arbitrary helper counts as both (the
                checker refuses to guess what the helper does).

A constant with no writer or no reader anywhere in the analyzed tree is
reported at its definition line. Workload-declared keys written only by
client pods (outside nos_tpu_torch/) get a rationale-annotated baseline entry.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Optional, Set, Tuple

from nos_tpu_torch.analysis.core import Checker, FileContext, Report

_PROTOCOL_NAME = re.compile(r"^(ANNOTATION|LABEL)_[A-Z0-9_]+$")
_READER_METHODS = {
    "get",
    "startswith",
    "endswith",
    "removeprefix",
    "removesuffix",
    "match",
    "fullmatch",
    "search",
    "index",
    "find",
}
_WRITER_METHODS = {"setdefault"}
_BOTH_METHODS = {"pop"}


class ProtocolRoundTripChecker(Checker):
    name = "protocol-roundtrip"
    codes = ("NOS002",)
    cross_file = True  # finish() correlates sites across the whole tree
    description = "ANNOTATION_*/LABEL_* constants need both a writer and a reader"

    def __init__(self) -> None:
        # name -> (rel, line, resolved value or None)
        self.defs: Dict[str, Tuple[str, int, Optional[str]]] = {}
        self.domain: Optional[str] = None
        # derived constant name -> protocol names referenced in its definition
        self.derived: Dict[str, Set[str]] = {}
        self.writers: Dict[str, int] = {}
        self.readers: Dict[str, int] = {}
        self._module_aliases: Set[str] = set()
        self._direct_imports: Set[str] = set()
        self._in_constants = False
        self._env: Dict[str, str] = {}

    # -- per-file setup ------------------------------------------------------
    def begin_file(self, ctx: FileContext) -> None:
        self._in_constants = ctx.basename == "constants.py"
        # Pre-scan imports so references can be attributed regardless of
        # where in the file they appear (still one parse per file).
        self._module_aliases = set()
        self._direct_imports = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name.split(".")[-1] == "constants":
                        self._module_aliases.add(a.asname or a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    if a.name == "constants":
                        self._module_aliases.add(a.asname or "constants")
                    elif node.module.endswith("constants") and _PROTOCOL_NAME.match(a.name):
                        self._direct_imports.add(a.asname or a.name)

    # -- visit ---------------------------------------------------------------
    def visit(self, ctx: FileContext, node: ast.AST, report: Report) -> None:
        if self._in_constants:
            self._visit_constants(ctx, node)
            return
        name = self._protocol_ref(node)
        if name is None:
            return
        kinds = self._classify(ctx, node)
        if "w" in kinds:
            self.writers[name] = self.writers.get(name, 0) + 1
        if "r" in kinds:
            self.readers[name] = self.readers.get(name, 0) + 1

    def _visit_constants(self, ctx: FileContext, node: ast.AST) -> None:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            return
        target = node.targets[0]
        if not isinstance(target, ast.Name):
            return
        value = self._const_str(node.value)
        if value is not None:
            self._env[target.id] = value
        if target.id == "DOMAIN" and value is not None:
            self.domain = value
        if _PROTOCOL_NAME.match(target.id):
            self.defs[target.id] = (ctx.rel, node.lineno, value)
        # Any constant whose definition references protocol names is a
        # derived constant: its downstream uses read on their behalf.
        refs = {
            n.id
            for n in ast.walk(node.value)
            if isinstance(n, ast.Name) and _PROTOCOL_NAME.match(n.id)
        }
        if refs and value is None:
            self.derived[target.id] = refs

    def _const_str(self, node: ast.expr) -> Optional[str]:
        """Resolve a constant string expression (plain literal, f-string over
        known names, or +-concatenation); None when not statically a str."""
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        if isinstance(node, ast.Name):
            return self._env.get(node.id)
        if isinstance(node, ast.JoinedStr):
            parts = []
            for v in node.values:
                if isinstance(v, ast.Constant) and isinstance(v.value, str):
                    parts.append(v.value)
                elif isinstance(v, ast.FormattedValue):
                    inner = self._const_str(v.value)
                    if inner is None:
                        return None
                    parts.append(inner)
                else:
                    return None
            return "".join(parts)
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            left = self._const_str(node.left)
            right = self._const_str(node.right)
            if left is not None and right is not None:
                return left + right
        return None

    # -- reference extraction & classification -------------------------------
    def _protocol_ref(self, node: ast.AST) -> Optional[str]:
        """Protocol-constant (or derived-constant) name referenced by `node`."""
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
            if node.value.id in self._module_aliases:
                if _PROTOCOL_NAME.match(node.attr) or node.attr in self.derived:
                    return node.attr
        elif isinstance(node, ast.Name) and node.id in self._direct_imports:
            return node.id
        return None

    def _classify(self, ctx: FileContext, ref: ast.AST) -> str:
        """'w', 'r', or 'wr' for the reference `ref`, whose PARENTS are
        ctx.stack. Walk outward to the nearest construct that reveals
        intent."""
        stack = ctx.stack
        for i in range(len(stack) - 1, -1, -1):
            node = stack[i]
            child = stack[i + 1] if i + 1 < len(stack) else ref
            if isinstance(node, (ast.FormattedValue, ast.JoinedStr)):
                return "w"  # key construction (SpecAnnotation.key style)
            if isinstance(node, ast.Dict):
                if child is not None and child in node.keys:
                    return "w"
                # nested deeper, keep climbing via the generic fallthrough
            if isinstance(node, ast.Subscript):
                if isinstance(node.ctx, (ast.Store, ast.Del)):
                    return "w"
                return "r"
            if isinstance(node, ast.Compare):
                if any(isinstance(op, (ast.In, ast.NotIn, ast.Eq, ast.NotEq)) for op in node.ops):
                    return "r"
            if isinstance(node, ast.Call):
                # Only classify if the reference sits in the ARGUMENTS; a
                # reference in node.func (e.g. REGEX.match) keeps climbing.
                in_args = child is not None and (
                    child in node.args or any(child is kw.value for kw in node.keywords)
                )
                if child is node.func or (
                    isinstance(node.func, ast.Attribute) and child is node.func
                ):
                    continue
                if in_args:
                    fn = node.func
                    if isinstance(fn, ast.Attribute):
                        if fn.attr in _READER_METHODS:
                            return "r"
                        if fn.attr in _WRITER_METHODS:
                            return "w"
                        if fn.attr in _BOTH_METHODS:
                            return "wr"
                    return "wr"  # unknown helper: refuse to guess
            if isinstance(node, (ast.stmt, ast.Module)):
                break
        return "wr"

    # -- cross-file verdicts -------------------------------------------------
    def finish(self, report: Report) -> None:
        if not self.defs or self.domain is None:
            return
        prefix = self.domain + "/"
        # Reads of a derived constant count as reads of its bases (a regex
        # compiled from ANNOTATION_SPEC_PREFIX parses those keys).
        derived_reads: Dict[str, int] = {}
        for dname, bases in self.derived.items():
            uses = self.readers.get(dname, 0) + self.writers.get(dname, 0)
            for b in bases:
                derived_reads[b] = derived_reads.get(b, 0) + uses
        for name, (rel, line, value) in sorted(self.defs.items()):
            if value is None or not value.startswith(prefix):
                continue  # externally-owned (GKE/GFD) or non-literal: exempt
            writes = self.writers.get(name, 0)
            reads = self.readers.get(name, 0) + derived_reads.get(name, 0)
            if writes and reads:
                continue
            if not writes and not reads:
                missing = "no writer and no reader (dead protocol key)"
            elif not writes:
                missing = "no writer (readers wait on a key nobody stamps)"
            else:
                missing = "no reader (writers stamp a key nobody consumes)"
            report.add(
                rel,
                line,
                "NOS002",
                f"protocol constant {name} has {missing} in the analyzed tree",
            )
