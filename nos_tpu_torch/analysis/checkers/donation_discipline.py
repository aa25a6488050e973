"""Port of `nos_tpu/analysis/checkers/donation_discipline.py:1` (:1-285), its
rule rewritten for PyTorch. The port donates no buffer: its programs write
the pool in place on one stream (models/decode.py, runtime/decode_server.py).
The hazard that takes donation's place is a captured graph's static output.
The reference's mechanics stay: consumed names or `self.attr`s (`_arg_key`,
:53), a rebinding in the same statement is sanctioned (`_target_keys`, :65),
the loop back-edge rule (:232), nested function bodies skipped, and the
scope (runtime/ and models/). The code is the reference's.

NOS020 — use-after-donate on the host path: a replayed graph's output read
after a later replay of the same graph.

A CUDA graph writes its outputs into the static buffers its capture
allocated, on every replay. The engine's capture wrapper hands them out:
`_WindowGraph.replay()` "returns the graph's token buffer, which the next
replay rewrites" (runtime/decode_server.py). A value an earlier `replay()`
returned is therefore CONSUMED by the next replay of the same graph: read
after it, without a `.clone()`/copy in between, it holds the new window's
tokens, not the old — the port's counterpart of reading a donated buffer
after the call that consumed it. The discipline that makes it safe: copy
the output out (`_TokRef` copies it to pinned host memory behind an event,
`toks[...].copy_(...)` into a buffer of the caller's) before the next
replay, or rebind the variable from that replay in the same statement.

Tracked conservatively (a lint, not an escape analysis):

  - a replay is `g.replay()` with no arguments on a name or a `self.attr`
    (the graph's identity is that receiver), or a call of a function of
    the same file that returns such a replay's output (`self._window()`);
  - a replay whose result a statement binds straight to a bare name or a
    `self.attr` makes that variable a replay OUTPUT of the graph;
  - a later replay of the same graph CONSUMES every output bound from an
    earlier one — unless its own statement rebinds that variable (the
    sanctioned pattern, tuple targets included), or the variable was
    stored to in between;
  - a later load of a consumed variable in the same function (no
    intervening store) is a finding;
  - a replay inside a loop consumes, on the loop's back edge, an output
    bound before the loop that the loop reads but never rebinds: a
    finding at the replay on its own (iteration two reads the buffer the
    first iteration's replay rewrote).

Attributes of non-self receivers and outputs stored into containers are
deliberately NOT tracked — a name-level analysis cannot see through them
soundly. Nested function bodies are skipped. Scope: files under
`runtime/` and `models/`, where the captured programs live.
"""

from __future__ import annotations

import ast
from typing import List, NamedTuple, Optional, Set, Tuple

from nos_tpu_torch.analysis.callgraph import _dotted_name
from nos_tpu_torch.analysis.core import Checker, FileContext, Report

#: Statement types a replay realistically sits in.
_SIMPLE_STMTS = (ast.Assign, ast.AnnAssign, ast.AugAssign, ast.Expr, ast.Return)

_NESTED = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)

# Key for a trackable value: ("n", name) or ("a", self_attr).
_Key = Tuple[str, str]


def _arg_key(node: ast.AST) -> Optional[_Key]:
    if isinstance(node, ast.Name):
        return ("n", node.id)
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return ("a", node.attr)
    return None


def _target_keys(target: ast.AST) -> Set[_Key]:
    """Keys (re)bound by one assignment target, tuples included."""
    out: Set[_Key] = set()
    if isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            out.update(_target_keys(elt))
    elif isinstance(target, ast.Starred):
        out.update(_target_keys(target.value))
    else:
        key = _arg_key(target)
        if key is not None:
            out.add(key)
    return out


def _graph_replay(call: ast.Call) -> Optional[_Key]:
    """The graph a `g.replay()` / `self._graph.replay()` call replays."""
    fn = call.func
    if (
        isinstance(fn, ast.Attribute)
        and fn.attr == "replay"
        and not call.args
        and not call.keywords
    ):
        return _arg_key(fn.value)
    return None


def _pruned_calls(node: ast.AST):
    """Calls under `node`, never descending into nested function bodies."""
    stack: List[ast.AST] = [node]
    while stack:
        cur = stack.pop()
        stack.extend(
            ch for ch in ast.iter_child_nodes(cur) if not isinstance(ch, _NESTED)
        )
        if isinstance(cur, ast.Call):
            yield cur


class _Replay(NamedTuple):
    """One replay site: the graph, the variables its statement binds to the
    output and those it rebinds, where the statement ends, its loop."""

    graph: Tuple[str, str]
    label: str
    line: int
    end: int
    bound: Set[_Key]
    rebinds: Set[_Key]
    loop: Optional[Tuple[int, int]]
    returns: bool


class DonationDisciplineChecker(Checker):
    name = "donation-discipline"
    codes = ("NOS020",)
    description = (
        "a replayed graph's output must not be read after a later replay of that graph"
    )

    def __init__(self) -> None:
        self._active = False
        #: Functions of this file that return a replay's output, by the key
        #: their calls are spelled with: ("a", method) / ("n", function).
        self._returners: Set[_Key] = set()
        self._checked: Set[ast.AST] = set()

    # -- per-file prescan: functions that hand out a replay's output --------
    def begin_file(self, ctx: FileContext) -> None:
        segs = ctx.segments[:-1]
        self._active = "runtime" in segs or "models" in segs
        self._returners = set()
        self._checked = set()
        if not self._active:
            return
        for node in ctx.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if self._returns_replay(node):
                    self._returners.add(("n", node.name))
            elif isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        if self._returns_replay(item):
                            self._returners.add(("a", item.name))

    @staticmethod
    def _returns_replay(func: ast.AST) -> bool:
        outputs: Set[str] = set()
        returns: List[ast.Return] = []
        stack: List[ast.AST] = list(func.body)
        while stack:
            node = stack.pop()
            if isinstance(node, _NESTED):
                continue
            stack.extend(ast.iter_child_nodes(node))
            if (
                isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)
                and _graph_replay(node.value) is not None
            ):
                outputs.update(
                    t.id for t in node.targets if isinstance(t, ast.Name)
                )
            elif isinstance(node, ast.Return) and node.value is not None:
                returns.append(node)
        for ret in returns:
            v = ret.value
            if isinstance(v, ast.Call) and _graph_replay(v) is not None:
                return True
            if isinstance(v, ast.Name) and v.id in outputs:
                return True
        return False

    def _replayed(self, call: ast.Call) -> Optional[_Key]:
        """The graph identity a call replays, or None."""
        graph = _graph_replay(call)
        if graph is not None:
            return graph
        key = _arg_key(call.func)
        if key is not None and key in self._returners:
            return ("fn", key[1])
        return None

    # -- per-function flow check --------------------------------------------
    def visit(self, ctx: FileContext, node: ast.AST, report: Report) -> None:
        if not self._active:
            return
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return
        if ctx.enclosing(ast.FunctionDef, ast.AsyncFunctionDef) is not None:
            return  # nested defs are analyzed as part of nothing
        if node in self._checked:
            return
        self._checked.add(node)
        self._check_function(ctx, node, report)

    def _check_function(self, ctx: FileContext, func: ast.AST, report: Report) -> None:
        loads: List[Tuple[int, _Key]] = []
        stores: List[Tuple[int, _Key]] = []
        replays: List[_Replay] = []

        def scan(node: ast.AST, loop: Optional[Tuple[int, int]]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, _NESTED):
                    continue
                if isinstance(child, (ast.For, ast.AsyncFor, ast.While)):
                    inner = (child.lineno, child.end_lineno or child.lineno)
                    scan(child, inner)
                    continue
                if isinstance(child, _SIMPLE_STMTS):
                    self._scan_stmt(child, loop, replays)
                if isinstance(child, ast.Name):
                    key = ("n", child.id)
                    if isinstance(child.ctx, ast.Load):
                        loads.append((child.lineno, key))
                    else:
                        stores.append((child.lineno, key))
                elif (
                    isinstance(child, ast.Attribute)
                    and isinstance(child.value, ast.Name)
                    and child.value.id == "self"
                ):
                    key = ("a", child.attr)
                    if isinstance(child.ctx, ast.Load):
                        loads.append((child.lineno, key))
                    else:
                        stores.append((child.lineno, key))
                scan(child, loop)

        scan(func, None)
        for first in replays:
            for key in sorted(first.bound):
                var = key[1] if key[0] == "n" else f"self.{key[1]}"
                for later in replays:
                    if later is first or later.graph != first.graph:
                        continue
                    if self._consumes(first, later, key, stores):
                        reads = sorted(
                            ln for ln, k in loads if k == key and ln > later.end
                        )
                        saved = reads and any(
                            later.end < ln < reads[0] for ln, k in stores if k == key
                        )
                        if reads and not saved:
                            report.add(
                                ctx.rel,
                                reads[0],
                                "NOS020",
                                f"use-after-donate: '{var}' holds the output of "
                                f"'{first.label}' (line {first.line}), which the "
                                f"replay at line {later.line} rewrote, and is read "
                                "here without rebinding; .clone() it before the "
                                "next replay or rebind it from that replay "
                                "(x = g.replay())",
                            )
                            break
                    if self._back_edge(first, later, key, loads, stores):
                        report.add(
                            ctx.rel,
                            later.line,
                            "NOS020",
                            f"use-after-donate: '{var}' holds the output of "
                            f"'{first.label}' (line {first.line}) and is read "
                            "inside a loop that replays the graph again but "
                            "never rebound in the loop — the next iteration "
                            "reads the buffer this replay rewrote; .clone() it "
                            "or rebind the result (x = g.replay()) each iteration",
                        )
                        break

    @staticmethod
    def _consumes(first: _Replay, later: _Replay, key: _Key, stores) -> bool:
        """`later` runs after `first` in line order and rewrites the buffer
        `key` still holds."""
        if later.line <= first.end or key in later.rebinds or later.returns:
            return False
        return not any(first.end < ln < later.line for ln, k in stores if k == key)

    @staticmethod
    def _back_edge(first: _Replay, later: _Replay, key: _Key, loads, stores) -> bool:
        """`later` sits in a loop that starts after `first`, reads `key`
        and never stores it."""
        if later.loop is None or later.returns:
            return False
        lo, hi = later.loop
        if first.end >= lo:
            return False
        if any(lo <= ln <= hi for ln, k in stores if k == key):
            return False
        return any(lo <= ln <= hi for ln, k in loads if k == key)

    def _scan_stmt(self, stmt: ast.AST, loop, replays: List[_Replay]) -> None:
        rebinds: Set[_Key] = set()
        value = None
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                rebinds.update(_target_keys(t))
            value = stmt.value
        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            rebinds.update(_target_keys(stmt.target))
            value = stmt.value if isinstance(stmt, ast.AnnAssign) else None
        for call in _pruned_calls(stmt):
            graph = self._replayed(call)
            if graph is None:
                continue
            bound = rebinds if call is value else set()
            replays.append(
                _Replay(
                    graph,
                    _dotted_name(call.func) or "<replay>",
                    call.lineno,
                    stmt.end_lineno or call.lineno,
                    bound,
                    rebinds,
                    loop,
                    isinstance(stmt, ast.Return),
                )
            )
