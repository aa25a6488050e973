"""Port of `nos_tpu/analysis/checkers/exception_hygiene.py:1` (:1-99). Copied
near verbatim; the imports point at the port, which imports nothing of the
JAX package.

NOS003/NOS004 — exception hygiene in reconcile/serve/lease loops.

Ten modules coordinate through hand-rolled retry loops; a broad
`except Exception:` that neither logs, re-raises, nor forwards the error
object turns every transient wire failure into silent starvation (the seed's
`util/leader.py try_acquire` swallowed ALL backend errors with a bare
`return False` — a dead campaign thread looks identical to a lost election).

NOS004: bare `except:` is banned outright — it also catches KeyboardInterrupt
and SystemExit, wedging shutdown paths.

NOS003: a handler for Exception/BaseException (alone or in a tuple) must show
evidence the error survives: a `raise`, a logging call (`*.exception/warning/
debug/...`), `print`, `traceback.print_exc`, `Future.set_exception`, a
process exit, or any use of the bound `except ... as e` name (returning or
storing the error counts as handling it). Narrow handlers
(`except NotFoundError: pass`) are deliberate control flow and stay legal.
"""

from __future__ import annotations

import ast
from typing import Optional

from nos_tpu_torch.analysis.core import Checker, FileContext, Report

_BROAD = {"Exception", "BaseException"}
_LOG_METHODS = {
    "debug",
    "info",
    "warning",
    "warn",
    "error",
    "exception",
    "critical",
    "log",
    "print_exc",
    "print_exception",
    "set_exception",
    "exit",
    "_exit",
    "abort",
    "fail",
}


def _is_broad(type_node: Optional[ast.expr]) -> bool:
    if type_node is None:
        return True
    if isinstance(type_node, ast.Tuple):
        return any(_is_broad(el) for el in type_node.elts)
    if isinstance(type_node, ast.Name):
        return type_node.id in _BROAD
    if isinstance(type_node, ast.Attribute):
        return type_node.attr in _BROAD
    return False


def _handles_error(handler: ast.ExceptHandler) -> bool:
    bound = handler.name
    for node in ast.walk(ast.Module(body=handler.body, type_ignores=[])):
        if isinstance(node, ast.Raise):
            return True
        if bound and isinstance(node, ast.Name) and node.id == bound:
            return True
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Name) and fn.id == "print":
                return True
            if isinstance(fn, ast.Attribute) and fn.attr in _LOG_METHODS:
                return True
    return False


class ExceptionHygieneChecker(Checker):
    name = "exception-hygiene"
    codes = ("NOS003", "NOS004")
    description = "broad exception handlers must log, re-raise, or forward"

    def visit(self, ctx: FileContext, node: ast.AST, report: Report) -> None:
        if not isinstance(node, ast.ExceptHandler):
            return
        if node.type is None:
            report.add(
                ctx.rel,
                node.lineno,
                "NOS004",
                "bare 'except:' (catches KeyboardInterrupt/SystemExit); "
                "name the exception types",
            )
            return
        if _is_broad(node.type) and not _handles_error(node):
            report.add(
                ctx.rel,
                node.lineno,
                "NOS003",
                "broad exception handler swallows the error silently; "
                "log it, re-raise, or use the bound exception",
            )
