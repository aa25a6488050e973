"""Port of `nos_tpu/analysis/checkers/wire_literals.py:1` (:1-44). Copied near
verbatim; the imports point at the port, which imports nothing of the JAX
package.

NOS001 — wire-protocol string literals outside constants.py.

The `tpu.nos/...` label/annotation names, `google.com/tpu*` and
`nvidia.com/*` resource names ARE the public protocol between the central
partitioner and the node agents (nos_tpu_torch/constants.py docstring). A literal
spelled inline drifts silently: an early ORIENTATION bug was exactly this class
of defect, and the seed tree shipped two hardcoded `"tpu.nos/v1alpha1"`
apiVersions in cluster/serialize.py. Any such literal must be derived from
`nos_tpu_torch.constants`; constants.py itself is the single allowed definition
site. Docstrings are exempt (prose), f-string literal fragments are not
(`f"nvidia.com/gpu-{p}"` is still a wire literal).
"""

from __future__ import annotations

import ast
import re

from nos_tpu_torch.analysis.core import Checker, FileContext, Report

WIRE_LITERAL_RE = re.compile(r"^(tpu\.nos(/|$)|google\.com/tpu|nvidia\.com/)")


class WireLiteralChecker(Checker):
    name = "wire-literals"
    codes = ("NOS001",)
    description = "wire-protocol literals must come from nos_tpu_torch.constants"

    def visit(self, ctx: FileContext, node: ast.AST, report: Report) -> None:
        if ctx.basename == "constants.py":
            return
        if not (isinstance(node, ast.Constant) and isinstance(node.value, str)):
            return
        if not WIRE_LITERAL_RE.match(node.value):
            return
        if ctx.is_docstring(node):
            return
        report.add(
            ctx.rel,
            node.lineno,
            "NOS001",
            f"wire-protocol literal {node.value!r} outside constants.py; "
            "derive it from nos_tpu_torch.constants",
        )
