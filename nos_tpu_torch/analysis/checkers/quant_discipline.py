"""Port of `nos_tpu/analysis/checkers/quant_discipline.py:1` (:1-161), its
rule A rewritten for PyTorch: torch's spelling of a write, the in-place
tensor methods (`_INPLACE`), takes the place of jax's `.at[...].set/add/
max/...` chains (`_AT_METHODS`, :47). Rule B, the scope and the message
are the reference's.

NOS024 — quantized-KV state touched outside the ops/ write funnel.

The int8 KV tier keeps ONE module honest about its format:
nos_tpu_torch/ops/quantized_kv.py owns every write to the per-block scale
tensors (the scatter funnel's offset-0 reset + scatter-max + requant
dance, in place and capture-safe) and every dequantization multiply (the
attention kernels inline the same arithmetic next door). That is the
NOS011/NOS019 single-mutator discipline applied to a NUMERIC format
instead of host bookkeeping — and it matters for the same reason: a stray
``pool["0"]["k_scale"][b] = s`` or ``lc["k_scale"].index_copy_(0, b, s)``
in engine code silently breaks the monotone-scale/requant-idempotence
invariants, and no conservation counter can see it; only output quality
decays.

Two rules, enforced across runtime/, serving/ and models/ (ops/ is the
funnel and is exempt):

  A. WRITES to quantization state — assignment/deletion/augmented
     assignment whose target resolves through subscripts to a
     ``"k_scale"``/``"v_scale"`` key or a ``_kv_scales`` attribute, AND
     in-place tensor methods (torch's trailing-underscore convention:
     ``index_copy_``, ``index_put_``, ``scatter_``, ``scatter_reduce_``,
     ``copy_``, ``fill_``, ``zero_``, ``add_``/``mul_``/``clamp_``/...)
     called on the same state (torch's "mutation" spelling). Reads stay
     legal everywhere: the model hands scales to the attention ops,
     telemetry sizes the pool, tests inspect freely. Dict LITERALS
     carrying scale keys are reads-with-structure, not writes — the model
     builds its per-layer pool dict (and each layer's scale view) in one
     literal, which is exactly the sanctioned flow.

  B. CALLS to dequantization — any call whose name mentions
     ``dequant``. Dequantization outside ops/ means pool bytes were
     materialized as floats on the host path, which both breaks the
     single-format-authority rule and silently forfeits the bandwidth
     win the tier exists for.
"""

from __future__ import annotations

import ast

from nos_tpu_torch.analysis.core import Checker, FileContext, Report

_SCALE_KEYS = frozenset({"k_scale", "v_scale"})
_SCALE_ATTRS = frozenset({"_kv_scales"})



def _inplace(method: str) -> bool:
    """torch's in-place tensor methods end in one underscore (`copy_`,
    `index_put_`, `scatter_reduce_`, `mul_`); dunders do not count."""
    return method.endswith("_") and not method.startswith("_")


def _quant_root(node: ast.AST):
    """The protected quant-state name an expression chain is rooted at,
    if any: unwraps subscripts/attributes so ``cache["0"]["k_scale"]``,
    ``lc["v_scale"][b]`` and ``engine._kv_scales`` all resolve."""
    while True:
        if isinstance(node, ast.Subscript):
            sl = node.slice
            if isinstance(sl, ast.Constant) and sl.value in _SCALE_KEYS:
                return str(sl.value)
            node = node.value
        elif isinstance(node, ast.Attribute):
            if node.attr in _SCALE_ATTRS:
                return node.attr
            node = node.value
        else:
            return None


class QuantDisciplineChecker(Checker):
    name = "quant-discipline"
    codes = ("NOS024",)
    description = (
        "quantized-KV scale state written, or dequantization called, "
        "outside the ops/ write funnel"
    )

    def __init__(self) -> None:
        self._scope = False

    def begin_file(self, ctx: FileContext) -> None:
        dirs = ctx.segments[:-1]
        self._scope = (
            "runtime" in dirs or "serving" in dirs or "models" in dirs
        ) and "ops" not in dirs

    def _flag(
        self, ctx: FileContext, node: ast.AST, what: str, report: Report
    ) -> None:
        report.add(
            ctx.rel,
            node.lineno,
            "NOS024",
            f"{what} outside nos_tpu_torch/ops/; the int8 KV format (per-block "
            "scale reset/scatter-max/requant and the dequant multiply) "
            "has ONE authority — route it through ops/quantized_kv.py / "
            "ops/paged_attention.py so the bounded-divergence oracle's "
            "assumptions keep holding (docs/quantized-kv.md)",
        )

    def visit(self, ctx: FileContext, node: ast.AST, report: Report) -> None:
        if not self._scope:
            return
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for target in targets:
                parts = (
                    target.elts
                    if isinstance(target, (ast.Tuple, ast.List))
                    else [target]
                )
                for part in parts:
                    root = _quant_root(part)
                    if root is not None:
                        self._flag(
                            ctx,
                            node,
                            f"quantized-KV scale state `{root}` assigned",
                            report,
                        )
        elif isinstance(node, ast.Delete):
            for target in node.targets:
                root = _quant_root(target)
                if root is not None:
                    self._flag(
                        ctx,
                        node,
                        f"quantized-KV scale state `{root}` deleted",
                        report,
                    )
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            fn = node.func
            if "dequant" in fn.attr.lower():
                self._flag(
                    ctx, node, f"dequantization call `.{fn.attr}()`", report
                )
                return
            # `root[b].fill_(s)`, `root.index_copy_(0, b, s)`: an in-place
            # method on the state — torch's write spelling.
            if _inplace(fn.attr):
                root = _quant_root(fn.value)
                if root is not None:
                    self._flag(
                        ctx,
                        node,
                        f"quantized-KV scale state `{root}` written via "
                        f".{fn.attr}()",
                        report,
                    )
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            if "dequant" in node.func.id.lower():
                self._flag(
                    ctx, node, f"dequantization call `{node.func.id}()`", report
                )
